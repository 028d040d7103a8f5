"""The port's mesh with a model axis (tensor parallelism: ``parallel/
tensor.py``, ``parallel/sharding.py``) on gloo ranks on the CPU, each a
process of its own (``torch_mesh_workers``), fp32 at toy geometry, on 1x2
and 2x2 meshes, held against the port's single process and the JAX
package's 4x2 GSPMD mesh on the 8 virtual devices of ``tests/conftest.py``:

* the TP forward: the toy ``hybrid-nb`` encoder (embed 32, 2 heads, one a
  rank) within atol 1e-4 of one process and of JAX's 4x2 forward (the case
  of ``tests/test_parallel.py:120-139``), and a fusion network over
  ResNet-backed encoders (the backbone's wide convs and the cross-attention
  sharded);
* TP train steps with dropout on (the fusion network at dropout 0.2 over
  three batches, the tail of 2 included; the ``hybrid-nb`` encoder, whose
  attention-weight and ``fc1`` dropouts run on shards): the loss within rel
  1e-3 of one process, the gradient norms within rel 1e-4, the parameters
  and statistics within ``test_torch_mesh.py``'s DP bound (atol 1e-4), the
  gradients of the replicated parameters bit-equal across each model group;
* the adapter's necks at Cout 128 (a 64-channel shard a rank): kernel 2's
  eval route on the shard and the train route's gradients;
* ``test_fusion_model(mesh=)`` with and without ``mc_chunk``: equal to the
  plain run (probs rtol 1e-4 / atol 1e-6, ``tests/test_spmd_loop.py:165-
  210``; the AUC, whose ranks are rounding at random weights, as the
  run's own report), with dropout 0.2 on 1x2 (one data rank: the caller's masks) and
  dropout 0 on 2x2 (each data rank draws its own), and to JAX's 4x2
  ``test_fusion_model`` (``int8=True``: ``test_torch_tp_int8.py``);
* the fold step over 2x2 (each data rank's folds, replicated over its model
  group) bit-equal to the unsharded step and its losses within rel 1e-5 of
  JAX's 4x2 fold step (``tests/test_multifold.py:215-240``);
  ``fit_single_multifold`` over 2x2 bit-equal to the single-process loop.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from test_torch_helpers import (assert_close, fusion_stack, hybrid_cfg, jax_encoder,
                                port_config, port_encoder, tiny_cfg)
from test_torch_mesh import fusion_batch, volumes

from dmf_tpu import parallel as jparallel
from dmf_tpu import train as jtrain
from dmf_tpu.losses import get_classification_loss_fn as j_clf, get_mask_loss_fn as j_mask
from dmf_tpu.pipeline import run_fusion as jrun_fusion
from dmf_tpu_torch.evals.metrics import classification_report
from dmf_tpu_torch.models.adapter import BackboneAdapter
from dmf_tpu_torch.train.fusion import FusionNetwork
from dmf_tpu_torch.train.optim import FusionOptController, SingleModelOptController

B = 8
MESHES = {"1x2": 2, "2x2": 4}  # name -> world; the model axis is 2
STEP_LOSS_RTOL, NORM_RTOL, DP_ATOL = 1e-3, 1e-4, 1e-4  # test_torch_mesh.py
K = 4  # folds over the 2x2 mesh's two data ranks


def jax_state(jvars):
    params = {m: v["params"] for m, v in zip(("dwi", "dce", "fusion"), jvars)}
    stats = {m: v["batch_stats"] for m, v in zip(("dwi", "dce", "fusion"), jvars)}
    return jtrain.TrainState(params=params, batch_stats=stats,
                             opt_state=jtrain.adamw_init(params), step=jnp.zeros((), jnp.int32))


def hybrid_batch(seed, n):
    r = np.random.RandomState(seed + 70)
    return {"imgs": volumes(seed, n, 14), "masks": (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32),
            "labels": (np.arange(n) % 4).astype(np.int64), "aux_w": 1.0}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The models and inputs of every job, with their JAX twins."""
    out = {"workdir": str(tmp_path_factory.mktemp("folds"))}
    # the hybrid-nb encoder (tests/test_parallel.py:120-139, at the port's
    # toy geometry); dropout on for its train steps
    hcfg = hybrid_cfg(dropout=0.1)
    x = volumes(3, B, 14)
    jm, v = jax_encoder(hcfg.dwi_model, 14, x, seed=5)
    out["hybrid"] = (hcfg, jm, v, port_encoder(hcfg.dwi_model, 14, v)[0], x)
    # a fusion network over ResNet-backed encoders, dropout 0.2
    fcfg = tiny_cfg(dropout=0.2, use_backbone=True)
    b = fusion_batch(0, 2)
    _, _, pmods = fusion_stack(fcfg, b["dwi"], b["dce"], seeds=(31, 32, 33))
    out["fusion"] = (fcfg, FusionNetwork(*pmods))
    # the test pass: fusion models without a backbone, dropout 0 and 0.2
    r = np.random.RandomState(2)
    test = {"dwi": volumes(40, 10, 14), "dce": volumes(41, 10, 6),
            "labels": r.randint(0, 4, 10).astype(np.int64)}
    serve = {}
    for p in (0.0, 0.2):
        cfg = tiny_cfg(dropout=p, use_backbone=False, mc_passes=3).replace(batch_size=4)
        serve[p] = (cfg,) + fusion_stack(cfg, test["dwi"][:2], test["dce"][:2],
                                         seeds=(41, 42, 43))
    out["serve"] = (serve, test)
    # the adapter's necks at Cout 128 on small maps
    g = torch.Generator().manual_seed(6)
    adapter = BackboneAdapter((24, 40, 16, 8), ((0,), (1,), (2, 3)), (128, 128, 128))
    with torch.no_grad():
        for name, t in adapter.named_parameters():
            t.copy_(0.1 * torch.randn(t.shape, generator=g) + (1.0 if "4.weight" in name
                                                                or "1.weight" in name else 0.0))
        for name, t in adapter.named_buffers():
            if "running_var" in name:
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif "running_mean" in name:
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    feats = [torch.randn(2, c, 8, 8, generator=g).numpy() for c in (24, 40, 16, 8)]
    out["neck"] = (adapter, feats)
    # K folds of the DWI encoder without a backbone, dropout 0
    dcfg = tiny_cfg(dropout=0.0, use_backbone=False).replace(batch_size=B)
    fold_vars = [jax_encoder(dcfg.dwi_model, 14, x, seed=20 + i)[1] for i in range(K)]
    out["folds"] = (dcfg, jax_encoder(dcfg.dwi_model, 14, x, seed=20)[0], fold_vars,
                    [port_encoder(dcfg.dwi_model, 14, fv)[0] for fv in fold_vars],
                    [dict(hybrid_batch(50 + i, B), aux_w=1.0) for i in range(K)])
    return out


def jobs(case, world):
    """The jobs of one spawn, each on models of its own (a job steps or
    shards them in place)."""
    case = copy.deepcopy(case)
    hcfg, _, _, enc, x = case["hybrid"]
    fcfg, net = case["fusion"]
    pcfg = port_config(fcfg).replace(batch_size=B)
    ctl = FusionOptController(pcfg)
    ctl.on_epoch_start(3)  # every group trains
    hp_cfg = port_config(hcfg).replace(batch_size=B)
    serve, test = case["serve"]
    p = 0.2 if world == 2 else 0.0
    dcfg, _, _, folds, fold_batches = case["folds"]
    b = fusion_batch(5, 2)
    out = [
        ("tp_forward", dict(encoder=enc, x=x, net=net, dwi=b["dwi"], dce=b["dce"])),
        ("tp_steps", dict(kind="fusion", cfg=pcfg, model=copy.deepcopy(net),
                          batches=[fusion_batch(i, n) for i, n in enumerate((B, B, 2))],
                          hp=ctl.hyperparams(), train_labels=np.arange(18) % 4)),
        ("tp_steps", dict(kind="single", cfg=hp_cfg, model=copy.deepcopy(enc),
                          batches=[hybrid_batch(i, B) for i in range(2)],
                          hp=SingleModelOptController(hp_cfg, "dwi").hyperparams(),
                          train_labels=np.arange(B) % 4)),
        ("tp_test_fusion", dict(cfg=port_config(serve[p][0]), models=serve[p][3],
                                test_data=test)),
        ("tp_neck", dict(adapter=case["neck"][0], feats=case["neck"][1])),
    ]
    if world == 4:
        dpcfg = port_config(dcfg)
        out.append(("multifold", dict(cfg=dpcfg, models=folds, batches=fold_batches,
                                      hp=SingleModelOptController(dpcfg, "dwi").hyperparams(),
                                      train_labels=fold_batches[0]["labels"])))
        r = np.random.RandomState(13)
        out.append(("multifold_fit", dict(
            cfg=dpcfg.replace(batch_size=4), workdir=case["workdir"],
            models=copy.deepcopy(folds[:2]),
            folds=[tuple({"imgs": volumes(40 + 2 * i + j, n, 14),
                          "masks": (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32),
                          "labels": (np.arange(n) % 4).astype(np.int64)}
                         for j, n in enumerate((10, 4))) for i in range(2)])))
    return out


NAMES = ("forward", "fusion_steps", "hybrid_steps", "test_fusion", "neck", "multifold",
         "multifold_fit")


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    """Each mesh's ranks (one spawn a mesh) and the single-process runs."""
    def key(name, world):  # the meshes serve different models
        return (name, world) if name == "test_fusion" else name

    singles = {}
    for world in MESHES.values():
        for name, (job, kw) in zip(NAMES, jobs(case, world)):
            if key(name, world) not in singles:
                singles[key(name, world)] = W.JOBS[job](None, **copy.deepcopy(kw))
    ranks = {}
    for mesh, world in MESHES.items():
        out = W.spawn(tmp_path_factory.mktemp(f"tp{world}"), world, "several", n_model=2,
                      jobs=jobs(case, world))
        ranks[mesh] = [dict(zip(NAMES, r)) for r in out]
    return (lambda name, world: singles[key(name, world)]), ranks


# ---------------------------------------------------------------- the forward
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_forward_equals_single_process(runs, mesh):
    single, ranks = runs
    ref = single("forward", MESHES[mesh])
    for r in ranks[mesh]:
        got = r["forward"]
        for k in ("encoder", "fusion", "attn"):
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-4,
                                       err_msg=k)
        # the backbones' wide convs and the cross-attention hold half their rows
        assert len(got["shapes"]) > 20
        assert got["shapes"]["fusion.cross_attn_block.cross_attn.in_proj_weight"] == (24, 16)
        assert got["shapes"]["dwi.backbone.layer4.0.conv3.weight"][0] == 1024


def test_tp_forward_matches_jax_4x2(case, runs):
    """The hybrid encoder's logits against JAX's GSPMD forward on
    ``make_mesh(4, 2)`` with ``shard_state``'s sharded variables."""
    hcfg, jm, v, _, x = case["hybrid"]
    state = jtrain.TrainState.create(jax.tree.map(jnp.asarray, v))
    mesh = jparallel.make_mesh(4, 2)
    sharded = jparallel.shard_state(state, mesh)
    xb = jax.device_put(jnp.asarray(x), jparallel.batch_sharding(mesh))
    logits = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False)[0])(sharded.variables, xb)
    for rs in runs[1].values():
        for r in rs:
            np.testing.assert_allclose(r["forward"]["encoder"].numpy(), np.asarray(logits),
                                       rtol=0, atol=1e-4)


# ---------------------------------------------------------------- train steps
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["fusion", "hybrid"])
def test_tp_train_steps_equal_single_process(runs, mesh, kind):
    single, ranks = runs
    ref = single(f"{kind}_steps", MESHES[mesh])
    assert ranks[mesh][0][f"{kind}_steps"]["sharded"]
    for step, m in enumerate(ref["metrics"]):
        for r in ranks[mesh]:
            got = r[f"{kind}_steps"]["metrics"][step]
            assert got.keys() == m.keys()
            rel = abs(got["loss"] - m["loss"]) / max(abs(m["loss"]), 1e-12)
            assert rel <= STEP_LOSS_RTOL, (step, got["loss"], m["loss"])
            for k in [k for k in m if "grad_norm" in k]:
                np.testing.assert_allclose(got[k], m[k], rtol=NORM_RTOL, err_msg=(step, k))
            assert got["grad_nonfinite"] == 0
    for k, t in ref["state"].items():
        for r in ranks[mesh]:
            np.testing.assert_allclose(r[f"{kind}_steps"]["state"][k].float().numpy(),
                                       t.float().numpy(), rtol=0, atol=DP_ATOL, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_replicated_gradients_bit_equal_over_the_model_group(runs, mesh):
    """Global rank ``d * 2 + m`` is data rank ``d``, model rank ``m``: both
    model ranks of a data rank hand AdamW the same bits for every
    replicated parameter, at every step."""
    ranks = runs[1][mesh]
    for kind in ("fusion", "hybrid"):
        for d in range(len(ranks) // 2):
            a, b = (ranks[2 * d + m][f"{kind}_steps"]["digests"] for m in (0, 1))
            assert len(a) == len(b) > 0
            for sa, sb in zip(a, b):
                assert sa.keys() == sb.keys() and len(sa) > 10
                assert sa == sb, [k for k in sa if sa[k] != sb[k]]


# ---------------------------------------------------------------- the necks
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_necks_run_kernel_2_route_on_their_shard(runs, mesh):
    single, ranks = runs
    ref = single("neck", MESHES[mesh])
    for r in ranks[mesh]:
        got = r["neck"]
        # every neck conv (Cout 128), none of the BatchNorms or biases
        assert got["sharded"] == sorted(f"necks.f{i}.{j}.weight" for i in (1, 2, 3)
                                        for j in (0, 3))
        for key in ("eval", "train", "input_grads"):
            for a, b in zip(got[key], ref[key]):
                assert_close(a, b.numpy(), what=key)
        for k, g in ref["grads"].items():
            assert_close(got["grads"][k], g.numpy(), what=k)


# ---------------------------------------------------------------- the test pass
@pytest.mark.parametrize("mesh", MESHES)
def test_test_fusion_model_over_the_model_axis(runs, mesh):
    single, ranks = runs
    ref = single("test_fusion", MESHES[mesh])
    for r in ranks[mesh]:
        got = r["test_fusion"]
        for chunk in (None, 2):
            a, b = got[chunk], ref[chunk]
            np.testing.assert_allclose(a["probs"], b["probs"], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(a["std"], b["std"], rtol=1e-4, atol=1e-6)
            np.testing.assert_array_equal(a["labels"], b["labels"])
            np.testing.assert_allclose(a["modality_attention"], b["modality_attention"],
                                       rtol=1e-4, atol=1e-6)
            # random weights leave the samples' probabilities within ~1e-7 of
            # each other, so the AUC's ranks are rounding: it is held as the
            # report on the run's own probabilities (test_torch_run_fusion.py)
            report = classification_report(a["probs"], a["labels"], 4, "test_")
            assert a["metrics"]["test_roc_auc"] == report["test_roc_auc"]
            for k, v in b["metrics"].items():
                if k not in ("test_time_sec", "test_roc_auc"):
                    np.testing.assert_allclose(a["metrics"][k], v, rtol=1e-4, atol=1e-6,
                                               err_msg=k)


def test_test_fusion_model_matches_jax_4x2(case, runs):
    """The 2x2 run (dropout 0) against JAX's ``test_fusion_model`` on
    ``make_mesh(4, 2)``, the same weights."""
    serve, test = case["serve"]
    cfg, jmods, jvars, _ = serve[0.0]
    theirs = jrun_fusion.test_fusion_model(cfg, *jmods, jax_state(jvars), test, seed=0,
                                           mesh=jparallel.make_mesh(4, 2))
    for r in runs[1]["2x2"]:
        got = r["test_fusion"][None]
        assert_close(got["probs"], theirs["probs"], what="probs")
        assert_close(got["modality_attention"], theirs["modality_attention"], what="attention")


# ---------------------------------------------------------------- the fold axis
def test_fold_step_over_2x2(case, runs):
    """Data rank d steps folds 2d, 2d+1 on both its model ranks alike
    (replicated over the model axis): bit-equal to the unsharded step, the
    losses against JAX's vmapped fold step under ``shard_map`` on
    ``make_mesh(4, 2)``."""
    single, ranks = runs
    ref = single("multifold", 4)
    dcfg, jm, fold_vars, folds, fold_batches = case["folds"]
    losses = np.full(K, np.nan)
    for g, r in enumerate(ranks["2x2"]):
        got = r["multifold"]
        assert got["owned"] == [2 * (g // 2), 2 * (g // 2) + 1]
        for i in got["owned"]:
            for k, t in ref["states"][i].items():
                assert torch.equal(got["states"][i][k], t), (i, k)
            assert torch.equal(got["metrics"]["loss"][i], ref["metrics"]["loss"][i])
            losses[i] = float(got["metrics"]["loss"][i])
    states = [jtrain.TrainState.create(jax.tree.map(jnp.asarray, v)) for v in fold_vars]
    spec = jtrain.build_group_spec(states[0].params, False, True)
    labels = fold_batches[0]["labels"]
    raw = jtrain.make_single_train_step(dcfg, "dwi", jm, j_clf(dcfg, labels, "dwi"),
                                        j_mask(dcfg, "dwi"), spec, jit_compile=False)
    jb = [{"imgs": jnp.asarray(b["imgs"]), "masks": jnp.asarray(b["masks"]),
           "labels": jnp.asarray(b["labels"], jnp.int32), "aux_w": jnp.asarray(1.0)}
          for b in fold_batches]
    hp = jtrain.SingleModelOptController(dcfg, "dwi").hyperparams()
    _, m = jparallel.make_multifold_step(raw, donate=False, mesh=jparallel.make_mesh(4, 2))(
        jparallel.stack_fold_states(states), jparallel.stack_fold_batches(jb),
        jnp.stack([jax.random.PRNGKey(7 + i) for i in range(K)]), hp)
    np.testing.assert_allclose(losses, np.asarray(m["loss"]), rtol=1e-5)


def test_fit_single_multifold_over_2x2(runs):
    """2 folds over the 2x2 mesh's 2 data ranks, each driven by model rank 0
    of its data rank (10 train volumes at B=4: a short tail), then spread
    over both axes: every rank returns both folds' histories, final and
    best states, bit-equal to the single-process lockstep run."""
    single, ranks = runs
    ref = single("multifold_fit", 4)
    for r in ranks["2x2"]:
        got = r["multifold_fit"]
        assert len(got) == len(ref) == 2
        for a, b in zip(got, ref):
            assert a["history"] == b["history"]
            for key in ("state", "best"):
                assert (a[key] is None) == (b[key] is None)
                for k, t in (b[key] or {}).items():
                    assert torch.equal(a[key][k], t), (key, k)
