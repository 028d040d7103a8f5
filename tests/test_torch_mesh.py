"""The port's data mesh (``parallel/mesh.py``, ``parallel/sharding.py``) on
gloo ranks on the CPU, each a process of its own (``torch_mesh_workers``),
fp32 at toy geometry (32^2, channels (8, 16, 32), no backbone), held against
the port's single-process runs and the JAX package's mesh on the 8 virtual
devices of ``tests/conftest.py``:

* ``mesh_from_config``, the row shares and the CLI's mesh errors (a model
  axis forms where the ranks are: ``test_torch_tp*.py``);
* the data-parallel fusion step (``make_spmd_step``) at 2 and 4 ranks, ResLite
  dropout 0.2, batches of 8, 8 and a tail of 2 (shares 1, 1, 0, 0 at 4
  ranks): the global batch's step, the pair mimic across ranks and 0 on the
  tail, BatchNorm's running statistics included, against the single-process
  steps on the same batches (JAX's DP bounds, ``tests/test_parallel.py``:
  loss 1e-4, parameters and statistics atol 1e-4) and replicated alike on
  every rank;
* the DWI encoder's DP step at 2 ranks against JAX's ``make_spmd_step`` on
  ``make_mesh(8, 1)`` on the same weights, dropout 0 (the same bounds);
* the fusion predictor with ``mesh=`` at 2 ranks against the single-process
  one: ``tta`` (a ragged batch of 3 included) and dropout-free ``tta_mc`` to
  fp32 rtol 1e-5, ``tta_mc`` with dropout 0.2 in its ensemble statistics, the
  int8 forward through ``fwd_override``; ``tta`` against JAX's
  ``make_fusion_predictor(mesh=make_mesh(4, 1))``;
* ``make_multifold_step(mesh=)``, 4 folds over 2 ranks: each rank's folds
  bit-equal to the unsharded step, the others untouched, and the losses to
  JAX's vmapped fold step at rel 1e-3; ``fit_single_multifold(mesh=)``, 2
  folds over 2 ranks, bit-equal to the single-process loop on every rank.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from test_torch_helpers import (assert_close, fusion_stack, jax_encoder, port_config,
                                port_encoder, resnet_layers, tiny_cfg)

from dmf_tpu import parallel as jparallel
from dmf_tpu import train as jtrain
from dmf_tpu.evals.predict import make_fusion_predictor as j_fusion_predictor
from dmf_tpu.losses import get_classification_loss_fn as j_clf, get_mask_loss_fn as j_mask
from dmf_tpu.models.ref_ckpt import export_reference_encoder
from dmf_tpu_torch import cli
from dmf_tpu_torch.models.weights import DROPPED_KEY_PATTERNS, canonical_key
from dmf_tpu_torch.parallel import auto_mesh_shape, make_multifold_step, mesh_from_config
from dmf_tpu_torch.parallel.mesh import row_shares
from dmf_tpu_torch.train.fusion import FusionNetwork
from dmf_tpu_torch.train.optim import FusionOptController, SingleModelOptController

B = 8
DP_LOSS, DP_ATOL = 1e-4, 1e-4  # tests/test_parallel.py:96-101


def volumes(seed, n, channels):
    return np.random.RandomState(seed).rand(n, 32, 32, channels).astype(np.float32)


def fusion_batch(seed, n):
    r = np.random.RandomState(seed + 50)
    return {"dwi": volumes(seed, n, 14), "dce": volumes(seed + 1, n, 6),
            "masks": (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32),
            "labels": r.randint(0, 4, n).astype(np.int64), "aux_w": 0.5}


# ---------------------------------------------------------------- configuration
def test_mesh_from_config_and_shares():
    pcfg = port_config(tiny_cfg())

    def shaped(shape):
        return pcfg.replace(parallel=dataclasses.replace(pcfg.parallel, mesh_shape=shape))

    assert mesh_from_config(pcfg, "cpu") is None
    assert mesh_from_config(shaped((1, 1)), "cpu") is None
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        mesh_from_config(shaped((2, 1)), "cpu")
    # a model axis forms where the ranks are (test_torch_tp*.py)
    with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
        mesh_from_config(shaped((2, 2)), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 cards on this host, have 0"):
            mesh_from_config(shaped((2, 1)), "cuda")
    for n, k in ((8, 1), (8, 2), (6, 4), (1, 1)):
        assert auto_mesh_shape(n, k) == jparallel.auto_mesh_shape(n, k)
    # JAX pads a batch to a multiple of the data axis and shards it evenly
    assert row_shares(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert row_shares(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert row_shares(5, 2) == [(0, 3), (3, 5)]


@pytest.mark.parametrize("mesh,error,match", [("8", ValueError, "needs 8 ranks, have 1"),
                                              ("4x2", ValueError, "needs 8 ranks, have 1")])
def test_cli_mesh_that_cannot_form_raises(mesh, error, match):
    with pytest.raises(error, match=match):
        cli.main(["run", "--tiny", "--device", "cpu", "--folds", "0", "--mesh", mesh])


# ---------------------------------------------------------------- the DP fusion step
@pytest.fixture(scope="module")
def fusion_models():
    cfg = tiny_cfg(dropout=0.2, use_backbone=False)
    b = fusion_batch(0, 2)
    _, _, pmods = fusion_stack(cfg, b["dwi"], b["dce"], seeds=(31, 32, 33))
    pcfg = port_config(cfg).replace(batch_size=B)
    return pcfg, FusionNetwork(*pmods)


@pytest.fixture(scope="module")
def fusion_steps(fusion_models, tmp_path_factory):
    pcfg, net = fusion_models
    ctl = FusionOptController(pcfg)
    ctl.on_epoch_start(3)  # every group trains
    kw = dict(kind="fusion", cfg=pcfg, batches=[fusion_batch(i, n) for i, n in
                                                enumerate((B, B, 2))],
              hp=ctl.hyperparams(), train_labels=np.arange(18) % 4)
    single = W.steps(None, model=copy.deepcopy(net), **kw)
    runs = {n: W.spawn(tmp_path_factory.mktemp(f"dp{n}"), n, "steps", model=net, **kw)
            for n in (2, 4)}
    return single, runs


@pytest.mark.parametrize("world", [2, 4])
def test_dp_fusion_step_equals_single_process(fusion_steps, world):
    single, runs = fusion_steps
    ranks = runs[world]
    for step, ref in enumerate(single["metrics"]):
        for r in ranks:  # the global batch's metrics, on every rank
            got = r["metrics"][step]
            assert got.keys() == ref.keys()
            for k in ("loss", "clf_loss", "mask_loss", "recon_loss", "mimic_loss", "acc"):
                assert abs(got[k] - ref[k]) < DP_LOSS, (step, k, got[k], ref[k])
            np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-4)
    # the pair mimic reads samples 0-3 of the global batch: non-zero on the full
    # batches (rows on two ranks at 4 ranks), 0 on the tail of 2
    assert single["metrics"][0]["mimic_loss"] > 0 and single["metrics"][2]["mimic_loss"] == 0
    for k, t in single["state"].items():
        for r in ranks:
            np.testing.assert_allclose(r["state"][k].numpy(), t.numpy(), rtol=0, atol=DP_ATOL,
                                       err_msg=k)
        for r in ranks[1:]:
            assert torch.equal(r["state"][k], ranks[0]["state"][k]), k


def test_dp_tail_with_empty_shares_is_the_short_batch_step(fusion_steps):
    """The tail of 2 over 4 ranks (shares 1, 1, 0, 0) moved the running
    statistics as the single-process short batch did."""
    single, runs = fusion_steps
    stats = [k for k in single["state"] if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(runs[4][2]["state"][k].numpy(), single["state"][k].numpy(),
                                   rtol=0, atol=DP_ATOL, err_msg=k)


# ---------------------------------------------------------------- the DP encoder step vs JAX
def port_keyed(sd):
    return {canonical_key(k): v for k, v in sd.items() if not DROPPED_KEY_PATTERNS[0].search(k)}


@pytest.fixture(scope="module")
def encoder_case():
    cfg = tiny_cfg(dropout=0.0, use_backbone=False).replace(batch_size=B)
    x = volumes(7, B, 14)
    jm, v = jax_encoder(cfg.dwi_model, 14, x, seed=8)
    r = np.random.RandomState(9)
    batch = {"imgs": x, "masks": (r.rand(B, 32, 32, 1) > 0.7).astype(np.float32),
             "labels": (np.arange(B) % 4).astype(np.int64), "aux_w": 1.0}
    return cfg, jm, v, batch


PREDICT_CASES = [("tta", False), ("tta_mc", False), ("tta", True)]
K = 4  # folds over the 2 ranks


@pytest.fixture(scope="module")
def predict_case():
    """Fusion models without a backbone (ResLite dropout 0 and 0.2, the same
    weights) and three requests: B=8, B=3 (shares 2, 1) and B=8."""
    out = {}
    for p in (0.0, 0.2):
        cfg = tiny_cfg(dropout=p, use_backbone=False, mc_passes=4)
        b = fusion_batch(0, 2)
        jmods, jvars, pmods = fusion_stack(cfg, b["dwi"], b["dce"], seeds=(41, 42, 43))
        out[p] = (cfg, jmods, jvars, pmods)
    requests = [(fusion_batch(i, n)["dwi"], fusion_batch(i, n)["dce"])
                for i, n in ((10, B), (11, 3), (12, B))]
    return out, requests


@pytest.fixture(scope="module")
def tiny_spawns(encoder_case, predict_case, tmp_path_factory):
    """The 2-rank runs of the encoder step, the predictors and the fold
    axis in one spawn, and their single-process runs."""
    cfg, _, v, batch = encoder_case
    pcfg = port_config(cfg)
    hp = SingleModelOptController(pcfg, "dwi").hyperparams()
    enc = port_encoder(cfg.dwi_model, 14, v)[0]
    steps = dict(kind="single", cfg=pcfg, batches=[batch], hp=hp, train_labels=batch["labels"])
    models, requests = predict_case
    preds = {p: dict(cfg=port_config(models[p][0]), models=models[p][3], requests=requests,
                     cases=PREDICT_CASES if p == 0.0 else [("tta_mc", False)])
             for p in models}
    folds = [port_encoder(cfg.dwi_model, 14, jax_encoder(cfg.dwi_model, 14, batch["imgs"],
                                                         seed=20 + i)[1])[0]
             for i in range(K)]
    fold_batches = [dict(batch, imgs=volumes(30 + i, B, 14)) for i in range(K)]
    multi = dict(cfg=pcfg, batches=fold_batches, hp=hp, train_labels=batch["labels"])
    r = np.random.RandomState(13)
    fits = dict(cfg=pcfg.replace(batch_size=4), workdir=str(tmp_path_factory.mktemp("mf")),
                folds=[tuple({"imgs": volumes(40 + 2 * i + j, n, 14),
                              "masks": (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32),
                              "labels": (np.arange(n) % 4).astype(np.int64)}
                             for j, n in enumerate((10, 4))) for i in range(2)])
    jobs = [("steps", dict(steps, model=enc)), ("predict", preds[0.0]),
            ("predict", preds[0.2]), ("multifold", dict(multi, models=folds)),
            ("multifold_fit", dict(fits, models=copy.deepcopy(folds[:2])))]
    ranks = W.spawn(tmp_path_factory.mktemp("tiny"), 2, "several", jobs=jobs)
    single = [W.steps(None, model=copy.deepcopy(enc), **steps), W.predict(None, **preds[0.0]),
              W.predict(None, **preds[0.2]),
              W.multifold(None, models=copy.deepcopy(folds), **multi),
              W.multifold_fit(None, models=copy.deepcopy(folds[:2]), **fits)]
    names = ("steps", "predict", "predict_mc", "multifold", "multifold_fit")
    return ({"single": dict(zip(names, single)),
             "mesh": [dict(zip(names, r)) for r in ranks]},
            (folds, fold_batches, hp))


def test_dp_encoder_step_matches_jax_mesh(encoder_case, tiny_spawns):
    cfg, jm, v, batch = encoder_case
    state = jtrain.TrainState.create(jax.tree.map(jnp.asarray, v))
    spec = jtrain.build_group_spec(state.params, False, True)
    raw = jtrain.make_single_train_step(cfg, "dwi", jm, j_clf(cfg, batch["labels"], "dwi"),
                                        j_mask(cfg, "dwi"), spec, jit_compile=False)
    hp = jtrain.SingleModelOptController(cfg, "dwi").hyperparams()
    mesh = jparallel.make_mesh(8, 1)
    step, place = jparallel.make_spmd_step(raw, mesh, jparallel.state_shardings(state, mesh),
                                           donate=False)
    jb = {"imgs": jnp.asarray(batch["imgs"]), "masks": jnp.asarray(batch["masks"]),
          "labels": jnp.asarray(batch["labels"], jnp.int32), "aux_w": jnp.asarray(1.0)}
    s8, m8 = step(jparallel.shard_state(state, mesh), place(jb), jax.random.PRNGKey(5), hp)
    with resnet_layers((1, 1, 1, 1)):
        final = port_keyed(export_reference_encoder(jax.device_get(s8.variables)))
    runs = tiny_spawns[0]
    single, ranks = runs["single"]["steps"], [r["steps"] for r in runs["mesh"]]
    for r in ranks:
        assert abs(r["metrics"][0]["loss"] - float(m8["loss"])) < DP_LOSS
        assert abs(r["metrics"][0]["loss"] - single["metrics"][0]["loss"]) < DP_LOSS
        shared = [k for k in r["state"] if k in final]
        assert len(shared) > 20
        for k in shared:
            np.testing.assert_allclose(r["state"][k].numpy(), final[k], rtol=0, atol=DP_ATOL,
                                       err_msg=k)


# ---------------------------------------------------------------- predictors
def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("case", PREDICT_CASES, ids=lambda c: f"{c[0]}-int8" if c[1] else c[0])
def test_mesh_predictor_equals_single_process(tiny_spawns, case):
    """``(mean, std, aux)`` of each request, the aux's (views x B) leaves in
    the unsharded layout; dropout off, so the MC passes are deterministic."""
    runs = tiny_spawns[0]
    ref = runs["single"]["predict"][case]
    for r in runs["mesh"]:
        for (m0, s0, a0), (m1, s1, a1) in zip(ref, r["predict"][case]):
            np.testing.assert_allclose(m1.numpy(), m0.numpy(), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=1e-5, atol=1e-6)
            l0, l1 = tree_leaves(a0), tree_leaves(a1)
            assert len(l0) == len(l1) > 0
            for x, y in zip(l0, l1):
                assert x.shape == y.shape
                np.testing.assert_allclose(y.float().numpy(), x.float().numpy(), rtol=1e-5,
                                           atol=1e-6)


def test_mesh_predictor_mc_statistics(tiny_spawns):
    """With dropout 0.2 each rank draws its own masks (a generator seeded
    from the caller's and the rank): the ensemble differs from one
    process's draw, its statistics agree (tests/test_spmd_loop.py:289-309)."""
    runs = tiny_spawns[0]
    ref = runs["single"]["predict_mc"][("tta_mc", False)]
    for r in runs["mesh"]:
        got = r["predict_mc"][("tta_mc", False)]
        for (m0, s0, _), (m1, s1, _) in zip(ref, got):
            np.testing.assert_allclose(m1.sum(-1).numpy(), 1.0, rtol=1e-5)
            assert (s1 > 0).all() and torch.isfinite(s1).all()
            np.testing.assert_allclose(m1.numpy(), m0.numpy(), atol=0.1)
            assert 0.5 < float(s1.mean() / s0.mean()) < 2.0
        assert not torch.equal(got[0][0], ref[0][0])
    assert torch.equal(runs["mesh"][0]["predict_mc"][("tta_mc", False)][0][0],
                       runs["mesh"][1]["predict_mc"][("tta_mc", False)][0][0])


def test_mesh_predictor_matches_jax_mesh(predict_case, tiny_spawns):
    """``tta`` at B=8 against JAX's ``shard_map`` predictor on
    ``make_mesh(4, 1)``, the same weights."""
    models, requests = predict_case
    cfg, (jd, jc, jf), (vd, vc, vf), _ = models[0.0]
    predict = j_fusion_predictor(cfg, jd, jc, jf, mode="tta", mesh=jparallel.make_mesh(4, 1))
    x, y = requests[0]
    m, s, _ = predict(vd, vc, vf, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    got = tiny_spawns[0]["mesh"][0]["predict"][("tta", False)][0]
    assert_close(got[0], np.asarray(m), what="mean")
    assert_close(got[1], np.asarray(s), what="std")


# ---------------------------------------------------------------- the fold axis
def test_multifold_step_over_the_mesh(tiny_spawns):
    """Rank r steps folds 2r, 2r+1 alone (no collective): those bit-equal to
    the unsharded step, the others' states untouched and metrics NaN."""
    runs, (folds, _, _) = tiny_spawns
    ref = runs["single"]["multifold"]
    for rank, r in enumerate(runs["mesh"]):
        got = r["multifold"]
        assert got["owned"] == [2 * rank, 2 * rank + 1]
        for i in range(K):
            if i in got["owned"]:
                for k, t in ref["states"][i].items():
                    assert torch.equal(got["states"][i][k], t), (i, k)
                assert torch.equal(got["metrics"]["loss"][i], ref["metrics"]["loss"][i])
            else:
                for k, t in folds[i].state_dict().items():
                    assert torch.equal(got["states"][i][k], t), (i, k)
                assert torch.isnan(got["metrics"]["loss"][i])
    with pytest.raises(TypeError, match="Mesh"):
        make_multifold_step(lambda *a: {}, mesh=object())


def test_multifold_losses_match_jax(encoder_case, tiny_spawns):
    cfg, jm, _, batch = encoder_case
    runs, (folds, fold_batches, _) = tiny_spawns
    variables = [jax_encoder(cfg.dwi_model, 14, batch["imgs"], seed=20 + i)[1] for i in range(K)]
    states = [jtrain.TrainState.create(jax.tree.map(jnp.asarray, v)) for v in variables]
    spec = jtrain.build_group_spec(states[0].params, False, True)
    raw = jtrain.make_single_train_step(cfg, "dwi", jm, j_clf(cfg, batch["labels"], "dwi"),
                                        j_mask(cfg, "dwi"), spec, jit_compile=False)
    from dmf_tpu.parallel import make_multifold_step as j_multifold_step
    from dmf_tpu.parallel import stack_fold_batches, stack_fold_states

    hp = jtrain.SingleModelOptController(cfg, "dwi").hyperparams()
    jb = [{"imgs": jnp.asarray(b["imgs"]), "masks": jnp.asarray(b["masks"]),
           "labels": jnp.asarray(b["labels"], jnp.int32), "aux_w": jnp.asarray(1.0)}
          for b in fold_batches]
    _, m = j_multifold_step(raw, donate=False)(
        stack_fold_states(states), stack_fold_batches(jb),
        jnp.stack([jax.random.PRNGKey(7 + i) for i in range(K)]), hp)
    losses = np.full(K, np.nan)
    for r in runs["mesh"]:
        for i in r["multifold"]["owned"]:
            losses[i] = float(r["multifold"]["metrics"]["loss"][i])
    np.testing.assert_allclose(losses, np.asarray(m["loss"]), rtol=1e-3)


def test_fit_single_multifold_over_the_mesh(tiny_spawns):
    """2 folds over 2 ranks, each trained alone on its rank (10 train
    volumes at B=4: a short tail), then broadcast: every rank returns both
    folds' histories, final and best states, bit-equal to the
    single-process lockstep run."""
    runs = tiny_spawns[0]
    ref = runs["single"]["multifold_fit"]
    for r in runs["mesh"]:
        got = r["multifold_fit"]
        assert len(got) == len(ref) == 2
        for a, b in zip(got, ref):
            assert a["history"] == b["history"]
            for key in ("state", "best"):
                assert (a[key] is None) == (b[key] is None)
                for k, t in (b[key] or {}).items():
                    assert torch.equal(a[key][k], t), (key, k)
