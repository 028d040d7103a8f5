"""The port's fusion training vs the JAX package's, fp32 on the CPU, at toy
geometry (32^2, channels (8, 16, 32), the (1, 1, 1, 1) ResNet-50 of
``test_torch_helpers``, fusion channels 16).

* every parameter of the fusion network gets the JAX group id (through the
  exporters' key maps); the controller gives JAX's lr, wd and trainable
  flags per epoch across the three unfreezes and plateau reductions before
  and after them; the group dump and the input statistics print JAX's text;
* the train route calls no kernel wrapper, the eval route calls kernels 1,
  2 and 6;
* ``compute_fusion_losses`` equals JAX's, with the sample-pair mimic at B=4,
  0 at B=3 and dropped without ``reference_compat``;
* the fusion train step follows ``make_fusion_train_step`` over 8 steps (2
  an epoch, ``unfreeze_timer=1``: three unfreezes), B=4, dropout 0, the same
  batches: every loss term and gradient norm to rel 1e-3 per step, then the
  BatchNorm running statistics (``refine``'s and ``fusion_conv_reduce``'s
  included, whose output feeds nothing), the parameters (``refine``, the
  reduce and the encoders' projectors included, which get zero gradients
  and decay) and the eval step's logits and metrics;
* the DCE encoder's train step follows JAX's over 6 steps across its
  backbone's unfreeze.

The trajectory's weight decays are raised (``fusion_cfg``) so that the
decay of the parameters without gradient shows in fp32.

The backboned encoders have no port-only parameter (``test_torch_train``'s
``port_only_params`` is empty with a backbone), so none is excluded.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_close, fusion_stack, jax_encoder, port_config,
                                port_encoder, port_fusion, resnet_layers, tiny_cfg, volumes)

from dmf_tpu import config as jconfig
from dmf_tpu import train as jtrain
from dmf_tpu.losses import get_classification_loss_fn as j_clf, get_mask_loss_fn as j_mask
from dmf_tpu.models.ref_ckpt import export_reference_encoder, export_reference_fusion
from dmf_tpu.train import fusion as jfusion, optim as joptim, schedule as jsched
from dmf_tpu.train.single import make_single_train_step as j_single_step
from dmf_tpu.utils import logging as jlog

from dmf_tpu_torch.losses import get_classification_loss_fn as p_clf, get_mask_loss_fn as p_mask
from dmf_tpu_torch.models import adapter as padapter, encoder as pencoder, layers as players
from dmf_tpu_torch.models.weights import DROPPED_KEY_PATTERNS, canonical_key
from dmf_tpu_torch.train import fusion as pfusion, optim as poptim
from dmf_tpu_torch.train import schedule as psched
from dmf_tpu_torch.train.single import make_single_train_step as p_single_step
from dmf_tpu_torch.train.state import TrainState as PState
from dmf_tpu_torch.utils import logging as plog

B = 4
STEPS_PER_EPOCH = 2
EPOCHS = 4  # epoch 0 encoders frozen; unfreezes at epochs 1, 2, 3
PARTS = ("dwi", "dce", "fusion")


def fusion_cfg():
    """Toy geometry with the unfreeze every epoch.  The weight decays are
    raised to 0.2 (defaults 1e-4): at the default lr x wd (1e-8 to 1e-9 a
    step) the decoupled decay of a parameter without gradient rounds away in
    fp32, and the trajectory could not tell whether it was applied."""
    cfg = tiny_cfg(dropout=0.0).replace(batch_size=B, unfreeze_timer=1,
                                        foundation_model_unfreeze_timer=1)
    models = {}
    for name in ("dwi_model", "fusion_model"):
        mc = getattr(cfg, name)
        models[name] = dataclasses.replace(mc, optimizer=dataclasses.replace(
            mc.optimizer, reg_base=0.2))
    return cfg.replace(**models)


def batch_arrays(seed, n=B):
    xd, xc = volumes(seed, b=n)
    r = np.random.RandomState(seed + 100)
    return {"dwi": xd, "dce": xc, "masks": (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32),
            "labels": r.randint(0, 4, size=n).astype(np.int64)}


def port_keyed(sd, prefix=""):
    """A reference-layout export keyed as the port holds it (the backbone
    once, under ``backbone.``), under ``prefix``."""
    return {prefix + canonical_key(k): v for k, v in sd.items()
            if not DROPPED_KEY_PATTERNS[0].search(k)}


def export_all(params, stats):
    """The JAX fusion tree exported to the port's ``dwi.``/``dce.``/``fusion.``
    keys."""
    out = {}
    with resnet_layers((1, 1, 1, 1)):
        for enc in ("dwi", "dce"):
            out.update(port_keyed(export_reference_encoder(
                {"params": params[enc], "batch_stats": stats[enc]}), enc + "."))
    out.update(port_keyed(export_reference_fusion(
        {"params": params["fusion"], "batch_stats": stats["fusion"]}), "fusion."))
    return out


@pytest.fixture(scope="module")
def stack():
    cfg = fusion_cfg()
    b = batch_arrays(0)
    jmods, jvars, pmods = fusion_stack(cfg, b["dwi"], b["dce"])
    return cfg, jmods, jvars, pmods


def port_net(stack):
    """A fresh port fusion network on the stack's weights."""
    cfg, _, (vd, vc, vf), _ = stack
    pd, pc = port_encoder(cfg.dwi_model, 14, vd)[0], port_encoder(cfg.dce_model, 6, vc)[0]
    return pfusion.FusionNetwork(pd, pc, port_fusion(cfg, vf, pd.feature_size)[0])


def jax_tree(jvars):
    params = {m: v["params"] for m, v in zip(PARTS, jvars)}
    stats = {m: v["batch_stats"] for m, v in zip(PARTS, jvars)}
    return params, stats


# ---------------------------------------------------------------- groups, controller, dumps
def test_fusion_group_ids_match_jax(stack):
    """Each JAX leaf of the combined tree filled with its group id (+10),
    exported and loaded: every port parameter holds its JAX group."""
    cfg, jmods, jvars, _ = stack
    params, stats = jax_tree(jvars)
    jspec = jfusion.build_fusion_group_spec(params, cfg)
    filled = jax.tree.map(lambda leaf, gid: np.full(np.shape(leaf), gid + 10.0, np.float32),
                          params, jspec.group_ids)
    sd = export_all(filled, stats)
    net = port_net(stack)
    names = [n for n, _ in net.named_parameters()]
    pspec = poptim.build_fusion_group_spec(names, port_config(cfg))
    assert pspec.names == jspec.names and pspec.num_groups == 4
    for name, p in net.named_parameters():
        vals = np.unique(np.asarray(sd[name]))
        assert len(vals) == 1 and pspec.group_ids[name] == vals[0] - 10, name
    # the head by its prefix: refine and cross_attn_block are not encoder blocks
    assert {pspec.group_ids[n] for n in names if n.startswith("fusion.")} == {3}
    assert pspec.group_ids["fusion.refine.bottlenecks.0.0.weight"] == 3
    assert sum(g == -1 for g in pspec.group_ids.values()) == 4  # two classification heads
    with pytest.raises(ValueError, match="not parameters"):
        poptim.build_fusion_group_spec(names + ["head.weight"], port_config(cfg))


def test_describe_groups_matches_jax(stack):
    """The group dump's text equals JAX's on one tree (the port's names in
    JAX's path form); on the fusion network each group holds JAX's element
    count under the port's names."""
    cfg, _, jvars, _ = stack
    tree = {"dwi": {"backbone": {"w": np.zeros((3, 4))}, "block1": {"b": np.zeros(5)},
                    "classification_head": {"k": np.zeros(2)}},
            "fusion": {"refine": {"k": np.zeros((2, 2))}, "gamma": np.zeros(())}}
    jspec = joptim.GroupSpec(group_ids={"dwi": {"backbone": {"w": 0}, "block1": {"b": 1},
                                                "classification_head": {"k": -1}},
                                        "fusion": {"refine": {"k": 3}, "gamma": 3}},
                             num_groups=4, names=("a", "b", "c", "d"))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    names = [joptim._path_str(p) for p, _ in flat]
    ids = dict(zip(names, jax.tree_util.tree_leaves(jspec.group_ids)))
    pspec = poptim.GroupSpec(group_ids=ids, num_groups=4, names=jspec.names)
    pparams = {n: torch.from_numpy(np.asarray(v)) for n, (_, v) in zip(names, flat)}
    hp = np.array([1e-4, 2e-5, 3e-6, 4e-7], np.float32)
    jhp = joptim.GroupedHyperParams(jnp.asarray(hp), jnp.asarray(hp * 2), jnp.asarray(hp > 1e-5))
    php = poptim.GroupedHyperParams(hp, hp * 2, (hp > 1e-5).astype(np.float32))
    for h in ((None, None), (jhp, php)):
        assert (poptim.describe_groups(pparams, pspec, h[1], max_examples=1)
                == joptim.describe_groups(tree, jspec, h[0], max_examples=1))
    params, _ = jax_tree(jvars)
    jcounts = {}
    for leaf, gid in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(jfusion.build_fusion_group_spec(
                             params, cfg).group_ids)):
        jcounts[int(gid)] = jcounts.get(int(gid), 0) + int(np.prod(np.shape(leaf)))
    net = port_net(stack)
    text = poptim.describe_groups(dict(net.named_parameters()), poptim.build_fusion_group_spec(
        [n for n, _ in net.named_parameters()], port_config(cfg)))
    for gid, n in jcounts.items():
        assert f" {n:,} params" in text, (gid, n)


def test_input_stats_matches_jax():
    r = np.random.RandomState(3)
    x, m = r.rand(2, 8, 8, 3).astype(np.float32), (r.rand(2, 4, 4, 1) > 0.5).astype(np.float32)
    assert plog.input_stats(torch.from_numpy(x), torch.from_numpy(m)) == jlog.input_stats(
        jnp.asarray(x), jnp.asarray(m))
    assert plog.input_stats(x) == jlog.input_stats(x)


def test_unported_knobs_raise():
    """The knobs that raised here now build.  ``remat`` raised until the
    rematerialised ResLite blocks were ported (ROADMAP 1.14): an encoder
    built with it evaluates as one built without it, on the same weights
    (its train steps are held in test_torch_remat.py).  ``use_native_loader``
    raised until the native host library was ported (ROADMAP 1.4); its fits
    run in test_torch_native.py."""
    cfg = port_config(fusion_cfg())
    encs = [pencoder.Encoder("dwi", dataclasses.replace(cfg.dwi_model, remat=remat), 14, 4,
                             (1, 1, 1, 1)) for remat in (False, True)]
    encs[1].load_state_dict(encs[0].state_dict())
    x = torch.rand(2, 14, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain, remat = (enc(x) for enc in encs)
    assert encs[1].config.remat and not encs[0].config.remat
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(plain[1]["raw_feats"], remat[1]["raw_feats"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("freeze", [True, False])
def test_fusion_controller_matches_jax(freeze):
    """lr, wd and trainable flags per epoch across the three unfreezes
    (timer 2: epochs 2, 4, 6) and plateau reductions before and after them
    (patience 1)."""
    jcfg = jconfig.default_parameters(unfreeze_timer=2, backbone_freeze_on_start=freeze)
    sch = dataclasses.replace(jcfg.fusion_model.scheduler, patience=1, factor=0.5,
                              min_lr=2e-7)
    jcfg = jcfg.replace(fusion_model=dataclasses.replace(jcfg.fusion_model, scheduler=sch))
    pcfg = port_config(jcfg)
    jc, pc = joptim.FusionOptController(jcfg), poptim.FusionOptController(pcfg)
    js, ps = jsched.make_scheduler(sch, 1e-4), psched.make_scheduler(port_config(sch), 1e-4)
    trainable = []
    for epoch, metric in enumerate([1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.2, 0.2, 0.2]):
        jc.on_epoch_start(epoch)
        pc.on_epoch_start(epoch)
        jh, ph = jc.hyperparams(), pc.hyperparams()
        for f in ("lr", "wd", "trainable"):
            np.testing.assert_array_equal(getattr(ph, f), np.asarray(getattr(jh, f)), err_msg=f)
        trainable.append(ph.trainable.tolist())
        if js.step_reduced(metric):
            jc.apply_plateau(js.factor, js.min_lr)
        if ps.step_reduced(metric):
            pc.apply_plateau(ps.factor, ps.min_lr)
    if freeze:
        assert trainable[0] == [0, 0, 0, 1] and trainable[2] == [0, 0, 1, 1]
        assert trainable[4] == [0, 1, 1, 1] and trainable[6] == [1, 1, 1, 1]
    else:
        assert trainable == [[1, 1, 1, 1]] * 10


# ---------------------------------------------------------------- routes and losses
def test_fusion_train_route_calls_no_kernel_wrapper(stack, monkeypatch):
    """``train=True`` reaches none of kernels 1, 2 and 6 (on the card they
    raise under autograd); the eval route calls each, ``fusion_se`` included
    (kernel 6: both modality attentions and the head)."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(players, "se_epilogue", spy("se_epilogue", players.se_epilogue))
    monkeypatch.setattr(players, "se_scale", spy("se_scale", players.se_scale))
    monkeypatch.setattr(padapter, "conv3x3_bn_gelu",
                        spy("conv3x3_bn_gelu", padapter.conv3x3_bn_gelu))
    net = port_net(stack)
    b = batch_arrays(1)
    xd, xc = (torch.from_numpy(b[k]).permute(0, 3, 1, 2) for k in ("dwi", "dce"))
    logits, fused_mask, aux, _ = net(xd, xc, train=True)
    (logits.sum() + fused_mask.sum() + aux["recon_fused"].sum()).backward()
    assert calls == []
    with torch.no_grad():
        net(xd, xc, lean_encoders=True)
    assert calls.count("se_epilogue") == 6 and calls.count("conv3x3_bn_gelu") == 12
    assert calls.count("se_scale") == 3


@pytest.mark.parametrize("n,compat", [(4, True), (3, True), (4, False)])
def test_fusion_losses_match_jax(n, compat):
    """``compute_fusion_losses`` on the same random outputs (NHWC for JAX,
    NCHW for the port) in training and in evaluation."""
    jcfg = fusion_cfg().replace(reference_compat=compat)
    pcfg = port_config(jcfg)
    r = np.random.RandomState(n + 10 * compat)

    def a(*shape):
        return r.standard_normal((n,) + shape).astype(np.float32)

    outs = {"logits": a(4), "fused_mask": a(32, 32, 1), "dwi_mask": a(32, 32, 1),
            "dce_mask": a(32, 32, 1), "proj_fused": a(4, 4, 8), "recon_fused": a(4, 4, 1),
            "r_dwi": [a(16, 16, 1), a(8, 8, 1)], "r_dce": [a(16, 16, 1), a(8, 8, 1)],
            "dwi": r.rand(n, 32, 32, 14).astype(np.float32),
            "dce": r.rand(n, 32, 32, 6).astype(np.float32),
            "masks": (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32)}
    labels = r.randint(0, 4, size=n)

    def t(x):
        return [t(v) for v in x] if isinstance(x, list) else torch.from_numpy(x).permute(0, 3, 1, 2)

    j, p = {k: (jax.tree.map(jnp.asarray, v)) for k, v in outs.items()}, {
        k: t(v) for k, v in outs.items() if k != "logits"}
    p["logits"] = torch.from_numpy(outs["logits"])
    for train in (True, False):
        _, jm = jfusion.compute_fusion_losses(
            jcfg, j_clf(jcfg, labels, "fusion"), j_mask(jcfg, "fusion"), j["logits"],
            j["fused_mask"], {"proj_fused": j["proj_fused"], "recon_fused": j["recon_fused"]},
            {"dwi_aux": {"recon_feats": j["r_dwi"]}, "dce_aux": {"recon_feats": j["r_dce"]},
             "dwi_mask": j["dwi_mask"], "dce_mask": j["dce_mask"]},
            j["dwi"], j["dce"], j["masks"], jnp.asarray(labels), 0.7, is_train=train)
        _, pm = pfusion.compute_fusion_losses(
            pcfg, p_clf(pcfg, labels, "fusion"), p_mask(pcfg, "fusion"), p["logits"],
            p["fused_mask"], {"proj_fused": p["proj_fused"], "recon_fused": p["recon_fused"]},
            {"dwi_aux": {"recon_feats": p["r_dwi"]}, "dce_aux": {"recon_feats": p["r_dce"]},
             "dwi_mask": p["dwi_mask"], "dce_mask": p["dce_mask"]},
            p["dwi"], p["dce"], p["masks"], torch.from_numpy(labels), 0.7, is_train=train)
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} train={train}")
        assert (float(pm["mimic_loss"]) > 0) == (train and compat and n >= 4)
    assert float(pfusion.fusion_sample_pair_mimic(torch.ones(3, 8, 4, 4))) == 0.0


# ---------------------------------------------------------------- the trajectory
def trajectory_batches():
    return [batch_arrays(20 + i) for i in range(EPOCHS * STEPS_PER_EPOCH)]


def run_jax(stack, data, train_labels):
    cfg, (jd, jc, jf), jvars, _ = stack
    params, stats = jax_tree(jvars)
    params, stats = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats)
    state = jtrain.TrainState(params=params, batch_stats=stats,
                              opt_state=jtrain.adamw_init(params), step=jnp.zeros((), jnp.int32))
    spec = jfusion.build_fusion_group_spec(params, cfg)
    clf, mask = j_clf(cfg, train_labels, "fusion"), j_mask(cfg, "fusion")
    step = jfusion.make_fusion_train_step(cfg, jd, jc, jf, clf, mask, spec, donate=False)
    ctrl = joptim.FusionOptController(cfg)
    records = []
    for i, b in enumerate(data):
        epoch = i // STEPS_PER_EPOCH
        if i % STEPS_PER_EPOCH == 0:
            ctrl.on_epoch_start(epoch)
            hp = ctrl.hyperparams()
        batch = {k: jnp.asarray(v) for k, v in b.items()}
        batch["labels"] = batch["labels"].astype(jnp.int32)
        batch["aux_w"] = jnp.asarray(jsched.aux_loss_weight(epoch, cfg.aux_loss_weight_epoch_limit),
                                     jnp.float32)
        state, m = step(state, batch, jax.random.PRNGKey(i), hp)
        records.append({k: float(v) for k, v in m.items()})
    evaluate = jfusion.make_fusion_eval_step(cfg, jd, jc, jf, clf, mask)
    b = data[0]
    logits, _, em = evaluate(state, {"dwi": jnp.asarray(b["dwi"]), "dce": jnp.asarray(b["dce"]),
                                     "masks": jnp.asarray(b["masks"]),
                                     "labels": jnp.asarray(b["labels"], jnp.int32)})
    return state, records, np.asarray(logits), {k: float(v) for k, v in em.items()}


def run_port(stack, data, train_labels):
    cfg = port_config(stack[0])
    net = port_net(stack)
    state = PState.create(net, num_groups=4)
    spec = poptim.build_fusion_group_spec([n for n, _ in net.named_parameters()], cfg)
    clf, mask = p_clf(cfg, train_labels, "fusion"), p_mask(cfg, "fusion")
    step = pfusion.make_fusion_train_step(cfg, clf, mask, spec)
    ctrl = poptim.FusionOptController(cfg)
    records = []
    for i, b in enumerate(data):
        epoch = i // STEPS_PER_EPOCH
        if i % STEPS_PER_EPOCH == 0:
            ctrl.on_epoch_start(epoch)
            hp = ctrl.hyperparams()
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        batch["aux_w"] = psched.aux_loss_weight(epoch, cfg.aux_loss_weight_epoch_limit)
        records.append({k: float(v) for k, v in step(state, batch, None, hp).items()})
    logits, _, em = pfusion.make_fusion_eval_step(cfg, clf, mask)(
        state, {k: torch.from_numpy(v) for k, v in data[0].items()})
    return state, spec, records, logits, {k: float(v) for k, v in em.items()}


@pytest.fixture(scope="module")
def trajectories(stack):
    data = trajectory_batches()
    labels = np.concatenate([b["labels"] for b in data])
    jstate, jrec, jlogits, jeval = run_jax(stack, data, labels)
    pstate, spec, prec, plogits, peval = run_port(stack, data, labels)
    start = export_all(*jax_tree(stack[2]))
    final = export_all(jstate.params, jstate.batch_stats)
    return jrec, jlogits, jeval, pstate, spec, prec, plogits, peval, start, final


def test_fusion_loss_trajectory_matches_jax(trajectories):
    jrec, _, _, pstate, _, prec, *_ = trajectories
    keys = ["loss", "clf_loss", "mask_loss", "recon_loss", "mimic_loss", "acc", "grad_norm",
            "dwi_grad_norm", "dce_grad_norm", "fusion_grad_norm"]
    assert set(prec[0]) == set(jrec[0]) == set(keys) | {"grad_nonfinite"}
    for k in keys:
        np.testing.assert_allclose([r[k] for r in prec], [r[k] for r in jrec], rtol=1e-3,
                                   err_msg=k)
    assert all(r["grad_nonfinite"] == 0 and r["mimic_loss"] > 0 for r in prec)
    # group 3 every step; groups 2, 1, 0 from epochs 1, 2, 3 (fresh counts)
    assert pstate.opt_state.count.tolist() == [2, 4, 6, 8]
    assert pstate.step == EPOCHS * STEPS_PER_EPOCH


def test_fusion_bn_running_stats_match_jax(trajectories):
    """Batch statistics in every BatchNorm, the frozen backbones' and the
    unconsumed ``refine``/``fusion_conv_reduce``'s included."""
    *_, pstate, _, _, _, _, start, final = trajectories
    stats = {k: t for k, t in pstate.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert any(k.startswith("fusion.refine.") for k in stats)
    assert any(k.startswith("fusion.fusion_conv_reduce.") for k in stats)
    for k, t in stats.items():
        assert_close(t, final[k], rtol=1e-3, what=k)
        assert not np.allclose(final[k], start[k]), k


def test_fusion_params_after_steps_match_jax(trajectories):
    """Each group's update to rel 5e-2 in L2 (``test_torch_train``'s bound),
    the excluded classification heads unchanged; the parameters the loss
    does not reach (zero gradients: only the decoupled decay moves them) to
    rel 1e-5 against JAX, and moved."""
    *_, pstate, spec, _, _, _, start, final = trajectories
    diff, upd = {}, {}
    unreached = ("fusion.refine.", "fusion.fusion_conv_reduce.", "dwi.proj_", "dce.proj_")
    n_unreached = 0
    for name, p in pstate.model.named_parameters():
        gid = spec.group_ids[name]
        ours, theirs, s0 = (np.asarray(a, np.float64) for a in (p.detach(), final[name],
                                                               start[name]))
        diff[gid] = diff.get(gid, 0.0) + ((ours - theirs) ** 2).sum()
        upd[gid] = upd.get(gid, 0.0) + ((theirs - s0) ** 2).sum()
        if name.startswith(unreached):
            n_unreached += 1
            np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-8, err_msg=name)
            assert not np.array_equal(theirs, s0), name
    assert n_unreached > 0
    assert sorted(diff) == [-1, 0, 1, 2, 3]
    for gid in sorted(diff):
        if gid < 0:
            assert diff[gid] == 0 and upd[gid] == 0
        else:
            assert np.sqrt(diff[gid] / upd[gid]) < 5e-2, (gid, np.sqrt(diff[gid] / upd[gid]))


def test_fusion_eval_after_steps_matches_jax(trajectories):
    _, jlogits, jeval, _, _, _, plogits, peval, *_ = trajectories
    assert_close(plogits, jlogits, rtol=1e-3)
    assert set(peval) == set(jeval)
    for k in jeval:
        np.testing.assert_allclose(peval[k], jeval[k], rtol=1e-3, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- DCE single-model steps
def test_dce_train_step_trajectory_matches_jax():
    """The DCE encoder (6 channels, backbone frozen for 3 steps then
    trained) under ``make_single_train_step("dce")``: every loss term and
    gradient norm to rel 1e-3 per step, then the parameters per group."""
    jcfg = tiny_cfg(dropout=0.0).replace(foundation_model_unfreeze_timer=1, batch_size=B)
    pcfg = port_config(jcfg)
    data = [batch_arrays(40 + i) for i in range(6)]
    labels = np.concatenate([b["labels"] for b in data])
    jm, v = jax_encoder(jcfg.dce_model, 6, data[0]["dce"], seed=6)
    state = jtrain.TrainState.create(jax.tree.map(jnp.asarray, v))
    jspec = jtrain.build_group_spec(state.params, True, True)
    jstep = j_single_step(jcfg, "dce", jm, j_clf(jcfg, labels, "dce"), j_mask(jcfg, "dce"),
                          jspec, donate=False)
    enc, _ = port_encoder(jcfg.dce_model, 6, v)
    pstate = PState.create(enc)
    pspec = poptim.build_group_spec([n for n, _ in enc.named_parameters()], True)
    pstep = p_single_step(pcfg, "dce", p_clf(pcfg, labels, "dce"), p_mask(pcfg, "dce"), pspec)
    jc, pc = jtrain.SingleModelOptController(jcfg, "dce"), poptim.SingleModelOptController(
        pcfg, "dce")
    jrec, prec = [], []
    for i, b in enumerate(data):
        epoch = i // 3
        if i % 3 == 0:
            jc.on_epoch_start(epoch)
            pc.on_epoch_start(epoch)
            jhp, php = jc.hyperparams(), pc.hyperparams()
        aux_w = jsched.aux_loss_weight(epoch, jcfg.aux_loss_weight_epoch_limit)
        state, m = jstep(state, {"imgs": jnp.asarray(b["dce"]), "masks": jnp.asarray(b["masks"]),
                                 "labels": jnp.asarray(b["labels"], jnp.int32),
                                 "aux_w": jnp.asarray(aux_w, jnp.float32)},
                         jax.random.PRNGKey(i), jhp)
        jrec.append({k: float(x) for k, x in m.items()})
        prec.append({k: float(x) for k, x in pstep(pstate, {
            "imgs": torch.from_numpy(b["dce"]), "masks": torch.from_numpy(b["masks"]),
            "labels": torch.from_numpy(b["labels"]), "aux_w": aux_w}, None, php).items()})
    keys = ["loss", "clf_loss", "mask_loss", "recon_loss", "mimic_loss", "grad_norm"]
    keys += [k for k in jrec[0] if k.startswith("grad_norm_")]
    for k in keys:
        np.testing.assert_allclose([r[k] for r in prec], [r[k] for r in jrec], rtol=1e-3,
                                   err_msg=k)
    assert pstate.opt_state.count.tolist() == [3, 6, 6]
    with resnet_layers((1, 1, 1, 1)):
        start, final = (port_keyed(export_reference_encoder(t)) for t in (v, state.variables))
    diff, upd = {}, {}
    for name, p in pstate.model.named_parameters():
        gid = pspec.group_ids[name]
        ours, theirs, s0 = (np.asarray(a, np.float64) for a in (p.detach(), final[name],
                                                               start[name]))
        diff[gid] = diff.get(gid, 0.0) + ((ours - theirs) ** 2).sum()
        upd[gid] = upd.get(gid, 0.0) + ((theirs - s0) ** 2).sum()
    for gid in (0, 1, 2):
        assert np.sqrt(diff[gid] / upd[gid]) < 5e-2, gid
