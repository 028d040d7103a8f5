"""The port's training modules vs the JAX package's, fp32 on the CPU.

* the copies (schedulers, metrics, metric logs, output paths,
  ``to_reference_dict``) give what the originals give;
* every parameter gets the JAX group id (through the exporter's key map),
  batches come in the JAX order, the controller gives the same per-group lr
  and trainable flags per epoch across the unfreeze and a plateau, and the
  grouped AdamW equals ``dmf_tpu.train.optim.adamw_update``;
* the train step follows ``make_single_train_step`` over 6 steps (3 with
  the backbone group frozen, 3 after its unfreeze; and without a backbone):
  loss, classification loss and gradient norms to rel 1e-3 per step, then
  the BatchNorm running statistics, the parameters and the eval logits;
  a toy ``hybrid-nb`` encoder's steps follow it too, with the transformer
  stage's fixed dropout on the same injected keep masks in both packages.
  Weights go JAX -> port through ``export_reference_encoder`` and
  ``load_reference_state_dict``, and back through
  ``import_reference_encoder``.  Dropout is 0 and both steps get the same
  processed batches: no random stream is shared between the frameworks.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_close, hybrid_cfg, jax_encoder, port_config,
                                port_encoder, resnet_layers, tiny_cfg, BACKBONE_LAYERS)

from dmf_tpu import config as jconfig
from dmf_tpu import train as jtrain
from dmf_tpu.data import pipeline as jpipe
from dmf_tpu.evals import metrics as jmetrics
from dmf_tpu.losses import get_classification_loss_fn as j_clf, get_mask_loss_fn as j_mask
from dmf_tpu.models.ref_ckpt import export_reference_encoder
from dmf_tpu.pipeline import paths as jpaths
from dmf_tpu.train import optim as joptim, schedule as jsched
from dmf_tpu.train.single import make_single_train_step as j_step
from dmf_tpu.utils import logging as jlog

from dmf_tpu_torch import config as pconfig
from dmf_tpu_torch.data import pipeline as ppipe
from dmf_tpu_torch.evals import metrics as pmetrics
from dmf_tpu_torch.losses import get_classification_loss_fn as p_clf, get_mask_loss_fn as p_mask
from dmf_tpu_torch.models import adapter as padapter, layers as players
from dmf_tpu_torch.models import transformer as ptransformer
from dmf_tpu_torch.models.weights import DROPPED_KEY_PATTERNS, canonical_key
from dmf_tpu_torch.pipeline import paths as ppaths
from dmf_tpu_torch.train import optim as poptim, schedule as psched
from dmf_tpu_torch.train.single import make_single_train_step as p_step
from dmf_tpu_torch.train.state import TrainState as PState
from dmf_tpu_torch.utils import checkpoint as pckpt, logging as plog

CHANNELS = 14
STEPS_PER_EPOCH = 3
B = 4


# ---------------------------------------------------------------- the copies
def test_to_reference_dict_matches_jax():
    for jcfg in (jconfig.default_parameters(), tiny_cfg(), jconfig.default_parameters(
            batch_size=8, foundation_model_unfreeze_timer=1, test_mode="tta")):
        assert pconfig.to_reference_dict(port_config(jcfg)) == jconfig.to_reference_dict(jcfg)


@pytest.mark.parametrize("name", ["reduce_lr_on_plateau", "cosine", "cosine_with_warmup"])
def test_schedulers_match_jax(name):
    sch = dataclasses.replace(jconfig.default_parameters().dwi_model.scheduler, name=name,
                              patience=2, warmup_steps=3, max_steps=20, t_max=7)
    js = jsched.make_scheduler(sch, 1e-4)
    ps = psched.make_scheduler(port_config(sch), 1e-4)
    assert type(ps).__name__ == type(js).__name__
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.9]
    for i, m in enumerate(metrics):
        if name == "reduce_lr_on_plateau":
            assert ps.step_reduced(m) == js.step_reduced(m)
            assert ps.scale == js.scale
        else:
            assert ps.step_scale(i) == js.step_scale(i)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_early_stopping_and_aux_weight_match_jax(mode):
    je, pe = jsched.EarlyStopping(mode, 3, 0.01), psched.EarlyStopping(mode, 3, 0.01)
    for m in [0.5, 0.6, 0.605, 0.59, 0.61, 0.4, 0.3, 0.2, 0.1]:
        assert pe.step(m) == je.step(m)
    for epoch in range(0, 130, 7):
        for enabled in (True, False):
            assert psched.aux_loss_weight(epoch, 100, enabled) == jsched.aux_loss_weight(
                epoch, 100, enabled)


@pytest.mark.parametrize("seed", [0, 1])
def test_classification_report_matches_jax(seed):
    r = np.random.RandomState(seed)
    probs = r.dirichlet(np.ones(4), size=37)
    probs[:5] = probs[5]  # ties in the AUROC ranks
    labels = r.randint(0, 4 if seed == 0 else 3, size=37)  # seed 1: a class absent
    assert (pmetrics.classification_report(probs, labels, 4, "val_")
            == jmetrics.classification_report(probs, labels, 4, "val_"))
    pm, jm = pmetrics.MeanMetric(), jmetrics.MeanMetric()
    for v, w in zip(r.rand(5), [1, 2, 3, 4, 5]):
        pm.update(v, w)
        jm.update(v, w)
    assert pm.compute() == jm.compute()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["multiclass_f1", "multiclass_precision",
                                  "multiclass_recall"])
def test_multiclass_metrics_match_jax(name, seed):
    """The macro F1 / precision / recall functions, a class absent at seed 1."""
    r = np.random.RandomState(seed)
    preds = r.randint(0, 4, size=37)
    labels = r.randint(0, 4 if seed == 0 else 3, size=37)
    assert getattr(pmetrics, name)(preds, labels, 4) == getattr(jmetrics, name)(preds, labels, 4)


def test_native_available_matches_jax():
    """``available()`` says whether the host library loads, in both packages
    (each builds its own copy with g++)."""
    from dmf_tpu.utils import native as jnative
    from dmf_tpu_torch.utils import native as pnative

    assert pnative.available() == jnative.available()


def test_logs_and_paths_match_jax(tmp_path):
    assert (ppaths.prepare_output_paths("dwi", 2, str(tmp_path / "p"))
            == {k: v.replace("/j/", "/p/") for k, v in
                jpaths.prepare_output_paths("dwi", 2, str(tmp_path / "j")).items()})
    metrics = {"train_loss": 0.5, "group_lrs": [1e-5, 2e-5, 3e-5], "val_acc": np.float32(0.25)}
    pl_, jl_ = plog.MetricLogger(str(tmp_path / "pl")), jlog.MetricLogger(
        str(tmp_path / "jl"), use_tensorboard=False)
    pl_.log_epoch(3, metrics)
    jl_.log_epoch(3, metrics)
    strip = [{k: v for k, v in r.items() if k != "time"} for r in (pl_.history[0], jl_.history[0])]
    assert strip[0] == strip[1]
    parameters = pconfig.to_reference_dict(pconfig.default_parameters())
    for mod, name in ((plog, "p.json"), (jlog, "j.json")):
        mod.save_metrics_json(str(tmp_path / name), metrics, {"test_acc": np.float64(0.5)},
                              parameters)
    assert json.load(open(tmp_path / "p.json")) == json.load(open(tmp_path / "j.json"))


# ---------------------------------------------------------------- batching
@pytest.mark.parametrize("n,bs", [(37, 8), (32, 8), (5, 8)])
def test_batch_order_matches_jax(n, bs):
    """Three epochs from one RandomState each: the same indices, a short tail."""
    jr, pr = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        ours = list(ppipe.batch_indices(n, bs, True, pr))
        theirs = list(jpipe.batch_indices(n, bs, True, jr, pad_to_batch=False))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    assert [len(i) for i in ppipe.batch_indices(n, bs, False)] == [len(i) for i in theirs]


def test_staged_batches_equal_host_batches():
    r = np.random.RandomState(0)
    ds = ppipe.ArrayDataset(imgs=r.rand(11, 4, 4, 2).astype(np.float32),
                            labels=r.randint(0, 4, 11), masks=None)
    assert "masks" not in ds.arrays
    host = list(ppipe.iterate_batches(ds, 4, shuffle=True, rng=np.random.RandomState(1)))
    staged = list(ppipe.iterate_batches(ds, 4, shuffle=True, rng=np.random.RandomState(1),
                                        device="cpu"))
    assert [len(b["labels"]) for b in staged] == [4, 4, 3]
    for h, s in zip(host, staged):
        for k in h:
            np.testing.assert_array_equal(h[k], s[k].numpy())
    assert not ppipe.device_data_auto(ds, "cpu") and ppipe.device_data_auto(ds, "cpu", True)


# ---------------------------------------------------------------- groups, optimizer, controller
def cfg_for(use_backbone):
    cfg = tiny_cfg(dropout=0.0, use_backbone=use_backbone)
    return cfg.replace(foundation_model_unfreeze_timer=1, batch_size=B)


def volumes(seed, n=B):
    r = np.random.RandomState(seed)
    return (r.rand(n, 32, 32, CHANNELS).astype(np.float32),
            (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32),
            r.randint(0, 4, size=n).astype(np.int64))


@pytest.fixture(scope="module", params=[True, False], ids=["backbone", "no_backbone"])
def models(request):
    jcfg = cfg_for(request.param)
    x = volumes(0)[0]
    jm, v = jax_encoder(jcfg.dwi_model, CHANNELS, x, seed=4)
    return jcfg, jm, v


def port_only_params(use_backbone):
    """The alpha-blend scalars and norms the port (and the reference) holds
    where the JAX model without a backbone has none (ref_ckpt.py:444-449)."""
    return [] if use_backbone else sorted(["f2_weight", "f3_weight", "norm_f2.weight",
                                           "norm_f2.bias", "norm_f3.weight", "norm_f3.bias"])


def test_group_ids_match_jax(models):
    """Each JAX leaf filled with its group id (+10), exported and loaded:
    every port parameter that comes from a JAX leaf holds its JAX group."""
    jcfg, _, v = models
    mc = jcfg.dwi_model
    jspec = jtrain.build_group_spec(v["params"], mc.use_backbone, True)
    filled = {"params": jax.tree.map(lambda leaf, gid: np.full(np.shape(leaf), gid + 10.0,
                                                               np.float32),
                                     v["params"], jspec.group_ids),
              "batch_stats": v["batch_stats"]}
    enc, _ = port_encoder(mc, CHANNELS, filled)
    pspec = poptim.build_group_spec([n for n, _ in enc.named_parameters()], mc.use_backbone)
    port_only = []
    for name, p in enc.named_parameters():
        vals = set(np.unique(p.detach().numpy()).tolist())
        if vals <= {9.0, 10.0, 11.0, 12.0} and len(vals) == 1:
            assert pspec.group_ids[name] == vals.pop() - 10, name
        else:
            port_only.append(name)
    assert sorted(port_only) == port_only_params(mc.use_backbone)
    assert sum(g == -1 for g in pspec.group_ids.values()) == 2  # classification_head


def test_adamw_matches_jax():
    """Three steps over named leaves in every group: a frozen one (its
    count and moments stay), an excluded one, then the frozen group joined."""
    r = np.random.RandomState(5)
    shapes = {"backbone": (3, 4), "block1": (5,), "block3": (2, 2, 3), "classification_head": (4,)}
    params = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jparams = {k: {"w": jnp.asarray(v)} for k, v in params.items()}
    jspec = jtrain.build_group_spec(jparams, True, True)
    jstate = jtrain.adamw_init(jparams)
    pparams = {f"{k}.w": torch.from_numpy(v.copy()) for k, v in params.items()}
    pspec = poptim.build_group_spec(list(pparams), True)
    pstate = poptim.adamw_init(pparams)
    for step in range(4):
        trainable = np.array([0.0 if step < 2 else 1.0, 1.0, 1.0], np.float32)
        lr = np.array([1e-3, 2e-3, 5e-4], np.float32)
        wd = np.array([0.0, 1e-2, 1e-3], np.float32)
        grads = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jparams, jstate = jtrain.adamw_update(
            {k: {"w": jnp.asarray(g)} for k, g in grads.items()}, jstate, jparams, jspec,
            jtrain.GroupedHyperParams(jnp.asarray(lr), jnp.asarray(wd), jnp.asarray(trainable)))
        poptim.adamw_update(pparams, {f"{k}.w": torch.from_numpy(g) for k, g in grads.items()},
                            pstate, pspec, poptim.GroupedHyperParams(lr, wd, trainable))
        for k in shapes:
            np.testing.assert_allclose(pparams[f"{k}.w"].numpy(), np.asarray(jparams[k]["w"]),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(pstate.count, np.asarray(jstate.count)[:3])
    np.testing.assert_array_equal(pparams["classification_head.w"].numpy(),
                                  params["classification_head"])


@pytest.mark.parametrize("use_backbone", [True, False])
def test_controller_matches_jax(use_backbone):
    """lr and trainable flags per epoch across the unfreeze (epoch 2) and
    plateau reductions before and after it (patience 1)."""
    jcfg = jconfig.default_parameters(foundation_model_unfreeze_timer=2)
    sch = dataclasses.replace(jcfg.dwi_model.scheduler, patience=1, factor=0.5, min_lr=2e-6)
    jcfg = jcfg.replace(dwi_model=dataclasses.replace(jcfg.dwi_model, scheduler=sch,
                                                      use_backbone=use_backbone))
    pcfg = port_config(jcfg)
    jc, pc = jtrain.SingleModelOptController(jcfg, "dwi"), poptim.SingleModelOptController(
        pcfg, "dwi")
    js, ps = jsched.make_scheduler(sch, 1e-4), psched.make_scheduler(port_config(sch), 1e-4)
    for epoch, metric in enumerate([1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5]):
        jc.on_epoch_start(epoch)
        pc.on_epoch_start(epoch)
        jh, ph = jc.hyperparams(), pc.hyperparams()
        for f in ("lr", "wd", "trainable"):
            np.testing.assert_array_equal(getattr(ph, f), np.asarray(getattr(jh, f)), err_msg=f)
        if js.step_reduced(metric):
            jc.apply_plateau(js.factor, js.min_lr)
        if ps.step_reduced(metric):
            pc.apply_plateau(ps.factor, ps.min_lr)
    assert not use_backbone or ph.trainable[0] == 1.0


def test_train_route_calls_no_kernel_wrapper(models, monkeypatch):
    """``train=True`` never reaches kernels 1, 2 or 6 (on the card they would
    raise under autograd); the eval route does."""
    jcfg, _, v = models
    enc, _ = port_encoder(jcfg.dwi_model, CHANNELS, v)
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
    x = torch.from_numpy(volumes(1)[0]).permute(0, 3, 1, 2)
    enc(x, train=True)[0].sum().backward()
    assert calls == []
    with torch.no_grad():
        enc(x)
    assert {"se_epilogue", "se_scale"} <= set(calls)
    assert ("conv3x3_bn_gelu" in calls) == jcfg.dwi_model.use_backbone


# ---------------------------------------------------------------- the trajectory
def batches():
    return [dict(zip(("imgs", "masks", "labels"), volumes(10 + i)))
            for i in range(2 * STEPS_PER_EPOCH)]


def run_jax(jcfg, model, variables, data, train_labels):
    state = jtrain.TrainState.create(jax.tree.map(jnp.asarray, variables))
    spec = jtrain.build_group_spec(state.params, jcfg.dwi_model.use_backbone, True)
    step = j_step(jcfg, "dwi", model, j_clf(jcfg, train_labels, "dwi"), j_mask(jcfg, "dwi"),
                  spec, donate=False)
    ctrl = jtrain.SingleModelOptController(jcfg, "dwi")
    records = []
    for i, b in enumerate(data):
        epoch = i // STEPS_PER_EPOCH
        if i % STEPS_PER_EPOCH == 0:
            ctrl.on_epoch_start(epoch)
            hp = ctrl.hyperparams()
        aux_w = jsched.aux_loss_weight(epoch, jcfg.aux_loss_weight_epoch_limit)
        state, m = step(state, {"imgs": jnp.asarray(b["imgs"]), "masks": jnp.asarray(b["masks"]),
                                "labels": jnp.asarray(b["labels"], jnp.int32),
                                "aux_w": jnp.asarray(aux_w, jnp.float32)},
                        jax.random.PRNGKey(i), hp)
        records.append({k: float(v) for k, v in m.items()})
    return state, records


def run_port(jcfg, variables, data, train_labels, enc=None):
    """The port's steps from ``variables`` (or from ``enc``, a port encoder
    already holding them)."""
    pcfg = port_config(jcfg)
    if enc is None:
        enc, _ = port_encoder(jcfg.dwi_model, CHANNELS, variables)
    state = PState.create(enc)
    spec = poptim.build_group_spec([n for n, _ in enc.named_parameters()],
                                   pcfg.dwi_model.use_backbone)
    step = p_step(pcfg, "dwi", p_clf(pcfg, train_labels, "dwi"), p_mask(pcfg, "dwi"), spec)
    ctrl = poptim.SingleModelOptController(pcfg, "dwi")
    records = []
    for i, b in enumerate(data):
        epoch = i // STEPS_PER_EPOCH
        if i % STEPS_PER_EPOCH == 0:
            ctrl.on_epoch_start(epoch)
            hp = ctrl.hyperparams()
        batch = {"imgs": torch.from_numpy(b["imgs"]), "masks": torch.from_numpy(b["masks"]),
                 "labels": torch.from_numpy(b["labels"]),
                 "aux_w": psched.aux_loss_weight(epoch, pcfg.aux_loss_weight_epoch_limit)}
        records.append({k: float(v) for k, v in step(state, batch, None, hp).items()})
    return state, records


def port_keyed(sd):
    """A reference-layout export keyed as the port holds it: the backbone
    once, under ``backbone.`` (``load_reference_state_dict``'s mapping)."""
    return {canonical_key(k): v for k, v in sd.items()
            if not DROPPED_KEY_PATTERNS[0].search(k)}


@pytest.fixture(scope="module")
def trajectories(models):
    jcfg, jm, v = models
    data = batches()
    train_labels = np.concatenate([b["labels"] for b in data])
    jstate, jrec = run_jax(jcfg, jm, v, data, train_labels)
    pstate, prec = run_port(jcfg, v, data, train_labels)
    with resnet_layers(BACKBONE_LAYERS):
        start, final = (port_keyed(export_reference_encoder(t))
                        for t in (v, jstate.variables))
    return jcfg, jm, v, data, jstate, jrec, pstate, prec, start, final


def test_loss_trajectory_matches_jax(trajectories):
    jcfg, _, _, _, _, jrec, pstate, prec, _, _ = trajectories
    keys = ["loss", "clf_loss", "mask_loss", "recon_loss", "mimic_loss", "grad_norm"]
    keys += [k for k in jrec[0] if k.startswith("grad_norm_")]
    for k in keys:
        np.testing.assert_allclose([r[k] for r in prec], [r[k] for r in jrec], rtol=1e-3,
                                   err_msg=k)
    assert all(r["grad_nonfinite"] == 0 for r in prec)
    # the backbone group is frozen for 3 steps, then trains from its own step 1
    expect = [STEPS_PER_EPOCH, 2 * STEPS_PER_EPOCH, 2 * STEPS_PER_EPOCH]
    if jcfg.dwi_model.use_backbone:
        expect[0] = STEPS_PER_EPOCH
    else:
        expect = [2 * STEPS_PER_EPOCH] * 3
    assert pstate.opt_state.count.tolist() == expect
    assert pstate.step == 2 * STEPS_PER_EPOCH


def test_bn_running_stats_match_jax(trajectories):
    """Batch statistics in every BatchNorm (the frozen backbone's too), in
    the reference key layout."""
    *_, pstate, _, start, final = trajectories
    stats = {k: t for k, t in pstate.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats
    for k, t in stats.items():
        assert_close(t, final[k], rtol=1e-3, what=k)
        assert not np.allclose(final[k], start[k]), k


def test_params_after_steps_match_jax(trajectories):
    """Each group's update to rel 5e-2 in L2; the frozen classification head
    unchanged.  AdamW divides each gradient element by its own scale, so its
    first steps move an element by about +-lr whatever the gradient's size:
    an element whose gradient is below the fp32 sum-order noise of the two
    frameworks moves either way (the backbone group measured 1.4e-2 here).
    The losses, statistics and logits above and below hold to 1e-3."""
    jcfg, *_, pstate, _, start, final = trajectories
    spec = poptim.build_group_spec([n for n, _ in pstate.model.named_parameters()],
                                   jcfg.dwi_model.use_backbone)
    diff, upd = {}, {}
    for name, p in pstate.model.named_parameters():
        if name in port_only_params(jcfg.dwi_model.use_backbone):
            assert torch.equal(p.detach(), torch.from_numpy(start[name]))  # no gradient
            continue
        gid = spec.group_ids[name]
        ours, theirs, s0 = (np.asarray(a, np.float64) for a in (p.detach(), final[name], start[name]))
        diff[gid] = diff.get(gid, 0.0) + ((ours - theirs) ** 2).sum()
        upd[gid] = upd.get(gid, 0.0) + ((theirs - s0) ** 2).sum()
    assert sorted(diff) == [-1, 0, 1, 2]
    for gid in sorted(diff):
        if gid < 0:
            assert diff[gid] == 0 and upd[gid] == 0
        else:
            assert np.sqrt(diff[gid] / upd[gid]) < 5e-2, (gid, np.sqrt(diff[gid] / upd[gid]))


def test_eval_logits_after_steps_match_jax(trajectories):
    jcfg, jm, _, data, jstate, _, pstate, *_ = trajectories
    x = data[0]["imgs"]
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False)[0])(
        jstate.variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = pstate.model(torch.from_numpy(x).permute(0, 3, 1, 2))[0]
    assert_close(ours, ref, rtol=1e-3)


def test_checkpoint_round_trip(trajectories, tmp_path):
    """The best checkpoint restores weights, statistics, moments, counts and
    the step into a fresh state; a reference-layout ``.pth`` its weights."""
    jcfg, _, v, _, _, _, pstate, *_ = trajectories
    ck = pckpt.BestCheckpointer(str(tmp_path))
    assert ck.maybe_save(pstate, {"val_acc": 0.5}, 3)
    assert not ck.maybe_save(pstate, {"val_acc": 0.4}, 4)
    fresh = PState.create(port_encoder(jcfg.dwi_model, CHANNELS, v)[0])
    pckpt.load_checkpoint(ck.best_path, fresh)
    for (k, a), b in zip(pstate.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k, a in pstate.opt_state.nu.items():
        assert torch.equal(a, fresh.opt_state.nu[k])
    assert fresh.opt_state.count.tolist() == pstate.opt_state.count.tolist()
    assert fresh.step == pstate.step
    assert json.load(open(tmp_path / "best.json")) == {"epoch": 3, "val_acc": 0.5}
    with resnet_layers(BACKBONE_LAYERS):
        torch.save({"state_dict": {f"model.{k}": torch.from_numpy(np.array(t)) for k, t in
                                   export_reference_encoder(v).items()}}, tmp_path / "ref.ckpt")
    pckpt.load_checkpoint(str(tmp_path / "ref.ckpt"), fresh)
    ref = port_encoder(jcfg.dwi_model, CHANNELS, v)[0].state_dict()
    for k, t in fresh.model.state_dict().items():
        assert torch.equal(t, ref[k]), k
    assert os.path.exists(ck.best_path)


def test_init_single_state_is_seeded(models):
    """Fresh weights from the seed (the JAX initializers), zero moments and
    counts; the same seed twice gives the same weights."""
    from dmf_tpu_torch.train.loop import init_single_state

    jcfg, _, v = models
    a = init_single_state(port_encoder(jcfg.dwi_model, CHANNELS, v)[0], seed=3)
    b = init_single_state(port_encoder(jcfg.dwi_model, CHANNELS, v)[0], seed=3)
    ref = port_encoder(jcfg.dwi_model, CHANNELS, v)[0].state_dict()
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["block1.bottlenecks.0.0.weight"], ref["block1.bottlenecks.0.0.weight"])
    assert a.step == 0 and a.opt_state.count.tolist() == [0, 0, 0]
    assert all(float(t.abs().sum()) == 0 for t in a.opt_state.mu.values())


# ---------------------------------------------------------------- hybrid-nb
def keep_mask(site, shape, p=0.1):
    """The keep mask of dropout site ``site`` of a forward, from numpy."""
    return np.random.RandomState(100 + site).rand(*shape) < (1.0 - p)


@pytest.fixture(scope="module")
def hybrid_trajectories():
    """A toy ``hybrid-nb`` encoder (``hybrid_cfg``: no backbone, two
    transformer blocks of embed 32 on 64 tokens) trained 6 steps by both
    packages.  The ResLite dropout is 0 through the config; the stage's
    attention, projection and MLP dropout is fixed at 0.1
    (transformer.py:28-29, :45-56) and no config field reaches it, so both
    packages get the same keep masks: the k-th dropout call of a forward
    (4 per block: the attention weights, the projection, the MLP's two) takes
    ``keep_mask(k)`` of its shape, through ``jax.random.bernoulli`` as flax's
    Dropout calls it (the jitted step traces one forward, so its masks are
    constants of the trace) and through the port's ``transformer.dropout``,
    patched here only.  The weights route (no flash kernel) in both.

    The JAX grouping is patched too: its substring rule puts the stage's
    second block (Flax path ``transformer/block1``) in the ``block1`` group,
    where the reference's module names (``transformer.layers.1``) and the
    port put it in group 2 (:func:`test_hybrid_groups_follow_the_reference_names`)."""
    jcfg = hybrid_cfg(dropout=0.0).replace(foundation_model_unfreeze_timer=1, batch_size=B)
    sites = 4 * jcfg.dwi_model.transformer_depth
    calls = {"jax": 0, "port": 0}

    def bernoulli(key, p=0.5, shape=None):
        assert abs(float(p) - 0.9) < 1e-6
        calls["jax"] += 1
        return jnp.asarray(keep_mask((calls["jax"] - 1) % sites, shape))

    def dropout(x, p, generator):
        if p <= 0.0:
            return x
        calls["port"] += 1
        keep = torch.from_numpy(keep_mask((calls["port"] - 1) % sites, tuple(x.shape), p))
        return torch.where(keep, x / (1.0 - p), 0.0)

    data = batches()
    train_labels = np.concatenate([b["labels"] for b in data])
    jm, v = jax_encoder(jcfg.dwi_model, CHANNELS, data[0]["imgs"], seed=9)
    jax_classify = joptim.classify_param

    def reference_groups(name, use_backbone):
        return 2 if name.startswith("transformer/block") else jax_classify(name, use_backbone)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        mp.setattr(ptransformer, "dropout", dropout)
        mp.setattr(joptim, "classify_param", reference_groups)
        jstate, jrec = run_jax(jcfg, jm, v, data, train_labels)
        pstate, prec = run_port(jcfg, v, data, train_labels)
    return sites, calls, jrec, prec


def test_hybrid_loss_trajectory_matches_jax(hybrid_trajectories):
    """ROADMAP fault 3.8: losses and per-group gradient norms to rel 1e-3
    per step; the masks were drawn at every site of every forward."""
    sites, calls, jrec, prec = hybrid_trajectories
    assert calls["jax"] % sites == 0 and calls["jax"] > 0
    assert calls["port"] == sites * len(prec)
    keys = ["loss", "clf_loss", "mask_loss", "recon_loss", "mimic_loss", "grad_norm"]
    keys += [k for k in jrec[0] if k.startswith("grad_norm_")]
    for k in keys:
        np.testing.assert_allclose([r[k] for r in prec], [r[k] for r in jrec], rtol=1e-3,
                                   err_msg=k)
    assert all(r["grad_nonfinite"] == 0 for r in prec)


def test_hybrid_groups_follow_the_reference_names():
    """The port groups the hybrid stage by the reference's names: both
    transformer blocks in group 2 (``block3+other``).  The JAX package's
    substring rule on Flax paths puts ``transformer/block1`` (the second
    block) in the ``block1`` group instead, the first block in group 2."""
    jcfg = hybrid_cfg(dropout=0.0)
    jm, v = jax_encoder(jcfg.dwi_model, CHANNELS, volumes(0)[0], seed=9)
    jspec = jtrain.build_group_spec(v["params"], False, True)
    jgroups = {(path[0].key, int(g)) for path, g in
               jax.tree_util.tree_flatten_with_path(jspec.group_ids["transformer"])[0]
               if path[0].key.startswith("block")}
    assert jgroups == {("block0", 2), ("block1", 0)}
    enc, _ = port_encoder(jcfg.dwi_model, CHANNELS, v)
    pspec = poptim.build_group_spec([n for n, _ in enc.named_parameters()], False)
    stage = {g for n, g in pspec.group_ids.items() if n.startswith("transformer.")}
    assert stage == {2}
