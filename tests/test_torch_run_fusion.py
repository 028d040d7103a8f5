"""The port's whole fold vs the JAX package's, fp32 on the CPU, at toy
geometry (32^2, channels (8, 16, 32), the (1, 1, 1, 1) ResNet-50 of
``test_torch_helpers``, fusion channels 16), on a synthetic store of 32 + 8
volumes (fold 0 of 4: 26 train, 6 validation).

* the port's fold: ``run_single_model`` for DWI and for DCE (the backbone
  frozen in epoch 0, trained in epoch 1), then ``run_fusion_model`` over
  their results for 3 epochs with ``unfreeze_timer=1`` (two unfreezes):
  the control plane, the files (checkpoints, logs, ``metrics.json``, the
  per-fold store, the processed splits), the ``tta_mc`` test's invariants,
  the best checkpoint's reload, the debug prints, and both single-model
  states left bit-equal;
* ``test_fusion_model`` equals JAX's in ``normal`` and ``tta`` on the same
  weights (a ragged last batch included), rel 1e-4;
* ``run_fusion_model`` beside the JAX run on the same processed splits:
  the same ``metrics.json`` keys and ``parameters`` block, per epoch the same
  group lrs and trainable flags, the same first-batch input statistics;
* ``run_single_model("dce")`` beside the JAX run as
  ``test_torch_run_single`` holds DWI.

Values of whole runs differ between the packages: dropout (and the single
runs' augmentation) draw from each framework's own random stream.  The JAX
runs use encoders without a backbone and ``normal`` or ``tta`` tests to keep
their XLA compiles short; the port's ``tta_mc`` and backbone runs are
checked on their own.
"""

import contextlib
import io
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_close, fusion_stack, jax_encoder, port_config,
                                port_encoder, tiny_cfg)

from dmf_tpu import train as jtrain
from dmf_tpu.config import to_reference_dict
from dmf_tpu.data.synthetic import make_synthetic_arrays
from dmf_tpu.evals import metrics as jmetrics
from dmf_tpu.pipeline import prepare_single_data as j_prepare, run_single_model as j_run
from dmf_tpu.pipeline import run_fusion as jrun_fusion
from dmf_tpu.utils import visualize
from dmf_tpu_torch.pipeline import prepare_single_data as p_prepare, run_single_model as p_run
from dmf_tpu_torch.pipeline import run_fusion as prun_fusion
from dmf_tpu_torch.train.fusion import FusionNetwork
from dmf_tpu_torch.train.state import TrainState as PState
from dmf_tpu_torch.utils.checkpoint import load_checkpoint

CHANNELS = {"dwi": 14, "dce": 6}
FUSION_EPOCHS = 3


def store_cfg(base, use_backbone, batch_size, dropout=0.1):
    cfg = tiny_cfg(dropout=dropout, mc_passes=2, use_backbone=use_backbone)
    return cfg.replace(batch_size=batch_size, segnum=4, foundation_model_unfreeze_timer=1,
                       unfreeze_timer=1, base_path=str(base / "data"))


def raw_store(method):
    raw = make_synthetic_arrays(n_train=32, n_test=8, image_size=32, seed=2)
    return {"imgs": raw[method], "test_imgs": raw[f"{method}_test"], "labels": raw["labels"],
            "test_labels": raw["labels_test"], "masks": raw["masks"]}


def snapshot(state):
    o = state.opt_state
    return ({k: t.clone() for k, t in state.model.state_dict().items()},
            {k: t.clone() for k, t in o.mu.items()}, {k: t.clone() for k, t in o.nu.items()},
            o.count.copy(), state.step)


def same(a, b):
    return (all(torch.equal(a[i][k], b[i][k]) for i in range(3) for k in a[i])
            and np.array_equal(a[3], b[3]) and a[4] == b[4])


@pytest.fixture(scope="module")
def port_fold(tmp_path_factory):
    """The port's fold: DWI and DCE single runs with the backbone (B=8: a
    short tail batch of 2 each epoch), then the fusion run over them."""
    base = tmp_path_factory.mktemp("fold")
    cfg = port_config(store_cfg(base, use_backbone=True, batch_size=8))
    out, log = {}, io.StringIO()
    with contextlib.redirect_stdout(log):
        for m in ("dwi", "dce"):
            _, v = jax_encoder(store_cfg(base, True, 8).model_config(m), CHANNELS[m],
                               np.zeros((2, 32, 32, CHANNELS[m]), np.float32), seed=9)
            enc = port_encoder(store_cfg(base, True, 8).model_config(m), CHANNELS[m], v)[0]
            out[m] = p_run(cfg, m, 0, data=p_prepare(cfg, m, 0, raw=raw_store(m), device="cpu"),
                           state=PState.create(enc), num_epochs=2, min_epochs=2,
                           base_dir=str(base / "results"), device="cpu")
        before = {m: snapshot(out[m]["state"]) for m in ("dwi", "dce")}
        fus = prun_fusion.run_fusion_model(cfg, 0, out["dwi"], out["dce"],
                                           num_epochs=FUSION_EPOCHS, min_epochs=FUSION_EPOCHS,
                                           base_dir=str(base / "results"))
    return cfg, base, out, before, fus, log.getvalue()


def test_run_fusion_leaves_single_states_unchanged(port_fold):
    """The fusion network trains copies: the DWI and DCE results' states
    (weights, statistics, moments, counts, step) are bit-equal after it."""
    _, _, out, before, fus, _ = port_fold
    for m in ("dwi", "dce"):
        assert same(snapshot(out[m]["state"]), before[m]), m
        assert fus["state"].model.dwi is not out[m]["state"].model
    moved = [k for k, t in fus["final_state"].model.dwi.state_dict().items()
             if not torch.equal(t, before["dwi"][0][k])]
    assert moved  # the copy trained


def test_run_fusion_fold(port_fold):
    """Two unfreezes (groups 2 then 1), the files, the ``tta_mc`` test's
    invariants, the per-fold store, and the best checkpoint's reload."""
    cfg, base, _, _, fus, _ = port_fold
    hist = fus["history"]
    assert [h["group_trainable"] for h in hist] == [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0],
                                                    [0.0, 1.0, 1.0, 1.0]]
    steps = -(-26 // cfg.batch_size)
    assert fus["final_state"].opt_state.count.tolist() == [0, steps, 2 * steps, 3 * steps]
    root = base / "results" / "fusion" / "fold_0"
    for rel in ("checkpoints/best.pt", "checkpoints/best.json", "checkpoints/last.pt",
                "checkpoints/fusion_fold0.pt", "logs/metrics.jsonl", "metrics.json"):
        assert (root / rel).exists(), rel
    stored = torch.load(root / "checkpoints" / "fusion_fold0.pt", weights_only=True)
    best = dict(fus["state"].model.named_parameters())
    assert set(stored) == set(best) and all(torch.equal(stored[k], best[k]) for k in best)
    probs, std = fus["test_probs"], fus["test_std"]
    assert probs.shape == (8, cfg.class_num) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    assert (std > 0).all()
    assert fus["modality_attention"].shape == (1, 2)  # one test batch, two modalities
    assert all(np.isfinite(v) for v in fus["test_metrics"].values())
    final = fus["final_state"]
    x = (torch.rand(2, 14, 32, 32, generator=torch.Generator().manual_seed(5)),
         torch.rand(2, 6, 32, 32, generator=torch.Generator().manual_seed(6)))
    load_checkpoint(fus["best_checkpoint"], final)
    with torch.no_grad():
        assert torch.equal(final.model(*x)[0], fus["state"].model(*x)[0])


def test_run_fusion_debug_prints(port_fold):
    """Under ``debug_training`` each of the three fits prints its group dump
    and its first batch's input statistics."""
    *_, log = port_fold
    assert log.count("optimizer groups:") == 3 and log.count("[DEBUG] Input Stats") == 3
    assert "group 3 (fusion_head)" in log


def test_run_single_dce_with_backbone(port_fold):
    """The DCE run as ``test_torch_run_single`` checks DWI's: the backbone
    frozen then trained, the files, the test ensemble, the modality
    attention over 6 channels, the processed splits and the best reload."""
    cfg, base, out, *_ = port_fold
    res = out["dce"]
    assert [h["group_trainable"] for h in res["history"]] == [[0.0, 1.0, 1.0], [1.0] * 3]
    steps = -(-len(res["data"].splits["train"]["labels"]) // cfg.batch_size)
    assert res["final_state"].opt_state.count.tolist() == [steps, 2 * steps, 2 * steps]
    root = base / "results" / "dce" / "fold_0"
    for rel in ("checkpoints/best.pt", "checkpoints/last.pt", "logs/metrics.jsonl",
                "metrics.json"):
        assert (root / rel).exists(), rel
    np.testing.assert_allclose(res["test_probs"].sum(-1), 1.0, rtol=1e-5)
    assert (res["test_std"] > 0).all()
    assert res["modality_attention"].shape[-1] == CHANNELS["dce"]
    for split in ("train", "val", "test"):
        assert os.path.exists(os.path.join(cfg.base_path, "processed", f"dce0{split}data.npz"))
    final = res["final_state"]
    x = torch.rand(2, 6, 32, 32, generator=torch.Generator().manual_seed(5))
    load_checkpoint(res["best_checkpoint"], final)
    with torch.no_grad():
        assert torch.equal(final.model(x)[0], res["state"].model(x)[0])


# ---------------------------------------------------------------- beside the JAX package
def jax_state(jvars):
    params = {m: v["params"] for m, v in zip(("dwi", "dce", "fusion"), jvars)}
    stats = {m: v["batch_stats"] for m, v in zip(("dwi", "dce", "fusion"), jvars)}
    return jtrain.TrainState(params=params, batch_stats=stats,
                             opt_state=jtrain.adamw_init(params), step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def nb_stack(port_fold):
    """Encoders without a backbone and the fusion head, both packages, on the
    same weights; the fold's processed splits."""
    cfg = store_cfg(port_fold[1], use_backbone=False, batch_size=3, dropout=0.2)
    fd = prun_fusion.prepare_fusion_data(port_config(cfg), 0)
    jmods, jvars, pmods = fusion_stack(cfg, fd["train"]["dwi"][:2], fd["train"]["dce"][:2],
                                       seeds=(21, 22, 23))
    return cfg, fd, jmods, jvars, pmods


@pytest.mark.parametrize("mode", ["normal", "tta"])
def test_test_fusion_model_matches_jax(nb_stack, mode):
    """8 test volumes in batches of 3 (JAX pads the last, the port runs it
    short): probabilities, metrics and modality attention."""
    cfg, fd, jmods, jvars, pmods = nb_stack
    cfg = cfg.replace(test_mode=mode)
    theirs = jrun_fusion.test_fusion_model(cfg, *jmods, jax_state(jvars), fd["test"], seed=0)
    ours = prun_fusion.test_fusion_model(port_config(cfg), PState.create(FusionNetwork(*pmods)),
                                         fd["test"], seed=0)
    assert_close(ours["probs"], theirs["probs"], what="probs")
    np.testing.assert_array_equal(ours["labels"], theirs["labels"])
    assert_close(ours["modality_attention"], theirs["modality_attention"], what="attention")
    assert set(ours["metrics"]) == set(theirs["metrics"])
    # random weights leave the samples' probabilities within ~1e-7 of each
    # other, so the AUC's ranks are rounding: it is held as JAX's report on
    # the port's probabilities, every other metric against JAX's run
    report = jmetrics.classification_report(ours["probs"], ours["labels"], cfg.class_num,
                                            "test_")
    assert ours["metrics"]["test_roc_auc"] == report["test_roc_auc"]
    for k, v in theirs["metrics"].items():
        if k not in ("test_time_sec", "test_roc_auc"):
            np.testing.assert_allclose(ours["metrics"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_test_fusion_model_tta_mc(nb_stack):
    """``tta_mc`` with dropout 0.2: probabilities finite and summing to 1, MC
    std > 0, the modality attention in JAX's shape (a row a batch, one
    column a modality); the same with int8 serving, calibrated on the
    validation split (``tests/test_torch_quant.py`` holds it against JAX)."""
    cfg, fd, _, _, pmods = nb_stack
    pcfg = port_config(cfg.replace(test_mode="tta_mc"))
    state = PState.create(FusionNetwork(*pmods))
    res = prun_fusion.fusion_model_test(pcfg, state, fd["test"], seed=1)
    assert np.isfinite(res["probs"]).all()
    np.testing.assert_allclose(res["probs"].sum(-1), 1.0, rtol=1e-5)
    assert (res["std"] > 0).all() and res["metrics"]["test_uncertainty_mean"] > 0
    assert res["modality_attention"].shape == (3, 2)
    res8 = prun_fusion.test_fusion_model(pcfg, state, fd["test"], seed=1, int8=True,
                                         calibration_data=fd["val"])
    assert np.isfinite(res8["probs"]).all() and res8["probs"].shape == res["probs"].shape
    np.testing.assert_allclose(res8["probs"].sum(-1), 1.0, rtol=1e-5)
    assert (res8["std"] > 0).all()


def run_beside(jax_run, port_run):
    """Both packages' runs with stdout captured; the JAX loop's mask figure
    (matplotlib, not ported: ROADMAP 1.7) is stubbed, it writes no metric."""
    logs = []
    results = []
    for fn in (jax_run, port_run):
        buf = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
            mp.setattr(visualize, "visualize_mask_triplet", lambda *a, **k: None)
            results.append(fn())
        logs.append(buf.getvalue())
    return results, logs


@pytest.fixture(scope="module")
def fusion_runs(nb_stack, tmp_path_factory):
    """Both packages' ``run_fusion_model`` on the fold's processed splits;
    B=13: two full train batches (one JAX step shape); the test in
    ``normal``, the cheapest JAX compile (the modes are held above)."""
    cfg, fd, (jd, jc, _), (vd, vc, _), (pd, pc, _) = nb_stack
    base = tmp_path_factory.mktemp("fusion_runs")
    cfg = cfg.replace(batch_size=13, test_mode="normal")
    jres = {"dwi": {"model": jd, "state": jtrain.TrainState.create(vd)},
            "dce": {"model": jc, "state": jtrain.TrainState.create(vc)}}
    pres = {"dwi": {"state": PState.create(pd)}, "dce": {"state": PState.create(pc)}}
    kw = dict(fusion_data=fd, num_epochs=FUSION_EPOCHS, min_epochs=1)
    (theirs, ours), logs = run_beside(
        lambda: jrun_fusion.run_fusion_model(cfg, 0, jres["dwi"], jres["dce"],
                                             base_dir=str(base / "jax"), **kw),
        lambda: prun_fusion.run_fusion_model(port_config(cfg), 0, pres["dwi"], pres["dce"],
                                             base_dir=str(base / "port"), **kw))
    return cfg, base, theirs, ours, logs


def test_run_fusion_metrics_json_matches_jax(fusion_runs):
    cfg, base, *_ = fusion_runs
    ours, theirs = (json.load(open(base / pkg / "fusion" / "fold_0" / "metrics.json"))
                    for pkg in ("port", "jax"))
    assert set(ours) == set(theirs) == {"train_metrics", "test_metrics", "parameters"}
    assert set(ours["train_metrics"]) == set(theirs["train_metrics"])
    assert set(ours["test_metrics"]) == set(theirs["test_metrics"])
    assert ours["parameters"] == theirs["parameters"] == json.loads(
        json.dumps(to_reference_dict(cfg)))
    assert all(np.isfinite(v) for v in ours["test_metrics"].values())


def test_run_fusion_control_plane_matches_jax(fusion_runs):
    """Per epoch the metric keys, group lrs and trainable flags, aux weight
    and lr scale; the group dumps' lr / wd / trainable; the first batch's
    input statistics line for line (the same shuffle, the same data)."""
    _, _, theirs, ours, (jlog, plog) = fusion_runs
    assert len(ours["history"]) == len(theirs["history"]) == FUSION_EPOCHS
    for a, b in zip(ours["history"], theirs["history"]):
        assert set(a) == set(b)
        assert a["group_trainable"] == b["group_trainable"]
        np.testing.assert_allclose(a["group_lrs"], b["group_lrs"], rtol=1e-7)
        assert a["aux_w"] == b["aux_w"] and a["lr_scale"] == b["lr_scale"]
    assert ours["history"][-1]["group_trainable"] == [0.0, 1.0, 1.0, 1.0]
    assert set(ours) >= set(theirs) - {"best_checkpoint"}

    def hp_lines(log):
        return re.findall(r"group \d \((\S+)\): .*(lr=\S+ wd=\S+ trainable=\d)", log)

    def stats_lines(log):
        return [ln for ln in log.splitlines() if ln.startswith("[DEBUG]")]

    assert hp_lines(plog) == hp_lines(jlog) and len(hp_lines(plog)) == 4
    assert stats_lines(plog) == stats_lines(jlog) and len(stats_lines(plog)) == 2


@pytest.fixture(scope="module")
def dce_runs(tmp_path_factory):
    """Both packages' ``run_single_model("dce")`` on one store and the same
    weights (the encoder without a backbone, B=13, ``tta``); each fits its
    own Nyul landmarks (exact, the same formula)."""
    base = tmp_path_factory.mktemp("dce_runs")
    raw = raw_store("dce")
    _, v = jax_encoder(store_cfg(base, False, 13).dce_model, 6,
                       np.zeros((2, 32, 32, 6), np.float32), seed=9)
    jm, _ = jax_encoder(store_cfg(base, False, 13).dce_model, 6,
                        np.zeros((2, 32, 32, 6), np.float32))

    def cfg_at(pkg):
        return store_cfg(base / pkg, use_backbone=False, batch_size=13).replace(test_mode="tta")

    def jax_run():
        cfg = cfg_at("jax")
        return j_run(cfg, "dce", 0, data=j_prepare(cfg, "dce", 0, raw=raw), model=jm,
                     variables=v, num_epochs=2, min_epochs=1,
                     base_dir=str(base / "jax" / "results"), export_splits=False)

    def port_run():
        cfg = port_config(cfg_at("port"))
        enc = port_encoder(cfg_at("port").dce_model, 6, v)[0]
        return p_run(cfg, "dce", 0, data=p_prepare(cfg, "dce", 0, raw=raw, device="cpu"),
                     state=PState.create(enc), num_epochs=2, min_epochs=1,
                     base_dir=str(base / "port" / "results"), device="cpu")

    (theirs, ours), logs = run_beside(jax_run, port_run)
    return cfg_at("jax"), base, theirs, ours, logs


def test_run_single_dce_matches_jax(dce_runs):
    """The same ``metrics.json`` keys and parameters, the control plane per
    epoch, the same Nyul landmarks, the same group dump's hyperparameters."""
    cfg, base, theirs, ours, (jlog, plog) = dce_runs
    mine, ref = (json.load(open(base / pkg / "results" / "dce" / "fold_0" / "metrics.json"))
                 for pkg in ("port", "jax"))
    assert set(mine["train_metrics"]) == set(ref["train_metrics"])
    assert set(mine["test_metrics"]) == set(ref["test_metrics"])
    assert mine["parameters"]["base_path"] != ref["parameters"]["base_path"]
    mine["parameters"].pop("base_path"), ref["parameters"].pop("base_path")
    assert mine["parameters"] == ref["parameters"]
    assert len(ours["history"]) == len(theirs["history"]) == 2
    for a, b in zip(ours["history"], theirs["history"]):
        assert set(a) == set(b)
        assert a["group_trainable"] == b["group_trainable"]
        np.testing.assert_allclose(a["group_lrs"], b["group_lrs"], rtol=1e-7)
    np.testing.assert_allclose(ours["data"].nyul.landmarks, theirs["data"].nyul.landmarks,
                               rtol=1e-6)
    assert all(np.isfinite(v) for v in mine["test_metrics"].values())
    hp = re.compile(r"lr=\S+ wd=\S+ trainable=\d")
    assert hp.findall(plog) == hp.findall(jlog) and len(hp.findall(plog)) == 3
