"""The port's single-modality serving and run vs the JAX package's, fp32 on
the CPU, at toy geometry (32^2, channels (8, 16, 32), the (1, 1, 1, 1)
ResNet-50 of ``test_torch_helpers``).

* ``make_single_predictor`` in the four modes on the same weights as
  ``dmf_tpu.evals.predict.make_single_predictor``; MC modes at dropout 0,
  where both are deterministic; tolerance ``RTOL`` (rel 1e-4);
* ``run_single_model`` end to end (prepare, build, fit, best reload,
  TTA x MC test, ``metrics.json``) beside the JAX run on the same data and
  weights: the same metric keys, per-epoch group lrs and trainable flags,
  and the ``parameters`` block equal to JAX's ``to_reference_dict``.  The
  values differ: augmentation and dropout draw from each framework's own
  random stream.  The port's run with the backbone (frozen, then trained
  after its unfreeze) is checked on its own.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import assert_close, jax_encoder, port_config, port_encoder, tiny_cfg

from dmf_tpu.config import to_reference_dict
from dmf_tpu.data.synthetic import make_synthetic_arrays
from dmf_tpu.evals.predict import make_single_predictor as jax_predictor
from dmf_tpu.pipeline import prepare_single_data as j_prepare, run_single_model as j_run
from dmf_tpu.utils import visualize
from dmf_tpu_torch.evals.predict import make_single_predictor
from dmf_tpu_torch.pipeline import prepare_single_data as p_prepare, run_single_model as p_run
from dmf_tpu_torch.train.state import TrainState
from dmf_tpu_torch.utils.checkpoint import load_checkpoint

CHANNELS = 14


@pytest.fixture(scope="module")
def encoders():
    cfg = tiny_cfg(dropout=0.0, mc_passes=3)
    x = np.random.RandomState(0).rand(3, 32, 32, CHANNELS).astype(np.float32)
    jm, v = jax_encoder(cfg.dwi_model, CHANNELS, x, seed=7)
    pm, _ = port_encoder(cfg.dwi_model, CHANNELS, v)
    return cfg, x, jm, v, pm


@pytest.mark.parametrize("mode", ["normal", "tta", "mc", "tta_mc"])
def test_single_predictor_matches_jax(encoders, mode):
    cfg, x, jm, v, pm = encoders
    mean_j, std_j, aux_j = jax_predictor(cfg, jm, mode=mode)(v, jnp.asarray(x),
                                                              jax.random.PRNGKey(0))
    mean, std, aux = make_single_predictor(port_config(cfg), pm, mode=mode)(
        torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert_close(mean, mean_j, what="mean")
    assert_close(std, std_j, what="std")
    assert_close(aux["mod_attn_map"], aux_j["mod_attn_map"], what="mod_attn_map")
    for ours, theirs in zip(aux["raw_feats"], aux_j["raw_feats"]):
        assert_close(ours, theirs, what="raw_feats")


def test_single_predictor_mc_dropout():
    """With dropout on: MC std > 0, probabilities sum to 1, one seed repeats,
    and chunked passes give the same ensemble as one chunk."""
    cfg = port_config(tiny_cfg(dropout=0.3, mc_passes=4))
    _, v = jax_encoder(tiny_cfg().dwi_model, CHANNELS, np.zeros((1, 32, 32, CHANNELS)), seed=8)
    pm, _ = port_encoder(tiny_cfg(dropout=0.3).dwi_model, CHANNELS, v)
    x = torch.rand(2, 32, 32, CHANNELS, generator=torch.Generator().manual_seed(1))
    runs = [make_single_predictor(cfg, pm, mode="tta_mc", mc_chunk=chunk)(
        x, torch.Generator().manual_seed(3)) for chunk in (None, None, 8)]
    mean, std, _ = runs[0]
    assert (std > 0).all() and torch.allclose(mean.sum(-1), torch.ones(2))
    assert torch.equal(mean, runs[1][0])
    assert torch.allclose(mean, runs[2][0], atol=1e-6)
    with pytest.raises(ValueError, match="generator"):
        make_single_predictor(cfg, pm, mode="mc")(x)


def store(tmp, use_backbone, batch_size):
    """A toy config and a synthetic store of 32 + 8 volumes: fold 0 of 4
    splits 26 train and 6 validation volumes."""
    cfg = tiny_cfg(dropout=0.1, mc_passes=2, use_backbone=use_backbone)
    cfg = cfg.replace(batch_size=batch_size, segnum=4, foundation_model_unfreeze_timer=1,
                      base_path=str(tmp / "data"))
    raw = make_synthetic_arrays(n_train=32, n_test=8, image_size=32, seed=2)
    raw = {"imgs": raw["dwi"], "test_imgs": raw["dwi_test"], "labels": raw["labels"],
           "test_labels": raw["labels_test"], "masks": raw["masks"]}
    _, v = jax_encoder(cfg.dwi_model, CHANNELS, np.zeros((2, 32, 32, CHANNELS), np.float32),
                       seed=9)
    return cfg, raw, v


def port_run(cfg, raw, v, base_dir):
    pcfg = port_config(cfg)
    return p_run(pcfg, "dwi", 0, data=p_prepare(pcfg, "dwi", 0, raw=raw, device="cpu"),
                 state=TrainState.create(port_encoder(cfg.dwi_model, CHANNELS, v)[0]),
                 num_epochs=2, min_epochs=1, base_dir=base_dir, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``run_single_model`` on one store and the same weights
    (the encoder without a backbone: the JAX run's compilations dominate)."""
    base = tmp_path_factory.mktemp("store")
    # B=13: two full train batches, so the JAX loop compiles one step shape;
    # tta: the same metric keys as tta_mc at a cheaper JAX compile (the
    # port's tta_mc run is the backbone run below)
    cfg, raw, v = store(base, use_backbone=False, batch_size=13)
    cfg = cfg.replace(test_mode="tta")
    jm, _ = jax_encoder(cfg.dwi_model, CHANNELS, np.zeros((2, 32, 32, CHANNELS), np.float32))
    with pytest.MonkeyPatch.context() as mp:
        # the JAX loop draws a mask figure at epoch 0 (matplotlib, not
        # ported, ROADMAP); it writes no metric
        mp.setattr(visualize, "visualize_mask_triplet", lambda *a, **k: None)
        theirs = j_run(cfg, "dwi", 0, data=j_prepare(cfg, "dwi", 0, raw=raw), model=jm,
                       variables=v, num_epochs=2, min_epochs=1, base_dir=str(base / "jax"),
                       export_splits=False)
    return cfg, base, theirs, port_run(cfg, raw, v, str(base / "port"))


@pytest.fixture(scope="module")
def backbone_run(tmp_path_factory):
    """The port's run with the backbone, frozen in epoch 0 and trained in 1;
    B=8 leaves a short tail batch of 2 each epoch."""
    base = tmp_path_factory.mktemp("store_bb")
    cfg, raw, v = store(base, use_backbone=True, batch_size=8)
    return cfg, base, port_run(cfg, raw, v, str(base / "port"))


def test_run_single_metrics_json_matches_jax(runs):
    cfg, base, _, _ = runs
    ours, theirs = (json.load(open(base / pkg / "dwi" / "fold_0" / "metrics.json"))
                    for pkg in ("port", "jax"))
    assert set(ours) == set(theirs) == {"train_metrics", "test_metrics", "parameters"}
    assert set(ours["train_metrics"]) == set(theirs["train_metrics"])
    assert set(ours["test_metrics"]) == set(theirs["test_metrics"])
    assert ours["parameters"] == theirs["parameters"] == json.loads(
        json.dumps(to_reference_dict(cfg)))
    for k, val in ours["test_metrics"].items():
        assert np.isfinite(val), k


def test_run_single_control_plane_matches_jax(runs):
    _, _, theirs, ours = runs
    assert len(ours["history"]) == len(theirs["history"]) == 2
    for a, b in zip(ours["history"], theirs["history"]):
        assert set(a) == set(b)
        assert a["group_trainable"] == b["group_trainable"]
        np.testing.assert_allclose(a["group_lrs"], b["group_lrs"], rtol=1e-7)
        assert a["aux_w"] == b["aux_w"] and a["lr_scale"] == b["lr_scale"]
    assert set(ours) >= set(theirs)
    assert ours["step_ms"] == []  # CUDA events only on the card


def test_run_single_with_backbone(backbone_run):
    """The backbone group frozen in epoch 0 and trained in epoch 1; the
    checkpoints and logs on disk; the processed splits; a test ensemble
    that sums to 1 with MC std > 0; the best checkpoint reloaded into the
    final state gives the best state's eval logits bit for bit."""
    cfg, base, ours = backbone_run
    assert [h["group_trainable"] for h in ours["history"]] == [[0.0, 1.0, 1.0], [1.0] * 3]
    steps = -(-len(ours["data"].splits["train"]["labels"]) // cfg.batch_size)
    assert ours["final_state"].opt_state.count.tolist() == [steps, 2 * steps, 2 * steps]
    root = base / "port" / "dwi" / "fold_0"
    for rel in ("checkpoints/best.pt", "checkpoints/best.json", "checkpoints/last.pt",
                "logs/metrics.jsonl"):
        assert (root / rel).exists(), rel
    assert ours["best_checkpoint"] == str(root / "checkpoints" / "best.pt")
    probs = ours["test_probs"]
    assert probs.shape == (8, cfg.class_num)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    assert (ours["test_std"] > 0).all()
    assert ours["modality_attention"].shape[-1] == CHANNELS
    for split in ("train", "val", "test"):
        assert os.path.exists(os.path.join(cfg.base_path, "processed", f"dwi0{split}data.npz"))
    final = ours["final_state"]
    assert final.model is not ours["state"].model
    x = torch.rand(2, CHANNELS, 32, 32, generator=torch.Generator().manual_seed(5))
    load_checkpoint(ours["best_checkpoint"], final)
    with torch.no_grad():
        assert torch.equal(final.model(x)[0], ours["state"].model(x)[0])
