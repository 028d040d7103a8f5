"""Fusion run of one fold: paired processed splits -> the fusion network over
copies of the trained encoders -> fit with the gradual unfreeze -> best
reload -> TTA x MC test -> ``metrics.json`` -> the per-fold store.

Counterpart of ``dmf_tpu/pipeline/run_fusion.py`` (the reference's
``prepare_fusion_model``, prepare_fusion_model.py:13-113, and
``run_fusion_model``, run_training.py:181-333).  The work runs where the
trained encoders live: the card, unless the single-modality runs were asked
for the CPU.  ``int8=True`` serves the test on the post-training-quantized
convs (``ops/quant.py``), calibrated on the validation split.  Where
``cfg.parallel.mesh_shape`` asks for a mesh, the run builds it
(``mesh_from_config``, as the JAX one does) and trains and tests over it
(sharded over a model axis); global rank 0 writes ``metrics.json`` and the
per-fold store (the whole parameters).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import Config, to_reference_dict
from ..data.pipeline import ArrayDataset, iterate_batches
from ..evals.metrics import classification_report
from ..evals.predict import make_fusion_predictor
from ..losses import get_classification_loss_fn
from ..models.build import init_weights
from ..models.fusion import FusionModel
from ..parallel.mesh import Mesh, mesh_from_config
from ..parallel.sharding import full_parameters
from ..parallel.tensor import tensor_parallel
from ..train.fusion import FusionNetwork
from ..train.loop import fit_fusion
from ..train.state import TrainState
from ..utils.logging import save_metrics_json
from .paths import prepare_output_paths
from .prepare_single import load_processed_split


def prepare_fusion_data(cfg: Config, fold: int, processed_dir: Optional[str] = None
                        ) -> Dict[str, Dict[str, Optional[np.ndarray]]]:
    """Paired (dwi, dce, masks, labels) splits from the processed splits the
    single-modality runs exported (masks and labels are stored with the DWI
    split only, prepare_single_model.py:160-174)."""
    processed_dir = processed_dir or os.path.join(cfg.base_path, "processed")
    out = {}
    for split in ("train", "val", "test"):
        dwi = load_processed_split(os.path.join(processed_dir, f"dwi{fold}{split}data"))
        dce = load_processed_split(os.path.join(processed_dir, f"dce{fold}{split}data"))
        out[split] = {"dwi": dwi["imgs"], "dce": dce["imgs"], "masks": dwi.get("masks"),
                      "labels": dwi.get("labels")}
    return out


def build_fusion_state(cfg: Config, dwi_state: TrainState, dce_state: TrainState,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """The fusion network and its train state over the trained encoders
    (prepare_fusion_model.py:71-79), in fp32 as the JAX function builds it.

    The encoders are deep copies: the fusion step updates in place, and the
    caller's single-modality states stay as they were (the JAX function is
    pure).  The fusion head gets seeded random weights from ``generator`` (on
    the encoders' device; default seeded with ``cfg.seed``), in
    ``channels_last`` on the card."""
    dwi, dce = copy.deepcopy(dwi_state.model), copy.deepcopy(dce_state.model)
    device = next(dwi.parameters()).device
    fusion_model = FusionModel(
        cfg.fusion_model, cfg.class_num, dwi_channels=dwi.config.channels[-1],
        dce_channels=dce.config.channels[-1], feature_size=dwi.feature_size,
        with_masks=dwi.mask_stage is not None and dce.mask_stage is not None,
        device=device, dtype=torch.float32)
    init_weights(fusion_model, generator or torch.Generator(device).manual_seed(cfg.seed))
    if device.type == "cuda":
        fusion_model.to(memory_format=torch.channels_last)
    return TrainState.create(FusionNetwork(dwi, dce, fusion_model), num_groups=4)


def test_fusion_model(cfg: Config, state: TrainState, test_data: Dict[str, np.ndarray],
                      seed: int = 0, int8: bool = False,
                      calibration_data: Optional[Dict[str, np.ndarray]] = None,
                      mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The ``cfg.test_mode`` ensemble over the test split in batches of
    ``cfg.batch_size`` (train_fusion.py:342-434): macro metrics, per-class
    accuracy, the mean uncertainty, the wall time, and the gating weights
    averaged per batch as the modality attention.  Dropout draws come from a
    generator seeded with ``seed`` on the models' device.

    ``int8=True`` serves the ensemble on the int8 convs (``ops/quant.py``),
    an opt-in deployment mode, not reference behaviour: activation scales are
    calibrated on at most 8 volumes of ``calibration_data`` (pass held-out
    volumes, so the test split never shapes the served model's quantization;
    the test split is the last resort), with MC dropout on in ``mc`` /
    ``tta_mc`` from a generator seeded ``seed + 1`` (run_fusion.py:110-165).
    ``mesh``: each batch served over the mesh (``evals/predict.py``; over a
    model axis the state's models are sharded in place), the int8 forward
    included: over a model axis the models are sharded before they are
    quantized (JAX's order, run_fusion.py:130-166), and each rank's int8
    convs hold its output-channel shard; the calibration runs on every rank
    alike."""
    t_start = time.time()
    net = state.model
    device = next(net.parameters()).device
    fwd_override = None
    if int8:
        if mesh is not None:
            for m in (net.dwi, net.dce, net.fusion):
                tensor_parallel(m, mesh)
        from ..ops.quant import make_quantized_fusion_apply, make_quantized_fusion_fwd

        calib = calibration_data if calibration_data is not None else test_data
        nc = min(len(calib["dwi"]), 8)
        _, qsets = make_quantized_fusion_apply(
            net.dwi, net.dce, net.fusion,
            calibration=(np.asarray(calib["dwi"][:nc]), np.asarray(calib["dce"][:nc])),
            calibration_mc=cfg.test_mode in ("mc", "tta_mc"),
            calibration_rng=torch.Generator(device).manual_seed(seed + 1))
        fwd_override = make_quantized_fusion_fwd(net.dwi, net.dce, net.fusion, qsets)
    predictor = make_fusion_predictor(cfg, net.dwi, net.dce, net.fusion,
                                      fwd_override=fwd_override, mesh=mesh)
    ds = ArrayDataset(dwi=test_data["dwi"], dce=test_data["dce"], labels=test_data["labels"])
    generator = torch.Generator(device).manual_seed(seed)
    all_probs, all_std, gating = [], [], []
    for batch in iterate_batches(ds, cfg.batch_size):
        mean, std, aux = predictor(torch.as_tensor(batch["dwi"], device=device),
                                   torch.as_tensor(batch["dce"], device=device), generator)
        all_probs.append(mean.cpu().numpy())
        all_std.append(std.cpu().numpy())
        gw = aux.get("gating_weights")
        if gw is not None:
            # the aux batch axis is (views x B) under tta/tta_mc: average the views
            b = len(batch["labels"])
            gw = gw.float().cpu().numpy()
            gating.append(gw.reshape(-1, b, gw.shape[-1]).mean(0).mean(axis=0))
    probs, std = np.concatenate(all_probs), np.concatenate(all_std)
    labels = np.asarray(test_data["labels"]).astype(np.int64)
    metrics = classification_report(probs, labels, cfg.class_num, "test_")
    if cfg.test_mode != "normal":
        metrics["test_uncertainty_mean"] = float(std.mean())
    # wall-clock report (model_test.py:103, 198-199)
    metrics["test_time_sec"] = round(time.time() - t_start, 3)
    return {"metrics": metrics, "probs": probs, "std": std, "labels": labels,
            "modality_attention": np.stack(gating) if gating else None}


def run_fusion_model(cfg: Config, fold: int, dwi_results: Dict[str, Any],
                     dce_results: Dict[str, Any],
                     fusion_data: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
                     num_epochs: Optional[int] = None, min_epochs: Optional[int] = None,
                     base_dir: str = "results", seed: int = 0) -> Dict[str, Any]:
    """The whole fusion flow of one fold (run_training.py:181-333) over the
    results of :func:`~.run_single.run_single_model` for DWI and DCE, which it
    leaves unchanged; returns the reference's result dict."""
    mesh = mesh_from_config(cfg, next(dwi_results["state"].model.parameters()).device)
    paths = prepare_output_paths("fusion", fold, base_dir)
    if fusion_data is None:
        fusion_data = prepare_fusion_data(cfg, fold)
    state = build_fusion_state(cfg, dwi_results["state"], dce_results["state"])
    fit = fit_fusion(cfg, state, train_data=fusion_data["train"], val_data=fusion_data["val"],
                     workdir=paths["root"],
                     clf_loss_fn=get_classification_loss_fn(
                         cfg, fusion_data["train"]["labels"], "fusion"),
                     num_epochs=num_epochs, min_epochs=min_epochs, seed=seed, mesh=mesh)
    # best-checkpoint reload for testing
    best_state = fit.best_state if fit.best_state is not None else fit.state
    # int8 calibration (when enabled downstream) must never see test data
    test_result = test_fusion_model(cfg, best_state, fusion_data["test"], seed=seed,
                                    calibration_data=fusion_data["val"], mesh=mesh)
    save_metrics_json(paths["metrics"], fit.train_metrics, test_result["metrics"],
                      parameters=to_reference_dict(cfg), mesh=mesh)
    # the per-fold store of the best parameters (run_training.py:317-326),
    # whole (gathered by every rank over a model axis)
    params = full_parameters(best_state.model)
    if mesh is None or mesh.writer:
        torch.save(params, os.path.join(paths["checkpoints"], f"fusion_fold{fold}.pt"))
    if mesh is not None:
        mesh.barrier()
    net = best_state.model
    return {
        "best_checkpoint": f"{paths['checkpoints']}/best.pt",
        "fusion_model": net.fusion,
        "dwi_model": net.dwi,
        "dce_model": net.dce,
        "state": best_state,
        "final_state": fit.state,
        "train_metrics": fit.train_metrics,
        "test_metrics": test_result["metrics"],
        "test_probs": test_result["probs"],
        "test_std": test_result["std"],
        "modality_attention": test_result["modality_attention"],
        "history": fit.history,
        "step_ms": fit.step_ms,
    }


def fusion_model_test(cfg: Config, state: TrainState, test_data: Dict[str, np.ndarray],
                      seed: int = 0, int8: bool = False,
                      calibration_data: Optional[Dict[str, np.ndarray]] = None
                      ) -> Dict[str, Any]:
    """The standalone fusion evaluation (model_test.py:99-202): the test pass
    of :func:`test_fusion_model`, optionally on the int8 convs."""
    return test_fusion_model(cfg, state, test_data, seed, int8=int8,
                             calibration_data=calibration_data)
