"""Single-modality run of one fold: prepare -> build -> fit -> best reload ->
TTA x MC test -> ``metrics.json``.

Counterpart of ``dmf_tpu/pipeline/run_single.py`` (:39-172; the reference's
``run_single_model``, run_training.py:20-178, and its test path,
train.py:736-823), and of its fold-parallel ``run_single_model_multifold``
(:175-249).  The work runs on ``device``, the card unless the caller asks
for the CPU.  Where ``cfg.parallel.mesh_shape`` asks for a mesh, the runs
build it (``mesh_from_config``, as the JAX ones do) and train and test over
it (sharded over a model axis), each rank on its device; global rank 0
writes ``metrics.json`` and the processed splits.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import Config, to_reference_dict
from ..data.pipeline import ArrayDataset, iterate_batches
from ..evals.metrics import classification_report
from ..evals.predict import make_single_predictor
from ..losses import get_classification_loss_fn
from ..parallel.mesh import Mesh, mesh_from_config
from ..train.loop import FitResult, fit_single
from ..train.multifold_loop import fit_single_multifold
from ..train.optim import SingleModelOptController
from ..train.state import TrainState
from ..utils.logging import save_metrics_json
from .paths import prepare_output_paths
from .prepare_single import (SingleModelData, build_single_model, export_processed_splits,
                             load_raw_tensors, prepare_single_data)


def test_single_model(cfg: Config, state: TrainState, data: SingleModelData,
                      seed: int = 0, mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The uncertainty-aware test pass (train.py:736-823): the
    ``cfg.test_mode`` ensemble over the test split in batches of
    ``cfg.batch_size``, macro metrics, per-class accuracy, the mean
    uncertainty, the modality attention averaged per batch.  Dropout draws
    come from a generator seeded with ``seed`` on the model's device.
    ``mesh``: each batch served over the mesh (``evals/predict.py``)."""
    model = state.model
    device = next(model.parameters()).device
    predictor = make_single_predictor(cfg, model, mesh=mesh)
    test = data.splits["test"]
    imgs = data.processors_by_split["test"].eval_split(test["imgs"], adc=test.get("adc"))
    ds = ArrayDataset(imgs=imgs, labels=test["labels"])
    generator = torch.Generator(device).manual_seed(seed)
    all_probs, all_std, mod_attn = [], [], []
    for batch in iterate_batches(ds, cfg.batch_size):
        mean, std, aux = predictor(torch.as_tensor(batch["imgs"], device=device), generator)
        all_probs.append(mean.cpu().numpy())
        all_std.append(std.cpu().numpy())
        if aux.get("mod_attn_map") is not None:
            # the aux batch axis is (views x B) under tta/tta_mc: average the views
            b = len(batch["labels"])
            m = aux["mod_attn_map"].float().cpu().numpy()
            mod_attn.append(m.reshape(-1, b, m.shape[-1]).mean(0).mean(axis=0))
    probs = np.concatenate(all_probs)
    std = np.concatenate(all_std)
    labels = np.asarray(test["labels"]).astype(np.int64)
    metrics = classification_report(probs, labels, cfg.class_num, "test_")
    if cfg.test_mode != "normal":
        metrics["test_uncertainty_mean"] = float(std.mean())
    return {"metrics": metrics, "probs": probs, "std": std, "labels": labels,
            "modality_attention": np.stack(mod_attn) if mod_attn else None}


def run_single_model(cfg: Config, method: str, fold: int,
                     data: Optional[SingleModelData] = None, state: Optional[TrainState] = None,
                     num_epochs: Optional[int] = None, min_epochs: Optional[int] = None,
                     base_dir: str = "results", pretrained_path: Optional[str] = None,
                     resume_from: Optional[str] = None, export_splits: bool = True,
                     seed: int = 0, device="cuda") -> Dict[str, Any]:
    """The whole single-modality flow of one fold; returns the reference's
    result dict (run_training.py:173-178): the best checkpoint path, the best
    and final states, the train and test metrics, and the data and history
    the fusion stage consumes.  ``state`` (with its model) replaces the
    built one; ``device`` is where the model and the data's work live (each
    rank's own device under a mesh)."""
    mesh = mesh_from_config(cfg, device)
    device = mesh.device if mesh is not None else device
    paths = prepare_output_paths(method, fold, base_dir)
    if data is None:
        data = prepare_single_data(cfg, method, fold, device=device)
    if state is None:
        model, cfg = build_single_model(cfg, method, pretrained_path=pretrained_path,
                                        device=device)
        state = TrainState.create(model)
    fit = fit_single(cfg, method, state, train_data=data.splits["train"],
                     val_data=data.splits["val"], processor=data.processor,
                     controller=SingleModelOptController(cfg, method), workdir=paths["root"],
                     clf_loss_fn=get_classification_loss_fn(cfg, data.train_labels, method),
                     num_epochs=num_epochs, min_epochs=min_epochs, seed=seed,
                     resume_from=resume_from, mesh=mesh)

    return _finish_single(cfg, paths, data, fit, export_splits, seed, mesh)


def run_single_model_multifold(cfg: Config, method: str, folds: Sequence[int],
                               num_epochs: Optional[int] = None,
                               min_epochs: Optional[int] = None, base_dir: str = "results",
                               pretrained_path: Optional[str] = None,
                               export_splits: bool = True, seed: int = 0,
                               device="cuda") -> Dict[int, Dict[str, Any]]:
    """Every requested fold of one modality in one call
    (``train/multifold_loop.py``), then each fold's test; returns ``{fold:
    result}``, each result with exactly :func:`run_single_model`'s keys, so
    that ``run_fusion_model`` and the CLI summary take either path.

    The raw tensors load once and each fold prepares its splits from them;
    the model is built once and each fold trains a deep copy of it.  Every
    sequential run builds from the same seed (the pretrained import is the
    costly part), so the copies equal K builds.  Each fold's result equals
    its :func:`run_single_model` run with the same arguments.  Under a data
    mesh the folds train on the data ranks (``fit_single_multifold(mesh=)``:
    their number must be a multiple of the mesh's size) and each fold tests
    over the whole mesh.
    """
    mesh = mesh_from_config(cfg, device)
    device = mesh.device if mesh is not None else device
    folds = list(folds)
    raw = load_raw_tensors(cfg, method)
    datas = [prepare_single_data(cfg, method, f, raw=raw, device=device) for f in folds]
    del raw
    model, cfg = build_single_model(cfg, method, pretrained_path=pretrained_path,
                                    device=device)
    states = [TrainState.create(copy.deepcopy(model)) for _ in folds]
    del model
    pathss = [prepare_output_paths(method, f, base_dir) for f in folds]
    fits = fit_single_multifold(
        cfg, method, states, fold_train=[d.splits["train"] for d in datas],
        fold_val=[d.splits["val"] for d in datas], processors=[d.processor for d in datas],
        controllers=[SingleModelOptController(cfg, method) for _ in folds],
        workdirs=[p["root"] for p in pathss], num_epochs=num_epochs, min_epochs=min_epochs,
        seed=seed, mesh=mesh)
    return {fold: _finish_single(cfg, paths, data, fit, export_splits, seed, mesh)
            for fold, paths, data, fit in zip(folds, pathss, datas, fits)}


def _finish_single(cfg: Config, paths: Dict[str, str], data: SingleModelData,
                   fit: FitResult, export_splits: bool, seed: int,
                   mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """A fitted fold's best reload, test, ``metrics.json`` and processed
    splits (global rank 0's under a mesh); returns the reference's result
    dict."""
    # best-checkpoint reload for testing (run_training.py:123-131)
    best_state = fit.best_state if fit.best_state is not None else fit.state
    test_result = test_single_model(cfg, best_state, data, seed=seed, mesh=mesh)
    save_metrics_json(paths["metrics"], fit.train_metrics, test_result["metrics"],
                      parameters=to_reference_dict(cfg), mesh=mesh)
    if export_splits:
        if mesh is None or mesh.writer:
            export_processed_splits(cfg, data, torch.Generator(data.processor.device)
                                    .manual_seed(seed))
        if mesh is not None:
            mesh.barrier()
    return {
        "best_checkpoint": f"{paths['checkpoints']}/best.pt",
        "model": best_state.model,
        "state": best_state,
        "final_state": fit.state,
        "data": data,
        "train_metrics": fit.train_metrics,
        "test_metrics": test_result["metrics"],
        "test_probs": test_result["probs"],
        "test_std": test_result["std"],
        "modality_attention": test_result["modality_attention"],
        "history": fit.history,
        "step_ms": fit.step_ms,
        "config": cfg,
    }
