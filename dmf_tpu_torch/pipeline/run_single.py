"""Single-modality run of one fold: prepare -> build -> fit -> best reload ->
TTA x MC test -> ``metrics.json``.

Counterpart of ``dmf_tpu/pipeline/run_single.py`` (:39-172; the reference's
``run_single_model``, run_training.py:20-178, and its test path,
train.py:736-823).  The work runs on ``device``, the card unless the caller
asks for the CPU.  The fold-parallel ``run_single_model_multifold`` is not
ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import Config, to_reference_dict
from ..data.pipeline import ArrayDataset, iterate_batches
from ..evals.metrics import classification_report
from ..evals.predict import make_single_predictor
from ..losses import get_classification_loss_fn
from ..train.loop import fit_single
from ..train.optim import SingleModelOptController
from ..train.state import TrainState
from ..utils.logging import save_metrics_json
from .paths import prepare_output_paths
from .prepare_single import (SingleModelData, build_single_model, export_processed_splits,
                             prepare_single_data)


def test_single_model(cfg: Config, state: TrainState, data: SingleModelData,
                      seed: int = 0) -> Dict[str, Any]:
    """The uncertainty-aware test pass (train.py:736-823): the
    ``cfg.test_mode`` ensemble over the test split in batches of
    ``cfg.batch_size``, macro metrics, per-class accuracy, the mean
    uncertainty, the modality attention averaged per batch.  Dropout draws
    come from a generator seeded with ``seed`` on the model's device."""
    model = state.model
    device = next(model.parameters()).device
    predictor = make_single_predictor(cfg, model)
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
    built one; ``device`` is where the model and the data's work live."""
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
                     resume_from=resume_from)

    # best-checkpoint reload for testing (run_training.py:123-131)
    best_state = fit.best_state if fit.best_state is not None else fit.state
    test_result = test_single_model(cfg, best_state, data, seed=seed)
    save_metrics_json(paths["metrics"], fit.train_metrics, test_result["metrics"],
                      parameters=to_reference_dict(cfg))
    if export_splits:
        export_processed_splits(cfg, data, torch.Generator(data.processor.device)
                                .manual_seed(seed))
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
