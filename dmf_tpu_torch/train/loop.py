"""Epoch loops of single-modality and fusion training, counterparts of
``dmf_tpu/train/loop.py::fit_single`` (:106-363) and ``fit_fusion``
(:365-593), without a mesh.  ``cfg.use_native_loader`` takes the train
batches of a split that is not staged on the card from the native loader, as
the JAX loops do (:225, :466).

The reference's ``pl.Trainer.fit`` orchestration (run_training.py:103-131,
181-263): train steps on the device, and on the host a metric-driven control
plane (plateau or warmup-cosine lr, the per-group lr and trainable flags per
epoch, early stopping with ``min_epochs``, the aux-loss weight schedule, the
best checkpoint, the rolling resume checkpoint every ``ROLL_EVERY`` epochs).
Under ``cfg.debug_training`` both print the optimizer groups and the first
batch's input statistics, as the JAX loops do.  The mask visualisation the
JAX loops draw at the same epochs waits for ``utils/visualize`` (ROADMAP
1.7) and is not drawn.

On a CUDA device each train step records three CUDA events (before the batch
preparation, between it and the step, after the step); their times come back
in ``FitResult.step_ms``, read at each epoch's end with the step metrics.
Fusion batches come processed: their preparation is the batch dict alone.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.modality import ModalityProcessor
from ..data.pipeline import ArrayDataset, device_data_auto, iterate_batches
from ..evals.metrics import MeanMetric, classification_report
from ..losses import get_classification_loss_fn, get_mask_loss_fn
from ..models.build import init_weights
from ..utils.checkpoint import BestCheckpointer, RollingSaver, load_checkpoint
from ..utils.logging import MetricLogger, input_stats
from .fusion import make_fusion_eval_step, make_fusion_train_step
from .optim import (FusionOptController, SingleModelOptController, build_fusion_group_spec,
                    build_group_spec, describe_groups)
from .schedule import (EarlyStopping, ReduceLROnPlateau, WarmupCosine, aux_loss_weight,
                       make_scheduler)
from .single import make_single_eval_step, make_single_train_step
from .state import TrainState


# epochs between rolling resume checkpoints (the JAX loop's ``viz_every``
# default, which paces both its mask figure and its rolling save)
ROLL_EVERY = 10


@dataclasses.dataclass
class FitResult:
    state: TrainState
    best_state: Optional[TrainState]
    history: list
    train_metrics: Dict[str, float]
    # (batch preparation ms, train step ms) per step by CUDA events; empty on the CPU
    step_ms: List[Tuple[float, float]] = dataclasses.field(default_factory=list)


def init_single_state(model: torch.nn.Module, seed: int = 0) -> TrainState:
    """A fresh train state on weights drawn anew from a generator seeded with
    ``seed`` on the model's device, with the JAX initializers
    (``models.build.init_weights``)."""
    init_weights(model, torch.Generator(next(model.parameters()).device).manual_seed(seed))
    return TrainState.create(model)


def _warn_nonfinite(metrics: Dict[str, float], epoch: int, step: int) -> None:
    """Host-side warning on non-finite gradients (train.py:229-233)."""
    n = metrics.get("grad_nonfinite", 0)
    if n and n > 0:
        print(f"[dmf_tpu_torch] WARNING: {int(n)} non-finite gradient entries at "
              f"epoch {epoch} step {step} (grad_norm="
              f"{metrics.get('grad_norm', float('nan')):.3e})")


def fit_single(cfg: Config, method: str, state: TrainState,
               train_data: Dict[str, Optional[np.ndarray]],
               val_data: Dict[str, Optional[np.ndarray]],
               processor: ModalityProcessor, controller: SingleModelOptController,
               workdir: str, clf_loss_fn=None, num_epochs: Optional[int] = None,
               min_epochs: Optional[int] = None, seed: int = 0,
               resume_from: Optional[str] = None) -> FitResult:
    """Train one encoder; returns the final and best states and the history.

    ``train_data``/``val_data``: raw (unprocessed) ``imgs``, optional
    ``masks`` (at ``mask_target_size``) and ``adc``, and ``labels``.
    ``resume_from``: a checkpoint to restore first (``load_checkpoint``).
    Augmentation and dropout draw from generators on the model's device
    seeded from ``seed``; the shuffle is ``np.random.RandomState(seed)``, the
    JAX loop's order.
    """
    mc = cfg.model_config(method)
    model = state.model
    device = next(model.parameters()).device
    if clf_loss_fn is None:
        clf_loss_fn = get_classification_loss_fn(cfg, train_data["labels"], method)
    mask_loss_fn = get_mask_loss_fn(cfg, method)
    spec = build_group_spec([n for n, _ in model.named_parameters()], mc.use_backbone,
                            cfg.reference_compat)
    if resume_from is not None:
        load_checkpoint(resume_from, state)

    train_ds = ArrayDataset(imgs=train_data["imgs"], masks=train_data.get("masks"),
                            labels=train_data["labels"], adc=train_data.get("adc"))
    # eval inputs are deterministic: processed once (kernel 7 for DWI), reused
    val_imgs = processor.eval_split(val_data["imgs"], adc=val_data.get("adc"))
    val_ds = ArrayDataset(imgs=val_imgs, masks=val_data.get("masks"),
                          labels=val_data["labels"])
    aug_gen = torch.Generator(device).manual_seed(seed)

    def prepare(batch):
        proc = {"imgs": processor.train_batch(aug_gen, batch["imgs"], adc=batch.get("adc")),
                "labels": batch["labels"]}
        if "masks" in batch:
            proc["masks"] = batch["masks"]
        return proc, proc["imgs"]

    return _fit(cfg, mc.scheduler, mc.optimizer.lr, state, spec, controller,
                make_single_train_step(cfg, method, clf_loss_fn, mask_loss_fn, spec),
                make_single_eval_step(cfg, method, clf_loss_fn, mask_loss_fn),
                train_ds, val_ds, prepare, workdir, num_epochs, min_epochs, seed)


def fit_fusion(cfg: Config, state: TrainState, train_data: Dict[str, Optional[np.ndarray]],
               val_data: Dict[str, Optional[np.ndarray]], workdir: str, clf_loss_fn=None,
               num_epochs: Optional[int] = None, min_epochs: Optional[int] = None,
               seed: int = 0) -> FitResult:
    """Train the fusion network (``state.model``, a
    :class:`~.fusion.FusionNetwork`) with the gradual deep->shallow unfreeze
    of :class:`~.optim.FusionOptController`; returns the final and best
    states and the history (run_training.py:181-263).

    ``train_data``/``val_data``: **processed** ``dwi`` and ``dce`` stacks
    (the splits ``export_processed_splits`` writes), optional ``masks``, and
    ``labels``.  Dropout draws from a generator on the model's device seeded
    from ``seed``; the shuffle is ``np.random.RandomState(seed)``.
    """
    fp = cfg.fusion_model
    if clf_loss_fn is None:
        clf_loss_fn = get_classification_loss_fn(cfg, train_data["labels"], "fusion")
    mask_loss_fn = get_mask_loss_fn(cfg, "fusion")
    spec = build_fusion_group_spec([n for n, _ in state.model.named_parameters()], cfg)

    def dataset(split):
        return ArrayDataset(dwi=split["dwi"], dce=split["dce"], masks=split.get("masks"),
                            labels=split["labels"])

    def prepare(batch):
        return batch, batch["dwi"]

    return _fit(cfg, fp.scheduler, fp.optimizer.lr, state, spec, FusionOptController(cfg),
                make_fusion_train_step(cfg, clf_loss_fn, mask_loss_fn, spec),
                make_fusion_eval_step(cfg, clf_loss_fn, mask_loss_fn),
                dataset(train_data), dataset(val_data), prepare, workdir, num_epochs,
                min_epochs, seed)


def _fit(cfg: Config, scheduler_cfg, base_lr: float, state: TrainState, spec, controller,
         train_step, eval_step, train_ds: ArrayDataset, val_ds: ArrayDataset,
         prepare: Callable, workdir: str, num_epochs: Optional[int],
         min_epochs: Optional[int], seed: int) -> FitResult:
    """The epoch loop both fits share.  ``prepare(batch) -> (step batch,
    the inputs whose statistics the first batch prints)``."""
    device = next(state.model.parameters()).device
    num_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
    min_epochs = min(min_epochs if min_epochs is not None else cfg.min_epochs, num_epochs)
    if cfg.debug_training:
        # the optimizer-group dump (selector_helpers.py:336-353)
        print(describe_groups(dict(state.model.named_parameters()), spec,
                              controller.hyperparams()))
    scheduler = make_scheduler(scheduler_cfg, base_lr)
    early = EarlyStopping(mode=cfg.early_stopping.mode, patience=cfg.early_stopping.patience,
                          min_delta=cfg.early_stopping.min_delta)
    ckpt = BestCheckpointer(f"{workdir}/checkpoints", monitor="val_acc", mode="max")
    roll = RollingSaver(f"{workdir}/checkpoints")
    logger = MetricLogger(f"{workdir}/logs")
    stage_train = device if device_data_auto(train_ds, device, cfg.device_data) else None
    stage_val = device if device_data_auto(val_ds, device, cfg.device_data) else None

    drop_gen = torch.Generator(device).manual_seed(seed + 1)
    np_rng = np.random.RandomState(seed)
    timed = device.type == "cuda"
    history, step_ms = [], []
    best_state = None
    global_step = 0

    for epoch in range(num_epochs):
        t0 = time.time()
        controller.on_epoch_start(epoch)
        hp = controller.hyperparams()
        aux_w = aux_loss_weight(epoch, cfg.aux_loss_weight_epoch_limit,
                                cfg.use_simple_aux_loss_scheduling)

        # ---- train: the tail batch runs at its short size ----
        pending = []  # (device metrics, batch size, events) per step
        epoch_step0 = global_step
        for batch in iterate_batches(train_ds, cfg.batch_size, shuffle=True, rng=np_rng,
                                     device=stage_train, native=cfg.use_native_loader):
            if isinstance(scheduler, WarmupCosine):
                # stepped per step (selector_helpers.py:319-330)
                controller.lr_scale = scheduler.step_scale(global_step)
                hp = controller.hyperparams()
            global_step += 1
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if timed else []
            if timed:
                events[0].record()
            proc, inputs = prepare(batch)
            proc = dict(proc, aux_w=aux_w)
            if timed:
                events[1].record()
            if cfg.debug_training and global_step == 1:
                # the first batch's normalisation check (train.py:1074-1079)
                print(input_stats(inputs, proc.get("masks")))
            metrics = train_step(state, proc, drop_gen, hp)
            if timed:
                events[2].record()
            pending.append((metrics, len(batch["labels"]), events))
        train_meters: Dict[str, MeanMetric] = {}
        for i, (metrics, n, events) in enumerate(pending):
            values = {k: float(v) for k, v in metrics.items()}
            _warn_nonfinite(values, epoch, epoch_step0 + i + 1)
            for k, v in values.items():
                train_meters.setdefault(k, MeanMetric()).update(v, weight=n)
            if events:
                step_ms.append((events[0].elapsed_time(events[1]),
                                events[1].elapsed_time(events[2])))
        epoch_metrics = {f"train_{k}": m.compute() for k, m in train_meters.items()}
        epoch_metrics["train_time"] = time.time() - t0

        # ---- validation ----
        val_meters: Dict[str, MeanMetric] = {}
        all_probs = []
        for batch in iterate_batches(val_ds, cfg.batch_size, device=stage_val):
            _, probs, metrics = eval_step(state, batch)
            all_probs.append(probs.cpu().numpy())
            for k, v in metrics.items():
                val_meters.setdefault(k, MeanMetric()).update(float(v),
                                                              weight=len(batch["labels"]))
        epoch_metrics.update({f"val_{k}": m.compute() for k, m in val_meters.items()})
        epoch_metrics.update(classification_report(
            np.concatenate(all_probs), np.asarray(val_ds.arrays["labels"]).astype(np.int64),
            cfg.class_num, "val_"))
        epoch_metrics["lr_scale"] = controller.lr_scale
        epoch_metrics["aux_w"] = aux_w
        epoch_metrics["epoch_time"] = time.time() - t0
        # the per-group lr and trainable flag of this epoch (the reference's
        # LearningRateMonitor(logging_interval='epoch'), run_training.py:36)
        epoch_metrics["group_lrs"] = hp.lr.tolist()
        epoch_metrics["group_trainable"] = hp.trainable.tolist()

        # ---- control plane ----
        if isinstance(scheduler, ReduceLROnPlateau):
            monitored = epoch_metrics.get(scheduler_cfg.monitor, epoch_metrics["val_loss"])
            if scheduler.step_reduced(monitored):
                controller.apply_plateau(scheduler.factor, scheduler.min_lr)
        elif not isinstance(scheduler, WarmupCosine):  # that one steps per step
            controller.lr_scale = scheduler.step_scale(epoch)

        if ckpt.maybe_save(state, epoch_metrics, epoch):
            best_state = state.copy()
        if epoch % ROLL_EVERY == 0:
            roll.save(state)

        history.append(epoch_metrics)
        logger.log_epoch(epoch, epoch_metrics)
        stop_metric = epoch_metrics.get(cfg.early_stopping.metric)
        if stop_metric is not None and early.step(stop_metric) and epoch + 1 >= min_epochs:
            break

    return FitResult(state=state, best_state=best_state, history=history,
                     train_metrics=history[-1] if history else {}, step_ms=step_ms)
