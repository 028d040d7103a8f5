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
batch's input statistics, as the JAX loops do.  Every ``viz_every`` epochs
(JAX's epochs: 0, 10, ...) where the mask head is on and the validation
split has masks, both draw the mask triptych of one validation sample
(``utils/visualize.py``, the JAX loops' :314-338 and :544-575) to
``{workdir}/viz/epoch_{epoch:04d}.png``, after the epoch's timed steps and
validation; a failure to draw raises.

On a CUDA device each train step records three CUDA events (before the batch
preparation, between it and the step, after the step); their times come back
in ``FitResult.step_ms``, read at each epoch's end with the step metrics.
Fusion batches come processed: their preparation is the batch dict alone.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.modality import ModalityProcessor
from ..data.pipeline import ArrayDataset, device_data_auto, iterate_batches
from ..evals.metrics import MeanMetric, classification_report
from ..evals.predict import to_model
from ..losses import get_classification_loss_fn, get_mask_loss_fn
from ..models.build import init_weights
from ..utils.checkpoint import BestCheckpointer, RollingSaver, load_checkpoint
from ..utils.logging import MetricLogger, input_stats
from ..utils.visualize import visualize_mask_triplet
from .fusion import make_fusion_eval_step, make_fusion_train_step
from .optim import (FusionOptController, SingleModelOptController, build_fusion_group_spec,
                    build_group_spec, describe_groups)
from .schedule import (EarlyStopping, ReduceLROnPlateau, WarmupCosine, aux_loss_weight,
                       make_scheduler)
from .single import make_single_eval_step, make_single_train_step
from .state import TrainState


# epochs between rolling resume checkpoints: the JAX loop's ``viz_every``
# default, which paces both its mask figure and its rolling save; here the
# figure has its own ``viz_every`` and the save keeps these epochs
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
               resume_from: Optional[str] = None, viz_every: int = 10) -> FitResult:
    """Train one encoder; returns the final and best states and the history.

    ``train_data``/``val_data``: raw (unprocessed) ``imgs``, optional
    ``masks`` (at ``mask_target_size``) and ``adc``, and ``labels``.
    ``resume_from``: a checkpoint to restore first (``load_checkpoint``).
    Augmentation and dropout draw from generators on the model's device
    seeded from ``seed``; the shuffle is ``np.random.RandomState(seed)``, the
    JAX loop's order.  Every ``viz_every`` epochs (0: never) the mask
    triptych of the first validation sample is drawn.
    """
    run = single_fit_run(cfg, method, state, train_data, val_data, processor, controller,
                         workdir, clf_loss_fn, num_epochs, min_epochs, seed, resume_from,
                         viz_every)
    return drive_lockstep([run])[0]


def single_fit_run(cfg: Config, method: str, state: TrainState,
                   train_data: Dict[str, Optional[np.ndarray]],
                   val_data: Dict[str, Optional[np.ndarray]],
                   processor: ModalityProcessor, controller: SingleModelOptController,
                   workdir: str, clf_loss_fn=None, num_epochs: Optional[int] = None,
                   min_epochs: Optional[int] = None, seed: int = 0,
                   resume_from: Optional[str] = None, viz_every: int = 10) -> "FitRun":
    """The :class:`FitRun` of :func:`fit_single` (same arguments), not yet
    driven.  ``clf_loss_fn`` defaults to the classification loss with the
    class weights of ``train_data``'s labels."""
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

    def draw(path: str, title: str) -> None:
        with torch.no_grad():
            _, _, mask_pred = model(to_model(val_imgs[:1], model))
        visualize_mask_triplet(_host(val_imgs[0]), _host(val_data["masks"][0]),
                               _host(mask_pred[0].permute(1, 2, 0)), path,
                               title_prefix=f"{title}, sample: ")

    drawn = viz_every if mc.mask.enabled and val_data.get("masks") is not None else 0
    return FitRun(cfg, mc.scheduler, mc.optimizer.lr, state, spec, controller,
                  make_single_train_step(cfg, method, clf_loss_fn, mask_loss_fn, spec),
                  make_single_eval_step(cfg, method, clf_loss_fn, mask_loss_fn),
                  train_ds, val_ds, prepare, workdir, num_epochs, min_epochs, seed,
                  draw, drawn)


def fit_fusion(cfg: Config, state: TrainState, train_data: Dict[str, Optional[np.ndarray]],
               val_data: Dict[str, Optional[np.ndarray]], workdir: str, clf_loss_fn=None,
               num_epochs: Optional[int] = None, min_epochs: Optional[int] = None,
               seed: int = 0, viz_every: int = 10) -> FitResult:
    """Train the fusion network (``state.model``, a
    :class:`~.fusion.FusionNetwork`) with the gradual deep->shallow unfreeze
    of :class:`~.optim.FusionOptController`; returns the final and best
    states and the history (run_training.py:181-263).

    ``train_data``/``val_data``: **processed** ``dwi`` and ``dce`` stacks
    (the splits ``export_processed_splits`` writes), optional ``masks``, and
    ``labels``.  Dropout draws from a generator on the model's device seeded
    from ``seed``; the shuffle is ``np.random.RandomState(seed)``.  Every
    ``viz_every`` epochs (0: never) the fused mask head's triptych of the
    first validation sample is drawn (the hook the reference leaves
    single-model-only, train.py:706-714).
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

    def draw(path: str, title: str) -> None:
        net = state.model
        with torch.no_grad():
            _, fused_mask, _, _ = net(to_model(val_data["dwi"][:1], net),
                                      to_model(val_data["dce"][:1], net))
        visualize_mask_triplet(_host(val_data["dwi"][0]), _host(val_data["masks"][0]),
                               _host(fused_mask[0].permute(1, 2, 0)), path,
                               title_prefix=f"{title}, fused mask: ")

    drawn = viz_every if fp.mask.enabled and val_data.get("masks") is not None else 0
    run = FitRun(cfg, fp.scheduler, fp.optimizer.lr, state, spec, FusionOptController(cfg),
                 make_fusion_train_step(cfg, clf_loss_fn, mask_loss_fn, spec),
                 make_fusion_eval_step(cfg, clf_loss_fn, mask_loss_fn),
                 dataset(train_data), dataset(val_data), prepare, workdir, num_epochs,
                 min_epochs, seed, draw, drawn)
    return drive_lockstep([run])[0]


class FitRun:
    """One fit's streams, state and control plane: the epoch body that both
    fits share, driven by :func:`drive_lockstep` (alone by ``fit_single``
    and ``fit_fusion``, K at a time by ``fit_single_multifold``).

    ``prepare(batch) -> (step batch, the inputs whose statistics the first
    batch prints)``.  Dropout draws from a generator on the model's device
    seeded with ``seed + 1``; the shuffle is ``np.random.RandomState(seed)``.
    ``draw(path, title)`` writes the mask triptych at the epochs that are
    multiples of ``viz_every`` (0: never).
    """

    def __init__(self, cfg: Config, scheduler_cfg, base_lr: float, state: TrainState, spec,
                 controller, train_step, eval_step, train_ds: ArrayDataset,
                 val_ds: ArrayDataset, prepare: Callable, workdir: str,
                 num_epochs: Optional[int], min_epochs: Optional[int], seed: int,
                 draw: Optional[Callable[[str, str], None]] = None, viz_every: int = 0):
        self.cfg, self.scheduler_cfg, self.state, self.controller = (cfg, scheduler_cfg,
                                                                      state, controller)
        self.workdir, self.draw, self.viz_every = workdir, draw, viz_every
        self.train_step, self.eval_step, self.prepare = train_step, eval_step, prepare
        self.train_ds, self.val_ds = train_ds, val_ds
        device = next(state.model.parameters()).device
        self.num_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
        self.min_epochs = min(min_epochs if min_epochs is not None else cfg.min_epochs,
                              self.num_epochs)
        if cfg.debug_training:
            # the optimizer-group dump (selector_helpers.py:336-353)
            print(describe_groups(dict(state.model.named_parameters()), spec,
                                  controller.hyperparams()))
        self.scheduler = make_scheduler(scheduler_cfg, base_lr)
        self.early = EarlyStopping(mode=cfg.early_stopping.mode,
                                   patience=cfg.early_stopping.patience,
                                   min_delta=cfg.early_stopping.min_delta)
        self.ckpt = BestCheckpointer(f"{workdir}/checkpoints", monitor="val_acc", mode="max")
        self.roll = RollingSaver(f"{workdir}/checkpoints")
        self.logger = MetricLogger(f"{workdir}/logs")
        self.stage_train = device if device_data_auto(train_ds, device, cfg.device_data) else None
        self.stage_val = device if device_data_auto(val_ds, device, cfg.device_data) else None
        self.drop_gen = torch.Generator(device).manual_seed(seed + 1)
        self.np_rng = np.random.RandomState(seed)
        self.timed = device.type == "cuda"
        self.history: list = []
        self.step_ms: List[Tuple[float, float]] = []
        self.best_state: Optional[TrainState] = None
        self.global_step = 0
        self.done = False

    def start_epoch(self, epoch: int) -> Iterator:
        """Open ``epoch``: the controller's groups, the aux weight; returns its
        train batches (the tail batch at its short size)."""
        cfg = self.cfg
        self.epoch, self.t0 = epoch, time.time()
        self.controller.on_epoch_start(epoch)
        self.hp = self.controller.hyperparams()
        self.aux_w = aux_loss_weight(epoch, cfg.aux_loss_weight_epoch_limit,
                                     cfg.use_simple_aux_loss_scheduling)
        self.pending = []  # (device metrics, batch size, events) per step
        self.epoch_step0 = self.global_step
        return iter(iterate_batches(self.train_ds, cfg.batch_size, shuffle=True,
                                    rng=self.np_rng, device=self.stage_train,
                                    native=cfg.use_native_loader))

    def step(self, batch) -> None:
        """One train step on ``batch``; its metrics are read at the epoch's end."""
        if isinstance(self.scheduler, WarmupCosine):
            # stepped per step (selector_helpers.py:319-330)
            self.controller.lr_scale = self.scheduler.step_scale(self.global_step)
            self.hp = self.controller.hyperparams()
        self.global_step += 1
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
                  if self.timed else [])
        if events:
            events[0].record()
        proc, inputs = self.prepare(batch)
        proc = dict(proc, aux_w=self.aux_w)
        if events:
            events[1].record()
        if self.cfg.debug_training and self.global_step == 1:
            # the first batch's normalisation check (train.py:1074-1079)
            print(input_stats(inputs, proc.get("masks")))
        metrics = self.train_step(self.state, proc, self.drop_gen, self.hp)
        if events:
            events[2].record()
        self.pending.append((metrics, len(batch["labels"]), events))

    def end_epoch(self) -> None:
        """Read the epoch's step metrics, validate, and run the control plane
        (lr, best and rolling checkpoints, logs, early stopping: sets
        ``done``)."""
        cfg, epoch, hp = self.cfg, self.epoch, self.hp
        train_meters: Dict[str, MeanMetric] = {}
        for i, (metrics, n, events) in enumerate(self.pending):
            values = {k: float(v) for k, v in metrics.items()}
            _warn_nonfinite(values, epoch, self.epoch_step0 + i + 1)
            for k, v in values.items():
                train_meters.setdefault(k, MeanMetric()).update(v, weight=n)
            if events:
                self.step_ms.append((events[0].elapsed_time(events[1]),
                                     events[1].elapsed_time(events[2])))
        self.pending = []
        epoch_metrics = {f"train_{k}": m.compute() for k, m in train_meters.items()}
        epoch_metrics["train_time"] = time.time() - self.t0

        # ---- validation ----
        val_meters: Dict[str, MeanMetric] = {}
        all_probs = []
        for batch in iterate_batches(self.val_ds, cfg.batch_size, device=self.stage_val):
            _, probs, metrics = self.eval_step(self.state, batch)
            all_probs.append(probs.cpu().numpy())
            for k, v in metrics.items():
                val_meters.setdefault(k, MeanMetric()).update(float(v),
                                                              weight=len(batch["labels"]))
        epoch_metrics.update({f"val_{k}": m.compute() for k, m in val_meters.items()})
        epoch_metrics.update(classification_report(
            np.concatenate(all_probs),
            np.asarray(self.val_ds.arrays["labels"]).astype(np.int64), cfg.class_num, "val_"))
        epoch_metrics["lr_scale"] = self.controller.lr_scale
        epoch_metrics["aux_w"] = self.aux_w
        epoch_metrics["epoch_time"] = time.time() - self.t0
        # the per-group lr and trainable flag of this epoch (the reference's
        # LearningRateMonitor(logging_interval='epoch'), run_training.py:36)
        epoch_metrics["group_lrs"] = hp.lr.tolist()
        epoch_metrics["group_trainable"] = hp.trainable.tolist()

        # ---- control plane ----
        scheduler = self.scheduler
        if isinstance(scheduler, ReduceLROnPlateau):
            monitored = epoch_metrics.get(self.scheduler_cfg.monitor, epoch_metrics["val_loss"])
            if scheduler.step_reduced(monitored):
                self.controller.apply_plateau(scheduler.factor, scheduler.min_lr)
        elif not isinstance(scheduler, WarmupCosine):  # that one steps per step
            self.controller.lr_scale = scheduler.step_scale(epoch)

        # ---- the mask triptych (train.py:706-714), outside the timed steps ----
        if self.draw is not None and self.viz_every and epoch % self.viz_every == 0:
            self.draw(f"{self.workdir}/viz/epoch_{epoch:04d}.png", f"Epoch {epoch}")

        if self.ckpt.maybe_save(self.state, epoch_metrics, epoch):
            self.best_state = self.state.copy()
        if epoch % ROLL_EVERY == 0:
            self.roll.save(self.state)

        self.history.append(epoch_metrics)
        self.logger.log_epoch(epoch, epoch_metrics)
        stop_metric = epoch_metrics.get(cfg.early_stopping.metric)
        self.done = (stop_metric is not None and self.early.step(stop_metric)
                     and epoch + 1 >= self.min_epochs)

    def result(self) -> FitResult:
        return FitResult(state=self.state, best_state=self.best_state, history=self.history,
                         train_metrics=self.history[-1] if self.history else {},
                         step_ms=self.step_ms)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def drive_lockstep(runs: Sequence[FitRun]) -> List[FitResult]:
    """Drive fits epoch by epoch in lockstep: each epoch, one train step of
    each live fit in turn until every live fit has used up its epoch, then
    each live fit's validation and control plane.  A fit that has stopped
    (early stopping, or past its ``num_epochs``) is skipped in train and
    validation;
    a fit whose epoch is shorter draws nothing once its batches are used
    up.  Fits share nothing (streams, state, checkpoints), so each result
    equals its fit driven alone."""
    epoch = 0
    while True:
        live = [r for r in runs if not r.done and epoch < r.num_epochs]
        if not live:
            break
        iters = [(r, r.start_epoch(epoch)) for r in live]
        while iters:
            left = []
            for r, batches in iters:
                batch = next(batches, None)
                if batch is not None:
                    r.step(batch)
                    left.append((r, batches))
            iters = left
        for r in live:
            r.end_epoch()
        epoch += 1
    return [r.result() for r in runs]
