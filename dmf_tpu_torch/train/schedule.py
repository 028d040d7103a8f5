"""Host-side LR schedulers and early stopping, the port's copy of
``dmf_tpu/train/schedule.py`` (stdlib only; held equal by
``tests/test_torch_train.py``).

They run outside the train step and only produce scalars (an lr multiplier,
a reduce event, a stop decision) that the step takes as data.  Reference
counterparts: torch ReduceLROnPlateau / CosineAnnealingLR / warmup-cosine
(selector_helpers.py:292-332) and Lightning EarlyStopping
(run_training.py:44-54).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Multiplicative plateau scheduler (torch semantics, mode='min',
    threshold_mode='rel')."""

    factor: float = 0.5
    patience: int = 35
    min_lr: float = 4e-7
    threshold: float = 1e-4
    base_lr: float = 1e-4  # largest group lr; min_lr is enforced on scale

    scale: float = 1.0
    best: float = math.inf
    num_bad_epochs: int = 0
    last_reduced: bool = False

    def step(self, metric: float) -> float:
        """Advance one epoch; returns the global scale (single-group view).

        Multi-group callers should use :meth:`step_reduced` + the
        controller's ``apply_plateau`` instead: torch mutates each param
        group's CURRENT lr at a reduction event, so groups added later by
        unfreeze join fresh and the ``min_lr`` clamp is absolute per
        group — a single global scale cannot represent that.
        """
        self.last_reduced = False
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.scale = max(self.scale * self.factor, self.min_lr / self.base_lr)
            self.num_bad_epochs = 0
            self.last_reduced = True
        return self.scale

    def step_reduced(self, metric: float) -> bool:
        """Advance one epoch; True iff this epoch triggers a reduction."""
        self.step(metric)
        return self.last_reduced


@dataclasses.dataclass
class CosineAnnealing:
    """CosineAnnealingLR as a scale in [eta_min/base, 1]."""

    t_max: int = 900
    eta_min: float = 0.0
    base_lr: float = 1e-4

    def step_scale(self, epoch: int) -> float:
        frac = self.eta_min / self.base_lr
        return frac + (1 - frac) * 0.5 * (1 + math.cos(math.pi * epoch / self.t_max))


@dataclasses.dataclass
class WarmupCosine:
    """Per-step warmup then cosine decay (selector_helpers.py:319-330)."""

    warmup_steps: int = 500
    max_steps: int = 10000

    def step_scale(self, step: int) -> float:
        if step < self.warmup_steps:
            return step / float(self.warmup_steps)
        progress = (step - self.warmup_steps) / float(
            self.max_steps - self.warmup_steps
        )
        return 0.5 * (1 + math.cos(math.pi * progress))


def make_scheduler(sch_cfg, base_lr: float):
    name = sch_cfg.name.lower()
    if name == "reduce_lr_on_plateau":
        return ReduceLROnPlateau(
            factor=sch_cfg.factor,
            patience=sch_cfg.patience,
            min_lr=sch_cfg.min_lr,
            threshold=sch_cfg.threshold,
            base_lr=base_lr,
        )
    if name == "cosine":
        return CosineAnnealing(t_max=sch_cfg.t_max, eta_min=sch_cfg.eta_min,
                               base_lr=base_lr)
    if name == "cosine_with_warmup":
        return WarmupCosine(warmup_steps=sch_cfg.warmup_steps,
                            max_steps=sch_cfg.max_steps)
    raise ValueError(f"Unknown scheduler: {sch_cfg.name}")


@dataclasses.dataclass
class EarlyStopping:
    """Lightning-style early stopping on a monitored metric."""

    mode: str = "max"
    patience: int = 90
    min_delta: float = 1e-4

    best: Optional[float] = None
    wait: int = 0
    should_stop: bool = False

    def step(self, metric: float) -> bool:
        if self.best is None:
            self.best = metric
            return False
        improved = (
            metric > self.best + self.min_delta
            if self.mode == "max"
            else metric < self.best - self.min_delta
        )
        if improved:
            self.best = metric
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.should_stop = True
        return self.should_stop


def aux_loss_weight(epoch: int, limit: int, enabled: bool = True) -> float:
    """Aux-loss weight schedule ``max(0, 1 - epoch/limit)`` (train.py:321-324)."""
    if not enabled:
        return 1.0
    return max(0.0, 1.0 - epoch / limit)
