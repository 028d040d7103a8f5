"""Classification losses, counterparts of ``dmf_tpu/losses/classification.py``.

The reference's loss classes (loss.py:66-213) and class-weight computation
(selector_helpers.py:25-41) as plain functions of ``(logits (B, C),
targets)``; ``targets`` are class indices (B,) or a (B, C) distribution.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def label_smoothing(labels: torch.Tensor, num_classes: int, alpha: float) -> torch.Tensor:
    """Smoothed targets (loss.py:190-213): ``alpha / (C - 1)`` everywhere,
    ``1 - alpha`` on the true class."""
    onehot = F.one_hot(labels.long(), num_classes).float()
    return onehot * (1.0 - alpha) + (1.0 - onehot) * (alpha / (num_classes - 1))


def _soft_targets(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    if targets.dim() == 1:
        return F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
    return targets


def soft_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                    gamma: float = 2.0) -> torch.Tensor:
    """``SoftFocalLoss`` (loss.py:133-155)."""
    return soft_weighted_focal_loss(logits, targets, gamma, None)


def soft_weighted_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                             gamma: float = 2.0,
                             class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``SoftWeightedFocalLoss`` (loss.py:157-187), the reference default
    (``wfl``): the class weight multiplies the focal weight per class."""
    targets = _soft_targets(logits, targets)
    log_probs = F.log_softmax(logits, dim=-1)
    focal_weight = (1.0 - log_probs.exp()) ** gamma
    if class_weights is not None:
        focal_weight = focal_weight * class_weights.to(logits.device).reshape(1, -1)
    return -(targets * focal_weight * log_probs).sum(dim=-1).mean()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0,
               gamma: float = 2.0) -> torch.Tensor:
    """Hard-label ``FocalLoss`` (loss.py:66-84)."""
    ce = -F.log_softmax(logits, dim=-1).gather(-1, labels.long()[:, None])[:, 0]
    return (alpha * (1.0 - torch.exp(-ce)) ** gamma * ce).mean()


def weighted_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                        class_weights: Optional[torch.Tensor] = None,
                        gamma: float = 2.0) -> torch.Tensor:
    """Per-class-alpha ``WeightedFocalLoss`` (loss.py:87-130)."""
    idx = labels.long()
    ce = -F.log_softmax(logits, dim=-1).gather(-1, idx[:, None])[:, 0]
    alpha = class_weights.to(logits.device)[idx] if class_weights is not None else 1.0
    return (alpha * (1.0 - torch.exp(-ce)) ** gamma * ce).mean()


def compute_class_weights(train_labels, num_classes: int) -> torch.Tensor:
    """Inverse class frequencies ``total / (C * (counts + 1e-6))``
    (selector_helpers.py:31-36), fp32 on the CPU."""
    labels = np.asarray(train_labels).astype(np.int64)
    counts = np.bincount(labels, minlength=num_classes)[:num_classes].astype(np.float32)
    return torch.from_numpy(np.float32(len(labels)) / (num_classes * (counts + np.float32(1e-6))))
