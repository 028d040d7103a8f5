"""Segmentation-mask losses, counterparts of ``dmf_tpu/losses/mask.py``.

``SoftDiceLoss`` (loss.py:45-62), ``DiceBCELoss`` (loss.py:11-43) and
``safe_mask_loss`` (train_fusion.py:747-760) on (B, 1, H, W) logits and
targets.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def soft_dice_loss(logits: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Soft dice over sigmoid probabilities, per sample then meaned."""
    probs = torch.sigmoid(logits)
    axes = tuple(range(1, probs.dim()))
    intersection = (probs * targets).sum(dim=axes)
    union = probs.sum(dim=axes) + targets.sum(dim=axes)
    return 1.0 - ((2.0 * intersection + eps) / (union + eps)).mean()


def dice_bce_loss(logits: torch.Tensor, targets: torch.Tensor, bce_weight: float = 1.0,
                  dice_weight: float = 1.0, eps: float = 1e-6) -> torch.Tensor:
    """Foreground dice + BCE with logits; the dice numerator carries no
    ``eps`` (loss.py:36-38)."""
    bce = F.binary_cross_entropy_with_logits(logits, targets)
    probs = torch.sigmoid(logits)
    axes = tuple(range(1, probs.dim()))
    intersection = (probs * targets).sum(dim=axes)
    denom = probs.sum(dim=axes) + targets.sum(dim=axes) + eps
    return bce_weight * bce + dice_weight * (1.0 - (2.0 * intersection / denom).mean())


def safe_mask_loss(pred_logits: torch.Tensor, gt_mask: torch.Tensor,
                   mask_loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                   ) -> torch.Tensor:
    """The mask loss against the ground truth resized (nearest) to the
    prediction's size where they differ, the JAX package's fixed behaviour
    (mask.py:52-73)."""
    if pred_logits.shape[-2:] != gt_mask.shape[-2:]:
        size = pred_logits.shape[-2:]
        gt_mask = F.interpolate(gt_mask, size=tuple(size), mode="nearest")
    return mask_loss_fn(pred_logits, gt_mask)
