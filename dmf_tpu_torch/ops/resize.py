"""Spatial resize and pooling helpers (NCHW).

Counterpart of ``dmf_tpu/ops/resize.py``.  ``resize_bilinear`` is
``F.interpolate(mode='bilinear', align_corners=False)``, which the JAX
helper was written to match; ``adaptive_avg_pool`` is torch's own adaptive
pooling, whose windows (``start=floor(i*in/out)``, ``end=ceil((i+1)*in/out)``)
the JAX helper's general branch reproduces, including the 32->64 upsampling
the projector pools use.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) maps to spatial ``size``."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


def adaptive_avg_pool(x: torch.Tensor, out_size: Sequence[int]) -> torch.Tensor:
    """``AdaptiveAvgPool2d`` over the last two dims."""
    if tuple(x.shape[-2:]) == tuple(out_size):
        return x
    return F.adaptive_avg_pool2d(x, tuple(out_size))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial dims of (N, C, H, W) -> (N, C)."""
    return x.mean(dim=(-2, -1))
