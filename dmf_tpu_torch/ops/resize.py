"""Spatial resize and pooling helpers (NCHW, except ``resize_nearest``: NHWC).

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


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC (or HWC) images, torch's ``mode='nearest'``
    index map ``src = floor(dst * in / out)`` (resize.py:35-45)."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out):
        return x
    rows = torch.floor(torch.arange(h_out, device=x.device) * (h_in / h_out)).long()
    cols = torch.floor(torch.arange(w_out, device=x.device) * (w_in / w_out)).long()
    return x.index_select(-3, rows).index_select(-2, cols)


def adaptive_avg_pool(x: torch.Tensor, out_size: Sequence[int]) -> torch.Tensor:
    """``AdaptiveAvgPool2d`` over the last two dims.

    Where the output is an integer multiple of the input in both dims (the
    projectors' 32 -> 64), each output pixel's window is one input pixel:
    that is the nearest upsample, the same values.  Where the input is an
    integer multiple of the output (the fusion head's 32 -> 4), the windows
    tile the input: that is ``avg_pool2d`` with kernel = stride = the ratio,
    the same values.  Both backwards sum each input pixel's gradients in a
    fixed order, where the card's ``adaptive_avg_pool2d`` backward adds them
    by atomics, so a train step would not repeat bit for bit."""
    size = tuple(out_size)
    h, w = x.shape[-2:]
    if (h, w) == size:
        return x
    if size[0] % h == 0 and size[1] % w == 0:
        return F.interpolate(x, size=size, mode="nearest")
    if h % size[0] == 0 and w % size[1] == 0:
        ratio = (h // size[0], w // size[1])
        return F.avg_pool2d(x, ratio, ratio)
    return F.adaptive_avg_pool2d(x, size)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial dims of (N, C, H, W) -> (N, C)."""
    return x.mean(dim=(-2, -1))
