"""DWI per-image, per-channel z-score: wrapper and plain version.

Counterpart of ``dmf_tpu/ops/preprocess_pallas.py::dwi_normalize_pallas``
(the Pallas kernel ``_dwi_norm_kernel``) and of the XLA route
``dmf_tpu/data/preprocess.py::dwi_normalize``, which computes the same
function.  The wrapper runs the plain version below for tensors on the CPU,
and the CUDA kernel ``csrc/dwi_norm.cu`` (through ``dwi_norm_cuda.py``) for
tensors on a CUDA device; there is no fallback from one to the other.

Numerics follow the TPU kernel (preprocess_pallas.py:30-43): the statistics
and the normalisation run in fp32 on the upcast input, the unbiased (ddof=1)
std is floored at 1e-6, and the result is rounded once to the input dtype.
Images are NHWC ``(N, H, W, C)``, statistics per (image, channel).
"""

from __future__ import annotations

from typing import Tuple

import torch


def dwi_normalize_ref(img: torch.Tensor, clip_z: Tuple[float, float] = (-3.0, 3.0),
                      skip_last: bool = True, zero_last: bool = False) -> torch.Tensor:
    """Plain PyTorch version for ``(..., H, W, C)`` images.

    ``skip_last`` leaves the last channel as it is; ``zero_last`` zeroes it
    instead, the reference's effective behaviour (preprocess.py:41-67).
    """
    z_lo, z_hi = clip_z
    x = img.float()
    mean = x.mean(dim=(-3, -2), keepdim=True)
    std = x.std(dim=(-3, -2), keepdim=True, unbiased=True).clamp(min=1e-6)
    z = ((x - mean) / std).clamp(z_lo, z_hi)
    out = ((z - z_lo) / (z_hi - z_lo)).to(img.dtype)
    if skip_last:
        last = torch.zeros_like(img[..., -1:]) if zero_last else img[..., -1:]
        out = torch.cat([out[..., :-1], last], dim=-1)
    return out


def dwi_normalize(img: torch.Tensor, clip_z: Tuple[float, float] = (-3.0, 3.0),
                  skip_last: bool = True, zero_last: bool = False) -> torch.Tensor:
    """Per-image, per-channel z-score (unbiased std) -> clip -> [0, 1].

    CPU tensors take :func:`dwi_normalize_ref`.  CUDA tensors launch the
    CUDA kernel, which takes contiguous ``(N, H, W, C)`` fp32, bf16 or fp16
    images and raises on anything else; the output has the input's dtype.
    """
    if img.device.type == "cpu":
        return dwi_normalize_ref(img, clip_z, skip_last, zero_last)
    if img.device.type != "cuda":
        raise ValueError(f"dwi_normalize: unsupported device {img.device}")
    from .dwi_norm_cuda import launch_dwi_normalize

    out = launch_dwi_normalize(img, clip_z, skip_last, zero_last)
    dwi_normalize.launches += 1
    return out


dwi_normalize.launches = 0
