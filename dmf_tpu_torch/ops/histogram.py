"""Histogram percentiles for the Nyul transform: wrapper and plain version.

Counterpart of ``dmf_tpu/ops/histogram_pallas.py``: the Pallas kernel
``_percentile_kernel`` via ``histogram_percentiles_pallas`` and the transform
``nyul_transform_pallas`` built on it.  The wrapper runs the plain version
below for tensors on the CPU and the CUDA kernel in
``csrc/histogram_percentiles.cu`` (one launch, a cluster of 8 blocks a row)
for tensors on a CUDA device; there is no fallback from one to the other.  As in the JAX package, no served path
dispatches it: DCE serving runs ``data/preprocess.py::nyul_transform_fast``.

Per row of ``flat`` (G, P): a 4096-bin histogram between the row's min and
max, its CDF, and each percent read off the CDF with linear interpolation
inside the bin (histogram_pallas.py:40-116).  The result is within
``span / 4096`` of the exact percentile.  Unlike the TPU kernel, any P >= 2
is accepted (the TPU kernel needed a multiple of 8192).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .cuda_build import load_library

_SOURCES = ("histogram_percentiles.cu",)
NBINS = 4096


def piecewise_map(x: torch.Tensor, knots_x: torch.Tensor,
                  knots_y: torch.Tensor) -> torch.Tensor:
    """Monotone piecewise-linear map (np.interp's clamped behaviour).

    ``x`` (..., C); ``knots_x`` (..., C, L); ``knots_y`` (L,)."""
    x0 = knots_x[..., :-1]
    dx = (knots_x[..., 1:] - x0).clamp(min=1e-12)
    dy = knots_y[1:] - knots_y[:-1]
    t = ((x[..., None] - x0) / dx).clamp(0.0, 1.0)
    return knots_y[0] + (t * dy).sum(dim=-1)


@functools.lru_cache(maxsize=16)
def _fractions_on(percents: tuple, device: torch.device) -> torch.Tensor:
    # p / 100 in double, then fp32, as histogram_pallas.py:132-133; cached so
    # that a launch makes no host-to-device copy (the tensor is only read)
    return torch.tensor([p / 100.0 for p in percents], dtype=torch.float32, device=device)


def _fractions(percents: Sequence[float], device) -> torch.Tensor:
    return _fractions_on(tuple(float(p) for p in percents), torch.device(device))


def histogram_percentiles_ref(flat: torch.Tensor, percents: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version: ``flat`` (G, P) -> (G, L) fp32."""
    x = flat.float()
    G, P = x.shape
    mn = x.min(dim=1, keepdim=True).values
    mx = x.max(dim=1, keepdim=True).values
    span = (mx - mn).clamp(min=1e-12)
    idx = ((x - mn) / span * NBINS).clamp(0, NBINS - 1).floor().long()
    hist = torch.zeros((G, NBINS), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx))
    cdf = hist.cumsum(dim=1).float()
    tgt = _fractions(percents, x.device) * (P - 1) + 1.0  # (L,)
    # #(cdf < tgt): the CDF is sorted, so a left search counts it
    bins = torch.searchsorted(cdf, tgt.expand(G, -1).contiguous()).clamp(0, NBINS - 1)
    c_hi = torch.gather(cdf, 1, bins)
    c_lo = torch.where(bins > 0, torch.gather(cdf, 1, (bins - 1).clamp(min=0)), 0.0)
    frac = ((tgt - c_lo) / (c_hi - c_lo).clamp(min=1.0)).clamp(0.0, 1.0)
    return mn + (bins.float() + frac) / NBINS * span


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("histogram_percentiles", _SOURCES)
    fn = lib.histogram_percentiles_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.histogram_percentiles_resident_clusters.argtypes = [ctypes.c_longlong]
    lib.histogram_percentiles_resident_clusters.restype = ctypes.c_int
    return lib


def histogram_percentiles(flat: torch.Tensor, percents: Sequence[float]) -> torch.Tensor:
    """Per-row percentiles (``percents`` in [0, 100]) of ``flat`` (G, P) -> (G, L).

    CPU tensors take :func:`histogram_percentiles_ref`.  CUDA tensors launch
    the kernel, which takes contiguous fp32 rows with 2 <= P < 2^24 and
    raises on anything else.
    """
    if flat.device.type == "cpu":
        return histogram_percentiles_ref(flat, percents)
    if flat.device.type != "cuda":
        raise ValueError(f"histogram_percentiles: unsupported device {flat.device}")
    if flat.dim() != 2 or flat.dtype != torch.float32:
        raise ValueError(f"histogram_percentiles: need (G, P) fp32 rows, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    if not flat.is_contiguous():
        raise ValueError("histogram_percentiles: rows must be contiguous")
    G, P = flat.shape
    if not 2 <= P < 2 ** 24 or G >= 2 ** 31:
        raise ValueError(f"histogram_percentiles: need 2 <= P < 2^24 (fp32-exact "
                         f"counts) and G < 2^31, got G={G}, P={P}")
    pct = _fractions(percents, flat.device)
    out = torch.empty((G, pct.numel()), dtype=torch.float32, device=flat.device)
    lib = _library()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = lib.histogram_percentiles_launch(flat.data_ptr(), pct.data_ptr(),
                                              out.data_ptr(), G, P, pct.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"histogram_percentiles: kernel launch failed (CUDA error {rc})")
    histogram_percentiles.launches += 1
    return out


histogram_percentiles.launches = 0


def nyul_transform_hist(img: torch.Tensor, percents: Sequence[float],
                        standard_scale) -> torch.Tensor:
    """Nyul transform of (H, W, C) or (B, H, W, C) images through the
    histogram percentiles, as ``nyul_transform_pallas``: each image's
    per-channel landmarks map piecewise-linearly onto ``standard_scale``.

    The rows are the (B*C, H*W) transpose of the image, made as a contiguous
    copy (histogram_pallas.py:169).  Returns fp32.
    """
    single = img.dim() == 3
    x = (img[None] if single else img).float()
    B, H, W, C = x.shape
    flat = x.permute(0, 3, 1, 2).reshape(B * C, H * W).contiguous()
    perc = histogram_percentiles(flat, percents)  # (B*C, L)
    scale = torch.as_tensor(standard_scale, dtype=torch.float32, device=x.device)
    out = piecewise_map(x, perc.reshape(B, 1, 1, C, -1), scale)
    return out[0] if single else out
