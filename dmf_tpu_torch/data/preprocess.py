"""Serving preprocessing on the device, counterpart of ``dmf_tpu/data/preprocess.py``.

The serving subset: per-image DWI z-scoring, the ADC channel, and the fast
Nyul transform for DCE, composed as bench.py:616-625 composes them.  None of
it is a TPU kernel on the JAX main path, so it is plain torch.  Images are
channels-last ``(..., H, W, C)`` tensors, as in the JAX package.

``_histogram_percentiles`` reproduces the JAX estimator exactly, but counts
``x <= edge`` with a sort and ``searchsorted`` instead of a broadcast compare
(which would materialize a pixels x edges tensor in eager PyTorch).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.resize import resize_bilinear

DEFAULT_LANDMARKS = (1, 10, 25, 30, 40, 50, 60, 75, 80, 90, 99)


def dwi_normalize(img: torch.Tensor, clip_z: Tuple[float, float] = (-3.0, 3.0),
                  skip_last: bool = True, zero_last: bool = False) -> torch.Tensor:
    """Per-image, per-channel z-score (unbiased std) -> clip -> [0, 1].

    ``skip_last`` leaves the last channel as it is; ``zero_last`` zeroes it
    instead, the reference's effective behaviour (preprocess.py:41-67).
    """
    z_lo, z_hi = clip_z
    mean = img.mean(dim=(-3, -2), keepdim=True)
    std = img.std(dim=(-3, -2), keepdim=True, unbiased=True).clamp(min=1e-6)
    z = ((img - mean) / std).clamp(z_lo, z_hi)
    out = (z - z_lo) / (z_hi - z_lo)
    if skip_last:
        last = torch.zeros_like(img[..., -1:]) if zero_last else img[..., -1:]
        out = torch.cat([out[..., :-1], last], dim=-1)
    return out


def append_adc(img: torch.Tensor, adc_map: torch.Tensor) -> torch.Tensor:
    """Resize the (H, W, 1) or (N, H, W, 1) ADC map to the image and concat
    it as the last channel."""
    adc = adc_map.unsqueeze(0) if adc_map.dim() == 3 else adc_map
    adc = resize_bilinear(adc.permute(0, 3, 1, 2), img.shape[-3:-1]).permute(0, 2, 3, 1)
    if img.dim() == 4 and adc.shape[0] == 1:
        adc = adc.expand(img.shape[0], *adc.shape[1:])
    elif img.dim() == 3:
        adc = adc[0]
    return torch.cat([img, adc.to(img.dtype)], dim=-1)


def _piecewise_map(x: torch.Tensor, knots_x: torch.Tensor,
                   knots_y: torch.Tensor) -> torch.Tensor:
    """Monotone piecewise-linear map (np.interp's clamped behaviour).

    ``x`` (..., C); ``knots_x`` (..., C, L); ``knots_y`` (L,)."""
    x0 = knots_x[..., :-1]
    dx = (knots_x[..., 1:] - x0).clamp(min=1e-12)
    dy = knots_y[1:] - knots_y[:-1]
    t = ((x[..., None] - x0) / dx).clamp(0.0, 1.0)
    return knots_y[0] + (t * dy).sum(dim=-1)


def _count_le(sorted_x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``#(x <= edge)`` per row: ``sorted_x`` (G, P), ``edges`` (G, ...)."""
    flat = edges.reshape(edges.shape[0], -1).contiguous()
    cnt = torch.searchsorted(sorted_x, flat, right=True)
    return cnt.to(torch.float32).reshape(edges.shape)


def _histogram_percentiles(flat: torch.Tensor, q: torch.Tensor,
                           bins: int = 128) -> torch.Tensor:
    """Per-channel percentile estimate of ``flat`` (N, P, C); returns (N, C, L).

    Two rounds of CDF counting at uniform value edges, as the JAX estimator
    (preprocess.py:249-308): round 1 finds each target rank's coarse bin,
    round 2 subdivides it, then linear interpolation between sub-edges.
    """
    N, P, C = flat.shape
    L = q.shape[0]
    x = flat.float().transpose(1, 2).reshape(N * C, P)
    sx = torch.sort(x, dim=-1).values.contiguous()
    mn = sx[:, 0]
    mx = sx[:, -1]
    span = (mx - mn).clamp(min=1e-12)
    target = (q.float() / 100.0 * (P - 1)).float()
    sub_bins = max(1024 // bins, 4)

    s = torch.arange(bins + 1, dtype=torch.float32, device=x.device) / bins
    edges1 = mn[:, None] + span[:, None] * s[None, :]
    cdf1 = _count_le(sx, edges1)
    idx1 = (cdf1[:, None, :] < (target[None, :, None] + 1.0)).float().sum(-1)
    idx1 = idx1.clamp(1.0, bins)
    lo = mn[:, None] + span[:, None] * (idx1 - 1.0) / bins
    width = span[:, None] / bins

    s2 = torch.arange(sub_bins + 1, dtype=torch.float32, device=x.device) / sub_bins
    edges2 = lo[:, :, None] + width[:, :, None] * s2[None, None, :]
    cdf2 = _count_le(sx, edges2)
    idx2 = (cdf2 < (target[None, :, None] + 1.0)).float().sum(-1)
    idx2 = idx2.clamp(1.0, sub_bins)
    sub_w = width / sub_bins
    v_lo = lo + (idx2 - 1.0) * sub_w

    e_idx = idx2.long()
    c_hi = torch.gather(cdf2, -1, e_idx[..., None])[..., 0]
    c_lo = torch.gather(cdf2, -1, (e_idx - 1)[..., None])[..., 0]
    frac = ((target[None, :] + 1.0 - c_lo) / (c_hi - c_lo).clamp(min=1.0)).clamp(0.0, 1.0)
    return (v_lo + frac * sub_w).reshape(N, C, L)


def nyul_transform_fast(img: torch.Tensor, landmark_percents: torch.Tensor,
                        standard_scale: torch.Tensor, bins: int = 128,
                        percentile_stride: int = 1) -> torch.Tensor:
    """Fast Nyul transform of (H, W, C) or (N, H, W, C) images.

    Each image's landmark percentiles (estimated from every
    ``percentile_stride``-th pixel) map piecewise-linearly onto
    ``standard_scale``; the fitted average landmarks cancel (preprocess.py:311-349),
    so the JAX function's ``channel_landmarks`` argument is not needed.
    """
    single = img.dim() == 3
    x = img[None] if single else img
    N, H, W, C = x.shape
    flat = x.reshape(N, H * W, C)
    orig = _histogram_percentiles(flat[:, ::percentile_stride],
                                  landmark_percents, bins)  # (N, C, L)
    out = _piecewise_map(flat.float(), orig[:, None], standard_scale.float())
    out = out.reshape(N, H, W, C)
    return out[0] if single else out


def preprocess_fusion_inputs(dwi_raw: torch.Tensor, dce_raw: torch.Tensor,
                             adc_map: torch.Tensor,
                             landmark_percents: Sequence[float] = DEFAULT_LANDMARKS,
                             percentile_stride: int = 1):
    """Raw NHWC volumes -> model inputs, as bench.py:616-625 serves them.

    DWI: z-score the raw b-value channels (the last one zeroed, reference
    behaviour) and append the ADC channel; DCE: fast Nyul onto [0, 1].
    """
    lm = torch.as_tensor(landmark_percents, dtype=torch.float32, device=dce_raw.device)
    scale = torch.linspace(0.0, 1.0, lm.shape[0], device=dce_raw.device)
    dx = append_adc(dwi_normalize(dwi_raw, skip_last=True, zero_last=True),
                    adc_map)
    cx = nyul_transform_fast(dce_raw, lm, scale, percentile_stride=percentile_stride)
    return dx, cx
