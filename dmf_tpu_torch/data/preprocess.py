"""Preprocessing on the device, counterpart of ``dmf_tpu/data/preprocess.py``.

Images are channels-last ``(..., H, W, C)`` tensors, as in the JAX package:

* DWI: the per-image, per-channel z-score (:func:`dwi_normalize`, the
  wrapper of the hand-written kernel in ``ops/dwi_norm.py``), the
  log-linear ADC fit and its rescaling, and the ADC channel;
* DCE: the per-sample global max normalisation and the Nyul transform,
  exact (``torch.quantile``, linear interpolation as ``jnp.percentile``) or
  fast (the two-round CDF estimator below), through
  :class:`NyulStandardizer`, whose fit runs on the host in the native
  library's threaded C++ (``utils/native.py``);
* :func:`preprocess_fusion_inputs`, serving's composition of the two
  (bench.py:616-625).

``_histogram_percentiles`` reproduces the JAX estimator exactly, but counts
``x <= edge`` with a sort and ``searchsorted`` instead of a broadcast compare
(which would materialize a pixels x edges tensor in eager PyTorch).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.dwi_norm import dwi_normalize
from ..ops.histogram import piecewise_map
from ..ops.resize import resize_bilinear
from ..utils import native

DEFAULT_LANDMARKS = (1, 10, 25, 30, 40, 50, 60, 75, 80, 90, 99)


# ---------------------------------------------------------------------------
# ADC map (preprocess.py:75-109)
# ---------------------------------------------------------------------------


def compute_adc_map(dwi_imgs: torch.Tensor, bvals: Sequence[float],
                    eps: float = 1e-6) -> torch.Tensor:
    """Closed-form log-linear ADC fit over the b-value (channel) axis:
    ``(..., H, W, C)`` -> ``(..., H, W, 1)``, ADC = -Cov(b, log S) / Var(b)."""
    b = torch.as_tensor(bvals, dtype=torch.float32, device=dwi_imgs.device)
    log_s = torch.log(dwi_imgs.float().clamp(min=eps))
    db = b - b.mean()
    cov = (db * (log_s - log_s.mean(dim=-1, keepdim=True))).sum(dim=-1)
    slope = cov / ((db ** 2).sum() + eps)
    return (-slope)[..., None]


def preprocess_adc(adc_map: torch.Tensor) -> torch.Tensor:
    """log1p compression, then clamp to [0, 3e-3] and rescale to [0, 1]."""
    adc = torch.log1p(adc_map.clamp(min=0.0))
    return adc.clamp(0.0, 3e-3) / 3e-3


def zero_to_one_adc(adc_map: torch.Tensor, adc_min: float, adc_max: float) -> torch.Tensor:
    return ((adc_map - adc_min) / (adc_max - adc_min + 1e-8)).clamp(0.0, 1.0)


def prep_dwi_adc_maps(train_imgs, test_imgs, bvals: Sequence[float],
                      reference_compat: bool = True, device="cuda"):
    """The per-split ADC maps, on ``device`` (preprocess.py:381-414).

    ``reference_compat=True``: one shared map per split, from train sample 0
    (train), train sample 1 (val) and test sample 0 (test), the reference's
    quirk.  ``False``: per-sample maps for train and test, and ``None`` for
    val (the caller slices it from train).  Inputs are NHWC arrays or tensors.
    """
    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    if reference_compat:
        maps = [preprocess_adc(compute_adc_map(dev(a), bvals))
                for a in (train_imgs[0], train_imgs[1], test_imgs[0])]
        adc_min, adc_max = float(maps[0].min()), float(maps[0].max())
        return [zero_to_one_adc(m, adc_min, adc_max) for m in maps]
    tr = preprocess_adc(compute_adc_map(dev(train_imgs), bvals))
    te = preprocess_adc(compute_adc_map(dev(test_imgs), bvals))
    adc_min, adc_max = float(tr.min()), float(tr.max())
    return [zero_to_one_adc(tr, adc_min, adc_max), None,
            zero_to_one_adc(te, adc_min, adc_max)]


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


# ---------------------------------------------------------------------------
# DCE: global max normalisation and the Nyul transform (preprocess.py:117-373)
# ---------------------------------------------------------------------------


def dce_global_max_normalize(imgs: torch.Tensor) -> torch.Tensor:
    """Per-sample division by the sample's max over all pixels and channels."""
    mx = imgs.reshape(imgs.shape[0], -1).max(dim=1).values
    return imgs / mx[:, None, None, None]


class NyulStandardizer:
    """Percentile-landmark intensity standardization for DCE.

    ``fit`` runs once on the host, through the native library's threaded
    exact fit as in the JAX package (preprocess.py:161-166; the numpy formula
    of its other branch is :func:`nyul_fit_plain`, the tests' reference);
    ``save``/``load`` use the JAX
    package's ``.npy`` dict format, so each package reads the other's file.
    ``transform`` runs where the image lies: fast (the histogram estimator
    and one piecewise map) on a CUDA tensor, exact on a CPU tensor, unless
    its ``fast`` argument says otherwise.
    """

    def __init__(self, landmarks: Sequence[float] = DEFAULT_LANDMARKS,
                 target_range: Tuple[float, float] = (0.0, 1.0)):
        self.landmarks = np.asarray(landmarks, dtype=np.float64)
        self.standard_scale = np.linspace(target_range[0], target_range[1], len(landmarks))
        self.channel_landmarks: Optional[np.ndarray] = None  # (C, L)
        self.fitted = False

    def fit(self, images, num_channels: Optional[int] = None) -> None:
        """Average per-channel landmark percentiles over ``images`` (N, H, W, C)."""
        if isinstance(images, torch.Tensor):
            images = images.cpu().numpy()
        images = np.asarray(images)
        C = num_channels or images.shape[-1]
        self.channel_landmarks = native.nyul_fit(images[..., :C], self.landmarks)
        self.fitted = True

    def save(self, path: str) -> None:
        np.save(path, {"channel_landmarks": {c: self.channel_landmarks[c]
                                             for c in range(self.channel_landmarks.shape[0])},
                       "fitted": self.fitted})

    def load(self, path: str) -> None:
        data = np.load(path, allow_pickle=True).item()
        lm: Dict[int, np.ndarray] = data["channel_landmarks"]
        self.channel_landmarks = np.stack([lm[c] for c in sorted(lm)], axis=0)
        self.fitted = data["fitted"]

    def transform(self, img: torch.Tensor, fast: Optional[bool] = None,
                  percentile_stride: int = 1) -> torch.Tensor:
        """Standardize (H, W, C) or (N, H, W, C) images onto the standard scale.

        ``percentile_stride`` (fast path only) estimates each image's
        landmarks from every k-th pixel.
        """
        if not self.fitted:
            raise RuntimeError("Call fit() first")
        if fast is None:
            fast = img.is_cuda
        f32 = {"dtype": torch.float32, "device": img.device}
        lm = torch.as_tensor(self.landmarks, **f32)
        scale = torch.as_tensor(self.standard_scale, **f32)
        if fast:
            return nyul_transform_fast(img, lm, scale, percentile_stride=percentile_stride)
        return nyul_transform(img, torch.as_tensor(self.channel_landmarks, **f32), lm, scale)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        return self.transform(img)


def nyul_fit_plain(images: np.ndarray, landmarks: np.ndarray) -> np.ndarray:
    """The numpy formula of the Nyul fit, (N, H, W, C) -> (C, L): the JAX
    package's fallback branch (preprocess.py:168-171), the plain version the
    native fit is held against."""
    flat = images.reshape(images.shape[0], -1, images.shape[-1])
    return np.percentile(flat, landmarks, axis=1).mean(axis=1).T  # (L, N, C) -> (C, L)


def _interp_rows(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` row by row: ``x`` (K, M), knots ``xp``/``fp`` (K, L),
    clamped outside the knots (lax_numpy.py ``_interp``)."""
    L = xp.shape[1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True).clamp(1, L - 1)
    xp_lo, xp_hi = xp.gather(1, i - 1), xp.gather(1, i)
    fp_lo, fp_hi = fp.gather(1, i - 1), fp.gather(1, i)
    dx = xp_hi - xp_lo
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp_lo, fp_lo + ((x - xp_lo) / torch.where(dx0, 1.0, dx)) * (fp_hi - fp_lo))
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


def nyul_transform(img: torch.Tensor, channel_landmarks: torch.Tensor,
                   landmark_percents: torch.Tensor, standard_scale: torch.Tensor) -> torch.Tensor:
    """Exact Nyul transform of (H, W, C) or (N, H, W, C) images.

    Per image and channel: the image's landmark percentiles (``torch.quantile``
    with linear interpolation, ``jnp.percentile``'s default) map onto the
    fitted averages, and those onto ``standard_scale`` (double interp,
    preprocess.py:230-232, 352-373).
    """
    if img.dim() == 4:
        return torch.stack([nyul_transform(im, channel_landmarks, landmark_percents,
                                           standard_scale) for im in img])
    if img.dim() != 3:
        raise ValueError(f"expected (H,W,C) or (N,H,W,C), got {tuple(img.shape)}")
    H, W, C = img.shape
    pix = img.float().reshape(-1, C)
    orig = torch.quantile(pix, landmark_percents.float() / 100.0, dim=0).T  # (C, L)
    avg = channel_landmarks.float()
    mid = _interp_rows(pix.T, orig, avg)
    out = _interp_rows(mid, avg, standard_scale.float().expand_as(avg))
    return out.T.reshape(H, W, C)


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
    out = piecewise_map(flat.float(), orig[:, None], standard_scale.float())
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
    dx = append_adc(dwi_normalize(dwi_raw.contiguous(), skip_last=True, zero_last=True),
                    adc_map)
    cx = nyul_transform_fast(dce_raw, lm, scale, percentile_stride=percentile_stride)
    return dx, cx
