"""Triton kernels for the DWI per-image, per-channel z-score.

Replaces the TPU kernel ``_dwi_norm_kernel`` (preprocess_pallas.py:28),
reached through ``dwi_normalize_pallas`` (:49).

What bounds it on the card: memory traffic.  Per element the work is a few
flops, so the least time is one read and one write of the images: at the
serving batch (8, 256, 256, 13) in fp32 that is 54.5 MB, 16 us at 3.35 TB/s.
The TPU kernel holds a whole image in VMEM; an SM cannot (one image is
3.4 MB), and one program per image would keep only N of the 132 SMs busy.
So the statistics are split over pixel blocks, in three launches:

1. ``_partials_kernel`` over (image, pixel block): each program reads a
   (BLOCK_P pixels x C) tile of the NHWC image in place (C = 13 or 14 is
   the innermost dimension, padded to BLOCK_C = 16 and masked) and writes
   the block's per-channel mean and centred sum of squares M2;
2. ``_merge_kernel`` over images: Chan's parallel merge of the partials,
   ``mean = sum n_b mean_b / n`` and ``M2 = sum M2_b + n_b (mean_b - mean)^2``.
   Raw DWI intensities run into the thousands, where fp32
   ``sum x^2 - n mean^2`` loses digits; centred sums do not;
3. ``_normalize_kernel`` over (image, pixel block): re-reads the tile,
   writes ``clip((x - mean) / std) -> [0, 1]`` in the input's dtype, and the
   last channel kept or zeroed.

That is two reads and one write of the images against the bound's one
read: the second read is the price of not holding an image on chip.

``triton`` is imported, and the kernels are defined, on first use only.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import torch

from .cuda_build import BUILD_DIR


@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton kernels (imports triton; first use only)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    global tl, _partials_kernel, _merge_kernel, _normalize_kernel
    import triton
    import triton.language as tl

    @triton.jit
    def _partials_kernel(x_ptr, mean_ptr, m2_ptr, HW, C, NB,
                         BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        n = tl.program_id(0)
        b = tl.program_id(1)
        rows = b * BLOCK_P + tl.arange(0, BLOCK_P)
        cols = tl.arange(0, BLOCK_C)
        m = (rows < HW)[:, None] & (cols < C)[None, :]
        base = n.to(tl.int64) * HW * C
        x = tl.load(x_ptr + base + rows[:, None] * C + cols[None, :], mask=m,
                    other=0.0).to(tl.float32)
        cnt = tl.minimum(HW - b * BLOCK_P, BLOCK_P).to(tl.float32)
        mean = tl.sum(x, axis=0) / cnt
        d = tl.where(m, x - mean[None, :], 0.0)
        off = (n * NB + b) * BLOCK_C + cols
        tl.store(mean_ptr + off, mean)
        tl.store(m2_ptr + off, tl.sum(d * d, axis=0))

    @triton.jit
    def _merge_kernel(mean_ptr, m2_ptr, stats_ptr, HW, NB,
                      BLOCK_P: tl.constexpr, BLOCK_B: tl.constexpr,
                      BLOCK_C: tl.constexpr):
        n = tl.program_id(0)
        cols = tl.arange(0, BLOCK_C)
        blocks = tl.arange(0, BLOCK_B)
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for b0 in range(0, NB, BLOCK_B):
            b = b0 + blocks
            bm = b < NB
            cnt = tl.where(bm, tl.minimum(HW - b * BLOCK_P, BLOCK_P).to(tl.float32), 0.0)
            off = (n * NB + b)[:, None] * BLOCK_C + cols[None, :]
            mb = tl.load(mean_ptr + off, mask=bm[:, None], other=0.0)
            acc += tl.sum(cnt[:, None] * mb, axis=0)
        mean = acc / HW
        m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        for b0 in range(0, NB, BLOCK_B):
            b = b0 + blocks
            bm = b < NB
            cnt = tl.where(bm, tl.minimum(HW - b * BLOCK_P, BLOCK_P).to(tl.float32), 0.0)
            off = (n * NB + b)[:, None] * BLOCK_C + cols[None, :]
            mb = tl.load(mean_ptr + off, mask=bm[:, None], other=0.0)
            m2b = tl.load(m2_ptr + off, mask=bm[:, None], other=0.0)
            dm = mb - mean[None, :]
            m2 += tl.sum(m2b + cnt[:, None] * dm * dm, axis=0)
        std = tl.maximum(tl.sqrt(m2 / (HW - 1)), 1e-6)
        tl.store(stats_ptr + n * 2 * BLOCK_C + cols, mean)
        tl.store(stats_ptr + n * 2 * BLOCK_C + BLOCK_C + cols, std)

    @triton.jit
    def _normalize_kernel(x_ptr, out_ptr, stats_ptr, HW, C, z_lo, z_hi,
                          SKIP_LAST: tl.constexpr, ZERO_LAST: tl.constexpr,
                          BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        n = tl.program_id(0)
        b = tl.program_id(1)
        rows = b * BLOCK_P + tl.arange(0, BLOCK_P)
        cols = tl.arange(0, BLOCK_C)
        m = (rows < HW)[:, None] & (cols < C)[None, :]
        off = n.to(tl.int64) * HW * C + rows[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        mean = tl.load(stats_ptr + n * 2 * BLOCK_C + cols)
        std = tl.load(stats_ptr + n * 2 * BLOCK_C + BLOCK_C + cols)
        z = (x - mean[None, :]) / std[None, :]
        z = tl.minimum(tl.maximum(z, z_lo), z_hi)
        y = (z - z_lo) / (z_hi - z_lo)
        if SKIP_LAST:
            last = (cols == C - 1)[None, :]
            if ZERO_LAST:
                y = tl.where(last, 0.0, y)
            else:
                y = tl.where(last, x, y)
        tl.store(out_ptr + off, y.to(out_ptr.dtype.element_ty), mask=m)

    return triton


def launch_dwi_normalize(img: torch.Tensor, clip_z: Tuple[float, float],
                         skip_last: bool, zero_last: bool) -> torch.Tensor:
    """Launch the three kernels on contiguous (N, H, W, C) images."""
    if img.dim() != 4 or img.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"dwi_normalize: need (N, H, W, C) fp32/bf16/fp16 images, "
                         f"got {tuple(img.shape)} {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("dwi_normalize: the kernel takes contiguous NHWC images")
    n, h, w, c = img.shape
    hw = h * w
    if hw < 2 or not 1 <= c <= 128:
        raise ValueError(f"dwi_normalize: need at least 2 pixels and 1-128 channels, "
                         f"got {hw} x {c}")
    if hw * c >= 2 ** 31:
        raise ValueError("dwi_normalize: image too large for 32-bit offsets")
    triton = _kernels()
    block_c = triton.next_power_of_2(c)
    block_p = max(16, 8192 // block_c)
    nb = triton.cdiv(hw, block_p)
    if nb > 65535 or n > 65535:
        raise ValueError("dwi_normalize: grid too large; split the batch")
    part = torch.empty((2, n, nb, block_c), dtype=torch.float32, device=img.device)
    stats = torch.empty((n, 2, block_c), dtype=torch.float32, device=img.device)
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        _partials_kernel[(n, nb)](img, part[0], part[1], hw, c, nb,
                                  BLOCK_P=block_p, BLOCK_C=block_c, num_warps=4)
        _merge_kernel[(n,)](part[0], part[1], stats, hw, nb, BLOCK_P=block_p,
                            BLOCK_B=max(1, 2048 // block_c), BLOCK_C=block_c,
                            num_warps=4)
        _normalize_kernel[(n, nb)](img, out, stats, hw, c, float(clip_z[0]),
                                   float(clip_z[1]), SKIP_LAST=skip_last,
                                   ZERO_LAST=zero_last, BLOCK_P=block_p,
                                   BLOCK_C=block_c, num_warps=4)
    return out
