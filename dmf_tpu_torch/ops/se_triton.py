"""Triton kernels for the standalone squeeze-excitation ``(x * s, s)``.

Replaces the TPU kernel ``_se_kernel`` (se_pallas.py:110), reached through
``se_scale`` (:202).

What bounds it on the card: memory traffic.  The work is a spatial mean per
channel, an MLP on the pooled vector (C x C/2 twice, under 0.1 % of the
flops) and one elementwise scale, so the least time is one read and one
write of the map: the modality attention of a ``tta_mc`` request at B=8
(32 x 256^2 x 14, bf16) moves 117 MB, 35 us at 3.35 TB/s.  The TPU kernel
holds a tile of whole maps in VMEM; an SM cannot hold one 256^2 x 14 map,
and one program per map would keep only N SMs busy (kernel 1's measured
fault at 128^2, PERF.md).  So the pool is split over pixel blocks, in three
launches that one ``se_scale`` call makes:

1. ``_pool_partials_kernel`` over (map, pixel block): the per-channel fp32
   sum of a (BLOCK_P pixels x C) channels-last tile;
2. ``_mlp_kernel`` over maps: ``s`` from the sum of the partials through
   ``_se_mlp``, written in fp32 for the scale and in the map dtype for the
   caller;
3. ``_scale_kernel`` over (map, pixel block): ``out = x * s``.

That is two reads and one write of the map against the bound's one read
and one write.  Deliberately not carried over from the TPU: batch tiling to
a VMEM budget and the ``custom_vmap`` pass folding (the MC passes are a
batch dimension here).

``_se_mlp`` (pool rounding, W1 -> GELU -> round -> W2 -> sigmoid) and
``_gelu`` hold the SE MLP and its rounding points; the weights come from
:func:`~dmf_tpu_torch.ops.prepared.mlp_weights`, once per parameter set.

``triton`` is imported, and the kernels are defined, on first use only.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import torch

from .cuda_build import BUILD_DIR
from .prepared import mlp_weights


@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton kernels (imports triton; first use only)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    # the jitted helpers reference each other as module globals
    global tl, _gelu, _se_mlp, _pool_partials_kernel, _mlp_kernel, _scale_kernel
    import triton
    import triton.language as tl

    @triton.jit
    def _gelu(v):
        # exact (erf) GELU in fp32
        return 0.5 * v * (1.0 + tl.erf(v * 0.7071067811865476))

    @triton.jit
    def _se_mlp(pool_sum, HW, w1_ptr, b1_ptr, w2t_ptr, b2_ptr, C, MID,
                BLOCK_C: tl.constexpr, BLOCK_J: tl.constexpr):
        # fp32 s = sigmoid(W2 gelu(W1 pool + b1) + b2) from the fp32 pixel sum;
        # the weights are in the map dtype, and the pool and the hidden
        # activation are rounded to it; W1, W2 streamed (they stay in L2)
        dt = w1_ptr.dtype.element_ty
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        pool = (pool_sum / HW).to(dt).to(tl.float32)
        s = tl.zeros([BLOCK_C], dtype=tl.float32)
        for j0 in range(0, MID, BLOCK_J):
            j = j0 + tl.arange(0, BLOCK_J)
            jm = j < MID
            wm = jm[:, None] & cmask[None, :]
            w1 = tl.load(w1_ptr + j[:, None] * C + cols[None, :], mask=wm,
                         other=0.0).to(tl.float32)
            b1 = tl.load(b1_ptr + j, mask=jm, other=0.0).to(tl.float32)
            h = _gelu(tl.sum(w1 * pool[None, :], axis=1) + b1)
            h = tl.where(jm, h.to(dt).to(tl.float32), 0.0)
            w2 = tl.load(w2t_ptr + j[:, None] * C + cols[None, :], mask=wm,
                         other=0.0).to(tl.float32)
            s += tl.sum(w2 * h[:, None], axis=0)
        b2 = tl.load(b2_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        return 1.0 / (1.0 + tl.exp(-(s + b2)))

    @triton.jit
    def _pool_partials_kernel(x_ptr, part_ptr, HW, C, NB,
                              BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        n = tl.program_id(0)
        b = tl.program_id(1)
        rows = b * BLOCK_P + tl.arange(0, BLOCK_P)
        cols = tl.arange(0, BLOCK_C)
        m = (rows < HW)[:, None] & (cols < C)[None, :]
        off = n.to(tl.int64) * HW * C + rows[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        tl.store(part_ptr + (n * NB + b) * BLOCK_C + cols, tl.sum(x, axis=0))

    @triton.jit
    def _mlp_kernel(part_ptr, w1_ptr, b1_ptr, w2t_ptr, b2_ptr, s32_ptr, s_ptr,
                    HW, C, NB, MID, BLOCK_B: tl.constexpr,
                    BLOCK_C: tl.constexpr, BLOCK_J: tl.constexpr):
        n = tl.program_id(0)
        cols = tl.arange(0, BLOCK_C)
        blocks = tl.arange(0, BLOCK_B)
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for b0 in range(0, NB, BLOCK_B):
            b = b0 + blocks
            bm = b < NB
            acc += tl.sum(tl.load(part_ptr + (n * NB + b)[:, None] * BLOCK_C + cols[None, :],
                                  mask=bm[:, None], other=0.0), axis=0)
        s = _se_mlp(acc, HW, w1_ptr, b1_ptr, w2t_ptr, b2_ptr, C, MID, BLOCK_C, BLOCK_J)
        tl.store(s32_ptr + n * BLOCK_C + cols, s)
        tl.store(s_ptr + n * C + cols, s.to(s_ptr.dtype.element_ty), mask=cols < C)

    @triton.jit
    def _scale_kernel(x_ptr, s32_ptr, out_ptr, HW, C,
                      BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        n = tl.program_id(0)
        b = tl.program_id(1)
        rows = b * BLOCK_P + tl.arange(0, BLOCK_P)
        cols = tl.arange(0, BLOCK_C)
        m = (rows < HW)[:, None] & (cols < C)[None, :]
        off = n.to(tl.int64) * HW * C + rows[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        s = tl.load(s32_ptr + n * BLOCK_C + cols)
        tl.store(out_ptr + off, (x * s[None, :]).to(out_ptr.dtype.element_ty), mask=m)

    return triton


def launch_se_scale(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the three kernels on a channels_last (N, C, H, W) fp32/bf16 map."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"se_scale: need a 4-D fp32/bf16 map, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("se_scale: x must be channels_last (NHWC)")
    n, c, h, w = x.shape
    mid = w1.numel() // c
    if (w1.numel() != mid * c or w2.numel() != c * mid or b1.numel() != mid
            or b2.numel() != c or mid < 1):
        raise ValueError(f"se_scale: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"do not match C={c}")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("se_scale: weights must be on x's device")
    if h * w * c >= 2 ** 31 or c > 1024:
        raise ValueError("se_scale: map too large for 32-bit offsets or C > 1024")
    dt = x.dtype
    w1m, b1v, w2t, b2v = mlp_weights(w1, b1, w2, b2, c, mid, dt)
    triton = _kernels()
    hw = h * w
    block_c = triton.next_power_of_2(c)
    block_p = max(1, 8192 // block_c)
    nb = triton.cdiv(hw, block_p)
    if nb > 65535:
        raise ValueError("se_scale: map too large for the pixel-block grid")
    part = torch.empty((n, nb, block_c), dtype=torch.float32, device=x.device)
    s32 = torch.empty((n, block_c), dtype=torch.float32, device=x.device)
    s = torch.empty((n, c, 1, 1), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _pool_partials_kernel[(n, nb)](x, part, hw, c, nb, BLOCK_P=block_p,
                                       BLOCK_C=block_c, num_warps=4)
        _mlp_kernel[(n,)](part, w1m, b1v, w2t, b2v, s32, s, hw, c, nb, mid,
                          BLOCK_B=max(1, 4096 // block_c), BLOCK_C=block_c,
                          BLOCK_J=min(triton.next_power_of_2(mid), max(1, 8192 // block_c)),
                          num_warps=4)
        _scale_kernel[(n, nb)](x, s32, out, hw, c, BLOCK_P=block_p,
                               BLOCK_C=block_c, num_warps=4)
    return out, s
