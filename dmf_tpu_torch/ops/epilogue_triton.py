"""Triton kernel for the ResLite-block epilogue ``SE(dropout(gelu(x + identity)))``.

Replaces the TPU kernels ``_epilogue_kernel`` (epilogue_pallas.py:222) and
``_epilogue_kernel_t`` (:255), reached through ``se_epilogue`` (:443).

What bounds it on the card: memory traffic.  Per sample the work is an
elementwise pass, a spatial mean per channel and a C x C/2 MLP on one pooled
vector, far below the H100's ~295 FLOP/byte ridge, so there is no tensor-core
work worth ``wgmma``.  Design, simple first:

* one program per sample (the folded batch of views and MC passes);
* pass 1 walks the sample's (H*W, C) channels-last map in pixel blocks,
  writes ``y = dropout(gelu(x + identity))`` to the output and accumulates
  the fp32 pool in registers;
* the SE MLP streams W1 and W2 from global memory (they stay in L2);
* pass 2 re-reads the output and scales it IN PLACE.

That is 3 reads + 2 writes of the map against the TPU kernel's 2 + 1: a
sample's map is 256 KB - 1 MB in bf16, more than an SM's shared memory, so it
is not held on chip; a split reduction across blocks is later work.

Dropout: ``tl.rand`` is counter-based Philox keyed on ``(seed, offset)``.
The offset is the element's index in the folded channels-last batch, so
views and MC passes draw independent bits from one seed.  The keep test
lives in one helper (:func:`_keep`) that the test-only :func:`keep_mask`
kernel shares, so the plain version can be fed the kernel's own mask.

Deliberately not carried over from the TPU: the ``(H, W, B, C)`` layout
variant, the VMEM block budgets and batch tiling, and the ``custom_vmap``
pass folding with its seed-sum fold (here the MC passes already are a batch
dimension).

``triton`` is imported, and the kernels are defined, on first use only.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from .cuda_build import BUILD_DIR


@functools.lru_cache(maxsize=None)
def _kernels():
    """Define the Triton kernels (imports triton; first use only)."""
    # keep Triton's compile cache inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    # the jitted helpers reference each other as module globals
    global tl, _gelu, _keep, _se_epilogue_kernel, _keep_mask_kernel
    import triton
    import triton.language as tl

    @triton.jit
    def _gelu(v):
        # exact (erf) GELU in fp32
        return 0.5 * v * (1.0 + tl.erf(v * 0.7071067811865476))

    @triton.jit
    def _keep(seed, offsets, keep_prob):
        # the one keep test: the epilogue kernel and keep_mask share it
        return tl.rand(seed, offsets) < keep_prob

    @triton.jit
    def _se_epilogue_kernel(x_ptr, id_ptr, out_ptr, w1_ptr, b1_ptr, w2t_ptr,
                            b2_ptr, seed_ptr, HW, C, MID, keep_prob,
                            drop_scale, DROP: tl.constexpr,
                            BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr,
                            BLOCK_J: tl.constexpr):
        dt = out_ptr.dtype.element_ty
        n = tl.program_id(0)
        base = n.to(tl.int64) * HW * C
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        rows = tl.arange(0, BLOCK_P)
        if DROP:
            seed = tl.load(seed_ptr)
        # pass 1: y = dropout(gelu(x + identity)) -> out, fp32 pool
        pool = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p0 in range(0, HW, BLOCK_P):
            p = p0 + rows
            m = (p < HW)[:, None] & cmask[None, :]
            off = base + p[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            r = tl.load(id_ptr + off, mask=m, other=0.0).to(tl.float32)
            y = _gelu(x + r).to(dt)
            if DROP:
                keep = _keep(seed, off.to(tl.int32), keep_prob)
                y = tl.where(keep, (y.to(tl.float32) * drop_scale).to(dt),
                             0.0).to(dt)
            tl.store(out_ptr + off, y, mask=m)
            pool += tl.sum(y.to(tl.float32), axis=0)
        pool = (pool / HW).to(dt).to(tl.float32)
        # SE MLP: s = sigmoid(W2 gelu(W1 pool + b1) + b2), W1/W2 streamed
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
        s = 1.0 / (1.0 + tl.exp(-(s + b2)))
        tl.debug_barrier()
        # pass 2: scale the output in place
        for p0 in range(0, HW, BLOCK_P):
            p = p0 + rows
            m = (p < HW)[:, None] & cmask[None, :]
            off = base + p[:, None] * C + cols[None, :]
            y = tl.load(out_ptr + off, mask=m, other=0.0).to(tl.float32)
            tl.store(out_ptr + off, (y * s[None, :]).to(dt), mask=m)

    @triton.jit
    def _keep_mask_kernel(mask_ptr, seed_ptr, numel, keep_prob,
                          BLOCK: tl.constexpr):
        off = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        seed = tl.load(seed_ptr)
        keep = _keep(seed, off, keep_prob)
        tl.store(mask_ptr + off, keep.to(tl.int8), mask=off < numel)

    return triton


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """The kernel's Philox seed, drawn on the device (no host sync)."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int64)


def _check_map(t: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"se_epilogue: {name} must match x in shape, dtype "
                         f"and device; got {tuple(t.shape)} {t.dtype} {t.device}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"se_epilogue: {name} must be channels_last (NHWC)")


def launch_se_epilogue(x: torch.Tensor, identity: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor,
                       drop_rate: float,
                       seed: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on channels_last (N, C, H, W) fp32/bf16 maps."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f"se_epilogue: need a 4-D fp32/bf16 map, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _check_map(x, x, "x")
    _check_map(identity, x, "identity")
    if not 0.0 <= drop_rate < 1.0:
        raise ValueError(f"se_epilogue: drop_rate {drop_rate} outside [0, 1)")
    if x.numel() >= 2 ** 31:
        raise ValueError("se_epilogue: dropout offsets are int32; split the batch")
    n, c, h, w = x.shape
    mid = w1.numel() // c
    dt = x.dtype
    w1m = w1.reshape(mid, c).to(dt).contiguous()
    w2t = w2.reshape(c, mid).t().to(dt).contiguous()
    b1v = b1.to(dt).contiguous()
    b2v = b2.to(dt).contiguous()
    drop = drop_rate > 0.0
    if drop:
        if seed is None or seed.device != x.device:
            raise ValueError("se_epilogue: dropout needs a seed on x's device")
    else:
        seed = torch.zeros(1, dtype=torch.int64, device=x.device)
    # the dropout scale rounded to the map dtype, as the TPU kernel does
    scale = float(torch.tensor(1.0 / (1.0 - drop_rate), dtype=dt)) if drop else 1.0
    triton = _kernels()
    block_c = triton.next_power_of_2(c)
    out = torch.empty_like(x)
    _se_epilogue_kernel[(n,)](
        x, identity, out, w1m, b1v, w2t, b2v, seed, h * w, c, mid,
        1.0 - drop_rate, scale, DROP=drop,
        BLOCK_P=max(1, 4096 // block_c), BLOCK_C=block_c,
        BLOCK_J=max(1, 8192 // block_c), num_warps=8)
    return out


def keep_mask(x: torch.Tensor, drop_rate: float, seed: torch.Tensor) -> torch.Tensor:
    """Test-only: the keep mask the epilogue kernel draws for ``x`` and ``seed``.

    Emitted by a small kernel through the same keep helper, element for
    element in ``x``'s channels-last order; returns a bool tensor shaped like
    ``x``.  It is not a launch of the epilogue kernel and is not counted.
    """
    _check_map(x, x, "x")
    mask = torch.empty_like(x, dtype=torch.int8)
    numel = x.numel()
    _kernels()
    block = 1024
    _keep_mask_kernel[((numel + block - 1) // block,)](
        mask, seed, numel, 1.0 - drop_rate, BLOCK=block)
    return mask.bool()
