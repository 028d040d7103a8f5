"""CUDA kernel for the standalone squeeze-excitation ``(x * s, s)``.

Replaces the TPU kernel ``_se_kernel`` (se_pallas.py:110), reached through
``se_scale`` (:202).  The kernel is ``csrc/se_scale.cu`` (its note gives the
design): kernel 1's split pool over (sample, pixel block) without the add,
GELU and dropout, in three kernels that one ctypes call enqueues, the MLP
being kernel 1's own (``csrc/se_mlp.cuh``).  This module plans the launch
(vector width, threads, pixels per block, samples per MLP block), checks the
map and the weights, and allocates the outputs and the scratch.

Deliberately not carried over from the TPU: batch tiling to a VMEM budget
and the ``custom_vmap`` pass folding (the MC passes are a batch dimension
here).  The library is built on first use, never on import.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from .cuda_build import load_library
from .epilogue_cuda import MAX_GROUP, _sm_count
from .prepared import mlp_weights

_SOURCES = ("se_scale.cu",)
MAX_THREADS = 256   # a block of the pixel passes where vectors are wider than 1
MAX_C = 1024
# of one map a pixel-pass block reads: 16 KB ran faster than kernel 1's
# 64 KB at the four served maps on an H100 (PERF.md)
BLOCK_BYTES = 16384
BLOCKS_PER_SM = 2   # the least pixel-pass blocks per SM the plan aims for


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("se_scale", _SOURCES)
    fn = lib.se_scale_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flat_threads(c: int, vec: int) -> int:
    """Threads of a block that walks a channels-last tile as a flat run of
    ``vec``-element vectors: a multiple of ``C / gcd(C, vec)``, so that lane
    k of thread t always holds channel ``(vec * t + k) mod C``, times the
    largest power of two that keeps it at most ``MAX_THREADS`` (one period
    where that alone is wider)."""
    period = c // math.gcd(c, vec)
    k = 1
    while period * k * 2 <= MAX_THREADS:
        k *= 2
    return period * k


def plan(n: int, hw: int, c: int, esize: int, aligned: bool,
         sms: int) -> Tuple[int, int, int, int]:
    """``(vec, threads, p_blk, group)`` of a launch on ``n`` maps of ``hw`` x ``c``.

    ``vec``: elements per vector load, 16 bytes where the maps are 16-byte
    aligned, ``HW * C`` is a multiple of it and a block's period
    ``C / gcd(C, vec)`` is at most ``MAX_THREADS``; else 1.  ``threads``:
    :func:`flat_threads`.  ``p_blk``: pixels per block of the pixel passes, a
    multiple of the pixels one pass of a block covers, near ``BLOCK_BYTES``
    of one map, halved (down to one pass) until there are ``BLOCKS_PER_SM``
    blocks per SM.  ``group``: samples per MLP block, as kernel 1's plan
    (``epilogue_cuda.plan``).
    """
    vec = 16 // esize
    if not aligned or (hw * c) % vec or c // math.gcd(c, vec) > MAX_THREADS:
        vec = 1
    threads = flat_threads(c, vec)
    rows = vec * threads // c  # pixels one pass of a block covers
    k = max(1, BLOCK_BYTES // (rows * c * esize))
    while k > 1 and n * -(-hw // (rows * k)) < BLOCKS_PER_SM * sms:
        k //= 2
    group = min(MAX_GROUP, max(1, -(-n // sms)))
    return vec, threads, rows * k, group


def launch_se_scale(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a channels_last (N, C, H, W) fp32/bf16 map."""
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
    if c > MAX_C:
        raise ValueError(f"se_scale: C={c} above {MAX_C}")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("se_scale: weights must be on x's device")
    dt = x.dtype
    w1m, b1v, w2t, b2v = mlp_weights(w1, b1, w2, b2, c, mid, dt)
    out = torch.empty_like(x)
    s = torch.empty((n, c, 1, 1), dtype=dt, device=x.device)
    hw = h * w
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    vec, threads, p_blk, group = plan(n, hw, c, x.element_size(), aligned,
                                      _sm_count(x.device.index))
    nb = -(-hw // p_blk)
    # scratch: the partial sums (N, nb, C), then the fp32 scale (N, C)
    scratch = torch.empty(n * (nb + 1) * c, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.se_scale_launch(
            int(dt == torch.bfloat16), vec, x.data_ptr(), out.data_ptr(), w1m.data_ptr(),
            b1v.data_ptr(), w2t.data_ptr(), b2v.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + n * nb * c * 4, s.data_ptr(), n, hw, c, mid, threads, p_blk,
            group, stream)
    if rc != 0:
        raise RuntimeError(f"se_scale: kernel launch failed (CUDA error {rc})")
    return out, s
