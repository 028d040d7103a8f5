"""CUDA kernel for the ResLite-block epilogue ``SE(dropout(gelu(x + identity)))``.

Replaces the TPU kernels ``_epilogue_kernel`` (epilogue_pallas.py:222) and
``_epilogue_kernel_t`` (:255), reached through ``se_epilogue`` (:443).  The
kernel is ``csrc/se_epilogue.cu`` (its note gives the design): a split pool
over (sample, pixel block) in three kernels that one ctypes call enqueues.
This module plans the launch (vector width, pixels per block, samples per
MLP block), checks the maps, allocates the output and the scratch, and keeps
the dropout's seed and the keep-mask launch (the seed route's dropout outside
the epilogue, ``ops/dropout.py``) beside a plain numpy Philox4x32-10 that the
tests hold the kernel's bits against.

Deliberately not carried over from the TPU: the ``(H, W, B, C)`` layout
variant, the VMEM block budgets and batch tiling, and the ``custom_vmap``
pass folding with its seed-sum fold (here the MC passes already are a batch
dimension).  The library is built on first use, never on import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .cuda_build import load_library
from .dropout import per_pass
from .prepared import mlp_weights

_SOURCES = ("se_epilogue.cu",)
THREADS = 256       # a block of the pixel passes while C / vector <= 256
MAX_GROUP = 8       # samples per block of the MLP kernel
BLOCK_BYTES = 65536  # of one map a pixel-pass block reads
BLOCKS_PER_SM = 4   # the least pixel-pass blocks per SM the plan aims for


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("se_epilogue", _SOURCES)
    fn = lib.se_epilogue_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                   + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    km = lib.keep_mask_launch
    km.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    km.restype = ctypes.c_int
    return lib


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """The kernel's 64-bit Philox key, drawn on the device (no host sync)."""
    return torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int64)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _drop_scale(drop_rate: float, dt: torch.dtype) -> float:
    """``1 / (1 - p)`` rounded to the map dtype, as the TPU kernel does."""
    return float(torch.tensor(1.0 / (1.0 - drop_rate), dtype=dt))


def _check_map(t: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"se_epilogue: {name} must match x in shape, dtype "
                         f"and device; got {tuple(t.shape)} {t.dtype} {t.device}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"se_epilogue: {name} must be channels_last (NHWC)")


def plan(n: int, hw: int, c: int, esize: int, aligned: bool,
         sms: int) -> Tuple[int, int, int]:
    """``(vec, p_blk, group)`` of a launch on ``n`` maps of ``hw`` x ``c``.

    ``vec``: elements per vector load, 16 bytes where C is a multiple and the
    maps are 16-byte aligned, else 1.  ``p_blk``: pixels per block of the
    pixel passes, ``BLOCK_BYTES`` of one map, halved (down to the pixels one
    pass of the block covers) until there are ``BLOCKS_PER_SM`` blocks per
    SM.  ``group``: samples per MLP block, one per SM first, up to
    ``MAX_GROUP`` once the samples outnumber the SMs, so that each weight
    row is read once per group.
    """
    vec = 16 // esize
    if c % vec or not aligned:
        vec = 1
    groups = c // vec
    threads = THREADS if groups <= THREADS else -(-groups // 32) * 32
    rows = threads // groups
    p_blk = min(max(BLOCK_BYTES // (c * esize), rows), hw)
    while p_blk > rows and n * -(-hw // p_blk) < BLOCKS_PER_SM * sms:
        p_blk = max(p_blk // 2, rows)
    group = min(MAX_GROUP, max(1, -(-n // sms)))
    return vec, p_blk, group


def launch_se_epilogue(x: torch.Tensor, identity: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor,
                       drop_rate: float, seed: Optional[torch.Tensor],
                       base: int = 0, first_pass: int = 0, passes: int = 1) -> torch.Tensor:
    """Launch the kernel on channels_last (N, C, H, W) fp32/bf16 maps; the
    dropout's Philox counters start at ``base`` (a multiple of 4) in each of
    the ``passes`` passes from ``first_pass`` that the N maps hold
    pass-major (``ops/dropout.py``)."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f"se_epilogue: need a 4-D fp32/bf16 map, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _check_map(x, x, "x")
    _check_map(identity, x, "identity")
    if not 0.0 <= drop_rate < 1.0:
        raise ValueError(f"se_epilogue: drop_rate {drop_rate} outside [0, 1)")
    n, c, h, w = x.shape
    mid = w1.numel() // c
    if (w1.numel() != mid * c or w2.numel() != c * mid or b1.numel() != mid
            or b2.numel() != c or not 1 <= mid <= 1024 or c > 1024):
        raise ValueError(f"se_epilogue: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"do not match C={c}, or C or C/r above 1024")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("se_epilogue: weights must be on x's device")
    dt = x.dtype
    w1m, b1v, w2t, b2v = mlp_weights(w1, b1, w2, b2, c, mid, dt)
    drop = drop_rate > 0.0
    if drop and (seed is None or seed.device != x.device or seed.dtype != torch.int64):
        raise ValueError("se_epilogue: dropout needs an int64 seed on x's device")
    if base < 0 or base % 4:
        raise ValueError(f"se_epilogue: counter base {base} is not a multiple of 4")
    per_pass(x.shape, passes)
    _check_passes("se_epilogue", first_pass, passes)
    scale = _drop_scale(drop_rate, dt) if drop else 1.0
    out = torch.empty_like(x)
    hw = h * w
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, identity, out))
    vec, p_blk, group = plan(n, hw, c, x.element_size(), aligned, _sm_count(x.device.index))
    nb = -(-hw // p_blk)
    # scratch: the partial sums (N, nb, C), then the fp32 scale (N, C)
    scratch = torch.empty(n * (nb + 1) * c, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.se_epilogue_launch(
            int(dt == torch.bfloat16), vec, x.data_ptr(), identity.data_ptr(), out.data_ptr(),
            w1m.data_ptr(), b1v.data_ptr(), w2t.data_ptr(), b2v.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + n * nb * c * 4, seed.data_ptr() if drop else None, base,
            first_pass, passes, n, hw, c, mid, p_blk, group, 1.0 - drop_rate, scale, int(drop),
            stream)
    if rc != 0:
        raise RuntimeError(f"se_epilogue: kernel launch failed (CUDA error {rc})")
    return out


def _check_passes(name: str, first_pass: int, passes: int) -> None:
    if first_pass < 0 or first_pass + passes > 2 ** 32:
        raise ValueError(f"{name}: passes {first_pass}..{first_pass + passes - 1} outside "
                         f"the 32-bit pass word")


def seed_order_empty(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An empty tensor shaped like ``x`` whose memory order is the seed
    route's element order: channels-last for a 4-D tensor (the epilogue
    kernel's NHWC index), row-major otherwise."""
    fmt = torch.channels_last if x.dim() == 4 else torch.contiguous_format
    return torch.empty(x.shape, dtype=dtype, device=x.device, memory_format=fmt)


def keep_mask(x: torch.Tensor, drop_rate: float, seed: torch.Tensor,
              base: int = 0, first_pass: int = 0, passes: int = 1) -> torch.Tensor:
    """The keep mask the epilogue kernel draws for ``x``'s elements under
    ``seed``: ``x`` holds ``passes`` passes from ``first_pass`` pass-major
    along its first dimension, and element ``i`` of a pass's part of the
    seed order (:func:`seed_order_empty`) takes Philox counter ``base + i``
    and the pass's word.  A bool tensor shaped like ``x`` in that memory
    order, written by a small kernel through the epilogue's keep test (one
    Philox call a thread for 4 elements); it is not a launch of the epilogue
    kernel.  ``x``'s values are not read."""
    if not 0.0 <= drop_rate < 1.0:
        raise ValueError(f"keep_mask: drop_rate {drop_rate} outside [0, 1)")
    if seed.device != x.device or seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("keep_mask: need one int64 seed on x's device")
    if base < 0:
        raise ValueError(f"keep_mask: negative counter base {base}")
    per = per_pass(x.shape, passes)
    _check_passes("keep_mask", first_pass, passes)
    mask = seed_order_empty(x, torch.bool)  # the kernel writes 0 / 1 bytes
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.keep_mask_launch(mask.data_ptr(), seed.data_ptr(), base, per, first_pass,
                                  passes, 1.0 - drop_rate, stream)
    if rc != 0:
        raise RuntimeError(f"keep_mask: kernel launch failed (CUDA error {rc})")
    return mask


# ------------------------------------------------------- plain numpy Philox
_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_W = (np.uint32(0x9E3779B9), np.uint32(0xBB67AE85))
_LO = np.uint64(0xFFFFFFFF)


def philox4x32(ctr, key) -> np.ndarray:
    """Philox4x32-10 (Random123) on uint32 counters ``ctr`` (..., 4) and a
    key ``(k0, k1)``; returns the (..., 4) uint32 outputs."""
    c = [np.asarray(ctr, dtype=np.uint32)[..., i].astype(np.uint64) for i in range(4)]
    k = [np.uint32(key[0]), np.uint32(key[1])]
    for r in range(10):
        if r:
            k = [np.uint32((int(k[0]) + int(_W[0])) & 0xFFFFFFFF),
                 np.uint32((int(k[1]) + int(_W[1])) & 0xFFFFFFFF)]
        p0, p1 = _M[0] * c[0], _M[1] * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k[0]), p1 & _LO,
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k[1]), p0 & _LO]
    return np.stack([v.astype(np.uint32) for v in c], axis=-1)


def keep_mask_ref(base: int, numel: int, drop_rate: float, seed: int, first_pass: int = 0,
                  passes: int = 1) -> np.ndarray:
    """Plain version of :func:`keep_mask` in the seed order: the keep bits of
    ``numel`` elements, ``passes`` passes from ``first_pass`` one after
    another, each pass's elements ``base .. base + numel / passes - 1`` of
    its counters, for the int64 ``seed``."""
    s = seed & (2 ** 64 - 1)
    per = numel // passes
    e = np.tile(np.arange(base, base + per, dtype=np.uint64), passes)
    word = np.repeat(np.arange(first_pass, first_pass + passes, dtype=np.uint64), per)
    q = e >> np.uint64(2)
    ctr = np.stack([q & _LO, q >> np.uint64(32), word, 0 * q], axis=-1).astype(np.uint32)
    bits = philox4x32(ctr, (s & 0xFFFFFFFF, s >> 32))
    word = np.take_along_axis(bits, (e & np.uint64(3)).astype(np.int64)[:, None], 1)[:, 0]
    u = (word >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    return u < np.float32(1.0 - drop_rate)
