"""CUDA kernel for the DWI per-image, per-channel z-score.

Replaces the TPU kernel ``_dwi_norm_kernel`` (preprocess_pallas.py:28),
reached through ``dwi_normalize_pallas`` (:49).  The kernel is
``csrc/dwi_norm.cu`` (its note gives the design): the statistics split over
(image, pixel block), a tile's mean and centred M2 from one read of it held
in registers, Chan's merge of each image's partial rows, then the
normalising pass: three kernels that one ctypes call enqueues.  This module plans
the launch (vector width, threads, pixels per block), checks the images and
allocates the output and the scratch.  The library is built on first use,
never on import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .cuda_build import load_library
from .se_cuda import flat_threads

_SOURCES = ("dwi_norm.cu",)
ITEMS = 8    # 16-byte vectors a thread holds: p_blk * C = ITEMS * vec * threads
MAX_C = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("dwi_norm", _SOURCES)
    fn = lib.dwi_norm_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def plan(hw: int, c: int, esize: int, aligned: bool) -> Tuple[int, int, int]:
    """``(vec, threads, p_blk)`` of a launch on images of ``hw`` x ``c``.

    ``vec``: elements per vector load, 16 bytes where the images are 16-byte
    aligned and ``HW * C`` is a multiple of it, else 1.  ``threads``: a
    multiple of ``C / gcd(C, vec)`` (``se_cuda.flat_threads``), so that a
    thread's lanes keep their channels.  ``p_blk``: the pixels of ``ITEMS``
    vectors a thread, the tile a block holds in registers.
    """
    vec = 16 // esize
    if not aligned or (hw * c) % vec:
        vec = 1
    threads = flat_threads(c, vec)
    return vec, threads, ITEMS * vec * threads // c


def launch_dwi_normalize(img: torch.Tensor, clip_z: Tuple[float, float],
                         skip_last: bool, zero_last: bool) -> torch.Tensor:
    """Launch the kernel on contiguous (N, H, W, C) images."""
    if img.dim() != 4 or img.dtype not in _DTYPES:
        raise ValueError(f"dwi_normalize: need (N, H, W, C) fp32/bf16/fp16 images, "
                         f"got {tuple(img.shape)} {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("dwi_normalize: the kernel takes contiguous NHWC images")
    n, h, w, c = img.shape
    hw = h * w
    if hw < 2 or not 1 <= c <= MAX_C:
        raise ValueError(f"dwi_normalize: need at least 2 pixels and 1-{MAX_C} channels, "
                         f"got {hw} x {c}")
    out = torch.empty_like(img)
    aligned = img.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    vec, threads, p_blk = plan(hw, c, img.element_size(), aligned)
    nb = -(-hw // p_blk)
    # scratch: the tiles' means (N, nb, C), their M2 (N, nb, C), then the
    # images' (mean, 1/std) (N, 2, C)
    part = torch.empty(2 * n * (nb + 1) * c, dtype=torch.float32, device=img.device)
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.dwi_norm_launch(_DTYPES[img.dtype], vec, img.data_ptr(), out.data_ptr(),
                                 part.data_ptr(), n, hw, c, threads, p_blk, float(clip_z[0]),
                                 float(clip_z[1]), int(skip_last), int(zero_last), stream)
    if rc != 0:
        raise RuntimeError(f"dwi_normalize: kernel launch failed (CUDA error {rc})")
    return out
