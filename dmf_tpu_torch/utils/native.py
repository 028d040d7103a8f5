"""ctypes bindings of the port's native host library (``csrc/dmf_native.cpp``).

Counterpart of ``dmf_tpu/utils/native.py``: the threaded exact Nyul fit, a
single-array percentile, a parallel row gather and a threaded prefetching
batch loader.  The source is the port's own copy of the JAX package's
``native/dmf_native.cpp`` (same C interface); the JAX package's checked-in
binary is never loaded.  ``g++`` compiles it on first use into
``dmf_tpu_torch/_build/dmf_native-<hash>/`` (``ops/cuda_build.py``: keyed
by the source and the flags, built to a file of the process's own and
renamed into place).  Unlike the JAX loader there is no numpy detour: a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from ..ops.cuda_build import build_library

SOURCES = ("dmf_native.cpp",)
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
VERSION = 1  # dmf_native_version() of the source this module binds

_i64 = ctypes.c_int64
_fp = ctypes.POINTER(ctypes.c_float)
_dp = ctypes.POINTER(ctypes.c_double)
_ip = ctypes.POINTER(ctypes.c_int32)


def build() -> Path:
    """Compile the library if this checkout has not yet; returns its path."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host library builds with g++")
    return build_library("dmf_native", SOURCES, compiler=gxx, flags=GXX_FLAGS)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The library, built on first use, with every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    lib.dmf_native_version.argtypes = []
    lib.dmf_native_version.restype = ctypes.c_int
    if lib.dmf_native_version() != VERSION:
        raise RuntimeError(f"dmf_native version {lib.dmf_native_version()}, "
                           f"expected {VERSION}")
    lib.nyul_fit.argtypes = [_fp, _i64, _i64, _i64, _i64, _dp, ctypes.c_int, _dp, ctypes.c_int]
    lib.nyul_fit.restype = ctypes.c_int
    lib.percentiles.argtypes = [_fp, _i64, _dp, ctypes.c_int, _dp]
    lib.percentiles.restype = ctypes.c_int
    lib.gather_rows.argtypes = [_fp, ctypes.POINTER(_i64), _i64, _i64, _fp, ctypes.c_int]
    lib.gather_rows.restype = ctypes.c_int
    lib.loader_create.argtypes = [ctypes.POINTER(_fp), ctypes.POINTER(_i64), ctypes.c_int,
                                  _ip, _i64, _i64, ctypes.c_int, ctypes.c_uint64,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_fp),
                                ctypes.POINTER(_ip), ctypes.POINTER(_i64)]
    lib.loader_next.restype = _i64
    lib.loader_release.argtypes = [ctypes.c_void_p, _i64]
    lib.loader_release.restype = None
    lib.loader_new_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.loader_new_epoch.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here (``load`` raises why not)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_fp)


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_dp)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"dmf_native {what} refused its arguments (rc {rc})")


def nyul_fit(images: np.ndarray, landmarks: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Threaded exact Nyul fit: (N, H, W, C) images -> (C, L) float64, the
    per-channel landmark percentiles (``np.percentile``'s linear rule)
    averaged over the N images in order."""
    images = np.ascontiguousarray(images, dtype=np.float32)
    landmarks = np.ascontiguousarray(landmarks, dtype=np.float64)
    if images.ndim != 4:
        raise ValueError(f"nyul_fit: expected (N, H, W, C), got {images.shape}")
    n, h, w, c = images.shape
    out = np.zeros((c, len(landmarks)), np.float64)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    _check(load().nyul_fit(_fptr(images), n, h, w, c, _dptr(landmarks), len(landmarks),
                           _dptr(out), n_threads), "nyul_fit")
    return out


def percentiles(data: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``np.percentile(data, q)`` (linear rule) over every element, float64."""
    data = np.ascontiguousarray(np.ravel(data), dtype=np.float32)
    q = np.ascontiguousarray(q, dtype=np.float64)
    out = np.zeros(len(q), np.float64)
    _check(load().percentiles(_fptr(data), data.size, _dptr(q), len(q), _dptr(out)),
           "percentiles")
    return out


def gather_rows(src: np.ndarray, indices: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Parallel ``src[indices]`` over the rows of a float32 array."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if indices.size and (indices.min() < 0 or indices.max() >= len(src)):
        raise IndexError(f"gather_rows: indices outside [0, {len(src)})")
    out = np.empty((len(indices),) + src.shape[1:], np.float32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    _check(load().gather_rows(_fptr(src), indices.ctypes.data_as(ctypes.POINTER(_i64)),
                              len(indices), int(np.prod(src.shape[1:])), _fptr(out),
                              n_threads), "gather_rows")
    return out


class NativeBatchLoader:
    """Threaded prefetching batch loader over K aligned in-memory arrays.

    The native analogue of the reference's DataLoader worker pool
    (num_workers=11, prepare_single_model.py:140-141): C++ threads gather
    shuffled batches into a ring of slots ahead of the consumer; delivery is
    in batch order, the last batch short unless ``drop_last``.  Each epoch's
    order is ``std::shuffle`` of the previous one by ``mt19937_64(seed)``.
    Yields dicts of numpy views that are valid only until the next step
    (the slot is recycled), so consumers copy before advancing.
    ``new_epoch(seed)`` restarts the loader for another pass without
    reallocating the slots.

    ``arrays`` maps names to (N, ...) float arrays; ``labels`` is an
    optional (N,) int array yielded under ``"labels"``.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], labels: Optional[np.ndarray],
                 batch: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, ring_slots: int = 4, n_threads: int = 0):
        self._lib = load()
        # the C loader reads these buffers: keep them alive as long as it
        self._arrays = {k: np.ascontiguousarray(v, np.float32) for k, v in arrays.items()}
        self._labels = (np.ascontiguousarray(labels, np.int32) if labels is not None
                        else None)
        self._names = list(self._arrays)
        lengths = {len(v) for v in self._arrays.values()}
        if self._labels is not None:
            lengths.add(len(self._labels))
        if len(lengths) != 1 or not self._names:
            raise ValueError("NativeBatchLoader: needs float arrays of one length")
        self.n = lengths.pop()
        self.batch = int(batch)
        self.shapes = {k: v.shape[1:] for k, v in self._arrays.items()}
        K = len(self._names)
        ptrs = (_fp * K)(*[_fptr(self._arrays[k]) for k in self._names])
        elems = (_i64 * K)(*[int(np.prod(self.shapes[k])) for k in self._names])
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 11)
        labels_ptr = self._labels.ctypes.data_as(_ip) if self._labels is not None else _ip()
        self._h = self._lib.loader_create(ptrs, elems, K, labels_ptr, self.n, self.batch,
                                          int(shuffle), seed, int(drop_last), ring_slots,
                                          n_threads)
        if not self._h:
            raise RuntimeError("loader_create refused its arguments")
        # epoch generation: a generator abandoned across new_epoch() must not
        # release a slot that the new epoch's workers may have claimed again
        self._gen = 0

    def new_epoch(self, seed: int) -> None:
        self._gen += 1
        self._lib.loader_new_epoch(self._h, seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        K = len(self._names)
        while True:
            outs = (_fp * K)()
            labels = _ip()
            slot = _i64(0)
            size = self._lib.loader_next(self._h, outs, ctypes.byref(labels),
                                         ctypes.byref(slot))
            if size == 0:
                return
            gen = self._gen
            batch = {}
            for a, name in enumerate(self._names):
                shape = self.shapes[name]
                n_el = int(np.prod(shape))
                flat = np.ctypeslib.as_array(outs[a], shape=(self.batch * n_el,))
                batch[name] = flat[:size * n_el].reshape((size,) + shape)
            if self._labels is not None:
                batch["labels"] = np.ctypeslib.as_array(labels, shape=(self.batch,))[:size]
            try:
                yield batch
            finally:
                # the handle may be closed, or the epoch restarted, while this
                # generator was suspended
                if self._h and gen == self._gen:
                    self._lib.loader_release(self._h, slot.value)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
