"""The seed route of MC dropout: keep masks from a seed tensor, not a generator.

``torch.export`` can neither take a ``torch.Generator`` as an input nor trace
one, so the serving program (``serving.py``) draws its dropout masks from a
:class:`SeedStream`: an int64 seed tensor on the device and a Python counter
that each dropout site advances by its element count, rounded up to a
multiple of 4.  The JAX serving program takes a ``uint32`` seed and derives
its key inside the program (``dmf_tpu/serving.py:18-21``); here the seed is
the Philox key.

Every keep bit is Philox4x32-10 (Random123) of the key ``(seed lo, seed hi)``
and the counter ``(e/4 lo, e/4 hi, 0, 0)``, word ``e mod 4``, where ``e`` is
the site's counter base plus the element's index in the *seed order*:
channels-last (NHWC) for a 4-D tensor, row-major otherwise.  Kernel 1
(``csrc/se_epilogue.cu``) computes exactly these bits for the epilogue's
dropout, and its keep-mask kernel for the other sites; on the CPU
:func:`keep_mask_plain` computes them with torch integer ops, so one seed
gives the same masks on the CPU and on the card whatever the maps' memory
format (the CPU's maps are NCHW-contiguous, the card's channels_last).  A
site keeps an element when ``(word >> 8) * 2^-24 < 1 - p`` in fp32.

The generator route (a ``torch.Generator``) stays for training, the eager
predictor and every earlier test.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)


class SeedStream:
    """A seed tensor (int64, one element, on the maps' device) and the Philox
    counter of the next dropout site.  Pass it where a dropout takes a
    ``generator``: each site calls :meth:`take` for its counter base."""

    def __init__(self, seed: torch.Tensor, counter: int = 0):
        self.seed = seed
        self.counter = counter

    def take(self, numel: int) -> int:
        """The counter base of a site of ``numel`` elements; advances past
        it to the next multiple of 4 (the epilogue kernel's vector loads
        take 4 counters' words at once)."""
        base = self.counter
        self.counter += -(-numel // 4) * 4
        return base


def seed_order_shape(shape: Sequence[int]) -> tuple:
    """The shape whose row-major order is the seed order of ``shape``."""
    if len(shape) == 4:
        n, c, h, w = shape
        return n, h, w, c
    return tuple(shape)


def _mulhilo(m: int, c: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``m * c`` for a 32-bit constant ``m`` and
    int64 tensor ``c`` in ``[0, 2^32)``, in int64 without overflow: ``c`` in
    16-bit halves, each partial product below 2^48."""
    p0 = m * (c & 0xFFFF)
    p1 = m * (c >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (t >> 32), t & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words; returns the four
    output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _WEYL[0]) & _MASK32
            k1 = (k1 + _WEYL[1]) & _MASK32
        hi0, lo0 = _mulhilo(_MUL[0], c0)
        hi1, lo1 = _mulhilo(_MUL[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(drop_rate: float) -> int:
    """The integer ``T`` with ``(word >> 8) < T`` exactly when
    ``(word >> 8) * 2^-24 < float32(1 - p)``: the fp32 keep test in
    integers (both sides scaled by 2^24, which is exact)."""
    return math.ceil(float(np.float32(1.0 - drop_rate)) * 2.0 ** 24)


def keep_mask_plain(shape: Sequence[int], drop_rate: float, seed: torch.Tensor,
                    base: int = 0) -> torch.Tensor:
    """Plain version of the seed route's keep mask: a bool tensor of
    ``shape`` on ``seed``'s device whose element ``i`` of the seed order
    keeps with Philox counter ``base + i``.  A 4-D mask comes back with
    channels_last strides (its seed order is its memory order), as the
    kernel writes it."""
    numel = math.prod(shape)
    dev = seed.device
    q = torch.arange(base >> 2, ((base + numel - 1) >> 2) + 1, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(q)
    s = seed.reshape(()).to(torch.int64)
    words = philox4x32(q & _MASK32, q >> 32, zero, zero, s & _MASK32, (s >> 32) & _MASK32)
    start = base & 3
    flat = torch.stack(words, dim=-1).reshape(-1)[start:start + numel]
    keep = (flat >> 8) < keep_threshold(drop_rate)
    keep = keep.reshape(seed_order_shape(shape))
    return keep.permute(0, 3, 1, 2) if len(shape) == 4 else keep


def keep_mask(x: torch.Tensor, drop_rate: float, seed: torch.Tensor, base: int = 0
              ) -> torch.Tensor:
    """The seed route's keep mask for ``x``'s elements (shape and device of
    ``x``): the ``keep_mask`` operator (``ops/library.py``), which runs
    kernel 1's keep-mask kernel for a CUDA tensor and :func:`keep_mask_plain`
    for a CPU one.  The kernel's launches count in ``keep_mask.launches``."""
    return torch.ops.dmf.keep_mask(x, drop_rate, seed, base)


keep_mask.launches = 0


def seeded_dropout(x: torch.Tensor, p: float, stream: SeedStream) -> torch.Tensor:
    """Dropout with the keep mask of the stream's next site: kept values
    scaled by ``1/(1-p)``, as the generator route."""
    keep = keep_mask(x, p, stream.seed, stream.take(x.numel()))
    return torch.where(keep, x / (1.0 - p), 0.0)
