"""The seed route of MC dropout: keep masks from a seed tensor, not a generator.

``torch.export`` can neither take a ``torch.Generator`` as an input nor trace
one, and an MC ensemble should not depend on how its passes are chunked, so
every MC route draws its dropout masks from a :class:`SeedStream`: an int64
seed tensor on the device (the request's Philox key), the passes the current
forward holds, and a Python counter that each dropout site advances by its
element count *per pass*, rounded up to a multiple of 4.  The MC predictor
(``evals/predict.py``) makes the streams: the serving program's seed is its
argument (the JAX serving program takes a ``uint32`` seed and derives its
key inside the program, ``dmf_tpu/serving.py:18-21``), the eager predictor
draws one from the caller's generator per request.

Every keep bit is Philox4x32-10 (Random123) of the key ``(seed lo, seed hi)``
and the counter ``(e/4 lo, e/4 hi, pass, 0)``, word ``e mod 4``, where
``pass`` is the MC pass the element belongs to and ``e`` the site's counter
base plus the element's index within its pass, in the *seed order*:
channels-last (NHWC) for a 4-D tensor, row-major otherwise.  A forward of
``k`` passes holds them pass-major along the first dimension (``passes *
rows``), so a pass's masks are the same bits whether it runs alone or in a
chunk of any size: the counterpart of JAX's one key per pass
(``dmf_tpu/evals/predict.py:349``).  Kernel 1 (``csrc/se_epilogue.cu``)
computes exactly these bits for the epilogue's dropout, its keep-mask
kernel for the other sites, and the flash forward's dropout variant
(``csrc/flash_attention.cu``, the same keep test from ``csrc/philox.cuh``)
for the MC attention's weights, whose mask it never writes; on the CPU :func:`keep_mask_plain` computes them
with torch integer ops, so one seed gives the same masks on the CPU and on
the card whatever the maps' memory format (the CPU's maps are
NCHW-contiguous, the card's channels_last).  A site keeps an element when
``(word >> 8) * 2^-24 < 1 - p`` in fp32.  At pass 0 of a one-pass stream the
bits are those of the counter ``(e/4 lo, e/4 hi, 0, 0)``.

The generator route (a ``torch.Generator``) stays for training and for a
model called directly with ``mc=True``.
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
    """A seed tensor (int64, one element, on the maps' device), the MC passes
    ``first_pass .. first_pass + passes - 1`` that the forward holds
    pass-major along each site's first dimension, and the Philox counter of
    the next dropout site.  Pass it where a dropout takes a ``generator``:
    each site calls :meth:`take` for its counter base."""

    def __init__(self, seed: torch.Tensor, counter: int = 0, first_pass: int = 0,
                 passes: int = 1):
        if passes < 1 or first_pass < 0 or first_pass + passes > 2 ** 32:
            raise ValueError(f"SeedStream: passes {first_pass}..{first_pass + passes - 1} "
                             f"outside the 32-bit pass word")
        self.seed = seed
        self.counter = counter
        self.first_pass = first_pass
        self.passes = passes

    def take(self, numel: int) -> int:
        """The counter base of a site of ``numel`` elements over the
        stream's passes; advances past one pass's elements to the next
        multiple of 4 (the epilogue kernel's vector loads take 4 counters'
        words at once), so a site's base does not depend on ``passes``."""
        if numel % self.passes:
            raise ValueError(f"SeedStream: {numel} elements do not split into "
                             f"{self.passes} passes")
        base = self.counter
        self.counter += -(-(numel // self.passes) // 4) * 4
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


def per_pass(shape: Sequence[int], passes: int) -> int:
    """Elements of one pass of a site of ``shape`` that holds ``passes``
    passes pass-major along its first dimension."""
    if passes < 1 or not shape or shape[0] % passes:
        raise ValueError(f"keep_mask: shape {tuple(shape)} does not split into {passes} "
                         f"passes along its first dimension")
    return math.prod(shape) // passes


def keep_mask_plain(shape: Sequence[int], drop_rate: float, seed: torch.Tensor,
                    base: int = 0, first_pass: int = 0, passes: int = 1) -> torch.Tensor:
    """Plain version of the seed route's keep mask: a bool tensor of
    ``shape`` on ``seed``'s device for ``passes`` passes from ``first_pass``
    (pass-major along the first dimension), whose element ``i`` of pass
    ``p``'s part of the seed order keeps with Philox counter ``base + i``
    and pass word ``first_pass + p``.  A 4-D mask comes back with
    channels_last strides (its seed order is its memory order), as the
    kernel writes it."""
    per = per_pass(shape, passes)
    dev = seed.device
    q = torch.arange(base >> 2, ((base + per - 1) >> 2) + 1, dtype=torch.int64, device=dev)
    n_q = q.numel()
    q = q.repeat(passes)
    word = torch.arange(first_pass, first_pass + passes, dtype=torch.int64,
                        device=dev).repeat_interleave(n_q)
    s = seed.reshape(()).to(torch.int64)
    words = philox4x32(q & _MASK32, q >> 32, word, torch.zeros_like(q), s & _MASK32,
                       (s >> 32) & _MASK32)
    start = base & 3
    flat = torch.stack(words, dim=-1).reshape(passes, -1)[:, start:start + per]
    keep = (flat.reshape(-1) >> 8) < keep_threshold(drop_rate)
    keep = keep.reshape(seed_order_shape(shape))
    return keep.permute(0, 3, 1, 2) if len(shape) == 4 else keep


def keep_mask(x: torch.Tensor, drop_rate: float, seed: torch.Tensor, base: int = 0,
              first_pass: int = 0, passes: int = 1) -> torch.Tensor:
    """The seed route's keep mask for ``x``'s elements (shape and device of
    ``x``; its values are not read): the ``keep_mask`` operator
    (``ops/library.py``), which runs kernel 1's keep-mask kernel for a CUDA
    tensor and :func:`keep_mask_plain` for a CPU one.  The kernel's launches
    count in ``keep_mask.launches``."""
    return torch.ops.dmf.keep_mask(x, drop_rate, seed, base, first_pass, passes)


keep_mask.launches = 0


def seeded_dropout(x: torch.Tensor, p: float, stream: SeedStream) -> torch.Tensor:
    """Dropout with the keep mask of the stream's next site: kept values
    scaled by ``1/(1-p)``, as the generator route."""
    return torch.where(stream_mask(x, p, stream), x / (1.0 - p), 0.0)


def stream_mask(x: torch.Tensor, p: float, stream: SeedStream) -> torch.Tensor:
    """The keep mask of the stream's next site, of ``x``'s shape."""
    return keep_mask(x, p, stream.seed, stream.take(x.numel()), stream.first_pass,
                     stream.passes)
