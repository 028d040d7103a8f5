"""Tensors a kernel derives from parameters, prepared once per parameter set.

A kernel often wants its weights in another dtype or layout than the module
holds them (cast, transposed, folded with BatchNorm statistics).  Doing that
on every call costs launches inside every kernel time; :func:`prepared`
does it once and reuses the result until a parameter changes.

An entry is keyed on the parameters' ids and a tag, and is reused only while
each parameter is the same live object (weak reference), at the same address
(a move or ``.data =`` changes it) and at the same version (an in-place
update bumps it).  Inference tensors carry no version counter and are
prepared anew on every call.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Sequence, TypeVar

import torch

T = TypeVar("T")

# (tag, ids of the parameters) -> (weak refs, stamps, prepared value)
_CACHE: Dict[tuple, tuple] = {}


def _stamp(t: torch.Tensor) -> tuple:
    # an in-place update bumps the version; a move or ``.data =`` the address
    return t.data_ptr(), t.device, None if t.is_inference() else t._version


def prepared(params: Sequence[Optional[torch.Tensor]], tag: tuple,
             make: Callable[[], T]) -> T:
    """``make()``, computed once for ``params`` (``None`` entries allowed)
    under ``tag`` and reused until one of them changes."""
    present = tuple(t for t in params if t is not None)
    key = (tag, *(None if t is None else id(t) for t in params))
    stamps = tuple(map(_stamp, present))
    hit = _CACHE.get(key)
    if (hit is not None and all(r() is t for r, t in zip(hit[0], present))
            and hit[1] == stamps and None not in (s[2] for s in stamps)):
        return hit[2]
    value = make()
    for k in [k for k, v in _CACHE.items() if any(r() is None for r in v[0])]:
        del _CACHE[k]
    _CACHE[key] = (tuple(weakref.ref(t) for t in present), stamps, value)
    return value
