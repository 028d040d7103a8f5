"""Tensors a kernel derives from parameters, prepared once per parameter set.

A kernel often wants its weights in another dtype or layout than the module
holds them (cast, transposed, folded with BatchNorm statistics).  Doing that
on every call costs launches inside every kernel time; :func:`prepared`
does it once and reuses the result until a parameter changes.

An entry is keyed on the parameters' ids and a tag, and is reused only while
each parameter is the same live object (weak reference), at the same address
(a move or ``.data =`` changes it) and at the same version (an in-place
update bumps it).  Inference tensors carry no version counter and are
prepared anew on every call.  Under tracing (``torch.export``, a fake or
functional tensor, ``torch.compile``) the parameters have no stable address
or version, so ``make()`` is computed inline: its ops become graph ops that
run on every call of the traced program.  The kernels' operators
(``ops/library.py``) prepare their weights inside their CUDA implementation,
on real tensors, so an exported program holds none of these ops and its
weights are prepared once per parameter set, as in eager mode.

Beside it, what the kernel wrappers share: :func:`mlp_weights`, the SE MLP's
weights as the SE kernels read them, :func:`check_no_grad`, the raise where
autograd would record a kernel that has no backward, and
:func:`records_grad`, the test behind it.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple, TypeVar

import torch

T = TypeVar("T")

# (tag, ids of the parameters) -> (weak refs, stamps, prepared value)
_CACHE: Dict[tuple, tuple] = {}


def _stamp(t: torch.Tensor) -> tuple:
    # an in-place update bumps the version; a move or ``.data =`` the address
    return t.data_ptr(), t.device, None if t.is_inference() else t._version


def tracing(tensors: Sequence[torch.Tensor]) -> bool:
    """True while a tracer runs: ``torch.compile`` / dynamo, or a fake
    (``torch.export``) or functional tensor among ``tensors``."""
    from torch._subclasses.fake_tensor import is_fake

    return (torch.compiler.is_compiling()
            or any(is_fake(t) or torch._is_functional_tensor(t) for t in tensors))


def prepared(params: Sequence[Optional[torch.Tensor]], tag: tuple,
             make: Callable[[], T]) -> T:
    """``make()``, computed once for ``params`` (``None`` entries allowed)
    under ``tag`` and reused until one of them changes; computed inline, and
    not cached, under tracing."""
    present = tuple(t for t in params if t is not None)
    if tracing(present):
        return make()
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


def mlp_weights(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                c: int, mid: int, dt: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """``(W1 (mid, C), b1, W2^T (mid, C), b2)`` in the map dtype, contiguous,
    as the SE MLP of the epilogue and standalone SE kernels reads them; made
    once per parameter set and reused until a parameter changes
    (:func:`prepared`), so a call pays only its launches."""
    return prepared((w1, b1, w2, b2), ("se_mlp", dt), lambda: (
        w1.detach().reshape(mid, c).to(dt, copy=True),
        b1.detach().reshape(mid).to(dt, copy=True),
        w2.detach().reshape(c, mid).t().to(dt, copy=True).contiguous(),
        b2.detach().reshape(c).to(dt, copy=True)))


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record the call: the CUDA kernels have no
    backward, and a silent gap in the graph would train nothing."""
    if records_grad(*tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it under "
                           f"torch.no_grad() (a model trains on its train=True route, "
                           f"which calls no kernel)")
