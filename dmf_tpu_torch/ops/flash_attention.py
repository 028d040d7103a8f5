"""Exact blocked (flash) attention with its gradient: wrapper and plain version.

Counterpart of ``dmf_tpu/ops/flash_attention.py::flash_attention`` (:281)
and its custom VJP (:261-277): the forward kernel ``_flash_kernel`` and the
backward kernels ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``.  The wrapper runs
the plain version below for tensors on the CPU, and the CUDA kernels in
``csrc/flash_attention.cu`` for tensors on a CUDA device, as a
``torch.autograd.Function`` whose forward launches the forward kernel through
its ``torch.library`` operator (``ops/library.py``, so that ``torch.export``
traces it) and whose backward computes ``delta = rowsum(dO * O)`` in plain torch (the JAX
package leaves it to XLA, :189-192) and launches the dQ and dK/dV kernels.
There is no fallback from one to the other.

The bf16 kernels run on Hopper's ``wgmma`` fed by TMA through a shared-memory
ring (``flash_fwd_wgmma``, ``flash_bwd_dq_wgmma``, ``flash_bwd_dkv_wgmma``):
two backward kernels, each owning its output rows, so there are no atomics
and two calls give the same bits.  fp32 runs on the tensor cores as 3xTF32
``wgmma``: every operand split into TF32 halves, three products a k8 step
(hi*hi + hi*lo + lo*hi), each tile's P V, dS K, P^T dO or dS^T Q added into
an fp32 sum.  TF32 ``wgmma`` has no transpose bit, so a pre-pass writes the
streamed operands split, swizzled and, where a product contracts over their
rows, transposed, into a scratch tensor the wrapper allocates for the call:
K and V^T for the forward (``flash_fwd_tf32x3``, 4 x the size of k); K, V
and K^T for dQ (``flash_bwd_dq_tf32x3``, 6 x k); Q, dO, Q^T and dO^T for
dK/dV (``flash_bwd_dkv_tf32x3``, 8 x q).

Numerics: the plain version computes the scores, the softmax and the value
product in fp32 from the input-dtype operands and rounds the output once;
``lse`` is fp32.  The kernels' rounding points are stated in their source.

The forward with attention-weight dropout (:func:`flash_attention_dropout`,
the MC route of ``models/transformer.py`` on a seed stream) replaces what XLA
lowers for JAX's materialized-weights route (``dmf_tpu/models/transformer.py``
:45-49): softmax(Q K^T scale), dropped with the seed route's keep mask
(``ops/dropout.py``) and scaled by 1/(1-p), times V, in the dropout instances
of both forward kernels, which write no mask.  Where one Philox call holds
the bits of several heads (:func:`dropout_group`: H and the counter base
multiples of 4, the served ``hybrid-nb`` sites) the head-shared instance
runs: a pre-pass makes one call for the G heads and writes their keep bits
(1/8 byte a weight, a slab of rows at a time into a scratch tensor of at
most ``DROP_BITS_BYTES``) and the forward reads them; every other shape
takes the per-element instance, which draws one call a weight inside the
forward.  Its plain version, :func:`flash_attention_dropout_ref`, is that
weights route as one function, bit for bit.

Its backward (:class:`_FlashAttentionDropout`, the training route of
``models/transformer.py`` at the flash shapes: JAX's training route is the
same weights route, differentiated by XLA) runs the dropout instances of
the dQ and dK/dV kernels on the forward's lse: with P~ = P keep / (1 - p),
dV = P~^T dO and dS = P (dO V^T keep / (1 - p) - delta), delta =
rowsum(dO * O) as without dropout.  A pre-pass draws the keep bits again, a
slab of rows at a time (at most ``DROP_BITS_BYTES``), in dQ's layout and
then in dK/dV's; nothing of the mask is kept from the forward.  Their plain
versions, :func:`flash_bwd_dq_dropout_ref` and
:func:`flash_bwd_dkv_dropout_ref`, apply those formulas to the seed route's
keep mask.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import dropout
from .cuda_build import load_library

_SOURCES = ("flash_attention.cu",)
# the kernels' tile (rows of queries or keys); N must be a multiple of it
TILE = 64
HEAD_DIMS = (64, 128)
# the head-shared dropout instance's scratch of keep bits: at most this many
# bytes (a slab of rows b at a time), one row b at least
DROP_BITS_BYTES = 32 << 20


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """The fp32 scores S = Q K^T scale of the plain versions."""
    return torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale


def attention_lse(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """The fp32 (..., N_q) log-sum-exp of the scores, the lse every forward
    returns (with or without dropout: the undropped softmax's)."""
    return torch.logsumexp(_scores(q, k, scale), dim=-1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version over (..., N, D) tensors: ``(out, lse)``, ``lse`` fp32 (..., N_q).

    Materializes the fp32 softmax; differentiable by autograd, which makes
    it the oracle of the backward kernels too.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)  # attention_lse's
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("...qk,...kd->...qd", p, v.float()).to(q.dtype)
    return out, lse


def attention_weights(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """The (B, H, N_q, N_k) softmax weights of the plain route (JAX's
    ``_xla_attention``, ``dmf_tpu/ops/attention.py:20-26``): the softmax in
    fp32, cast back to q's dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    return torch.softmax(logits.float(), dim=-1).to(q.dtype)


def flash_attention_dropout_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float, p: float, seed: torch.Tensor, base: int,
                                first_pass: int = 0, passes: int = 1,
                                heads: Optional[int] = None, h0: int = 0) -> torch.Tensor:
    """Plain version of the forward with dropout over (B, H_local, N, D)
    tensors: the weights route as one function.  :func:`attention_weights`,
    times the seed route's keep mask of the whole (B, ``heads``, N_q, N_k)
    weights (``dropout.keep_mask_plain`` at counter ``base``, ``passes``
    passes from ``first_pass`` pass-major along B) narrowed to heads ``h0
    ..`` of this call, / (1 - p), times V; returns ``out``."""
    B, H, nq, _ = q.shape
    heads = H if heads is None else heads
    w = attention_weights(q, k, scale)
    keep = dropout.keep_mask_plain((B, heads, nq, k.shape[2]), p, seed, base, first_pass,
                                   passes).narrow(1, h0, H)
    w = torch.where(keep, w / (1.0 - p), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _dropout_bwd_ref(q, k, v, dout, lse, delta, scale: float, p: float, seed: torch.Tensor,
                     base: int, first_pass: int, passes: int, heads: Optional[int], h0: int):
    """The backward's shared terms in fp32 over (B, H_local, N, D) tensors:
    ``(P, P~, dS)`` from the forward's ``lse`` (B, H_local, N_q), the
    caller's ``delta`` and the seed route's keep mask of the whole (B,
    ``heads``, N_q, N_k) weights narrowed to heads ``h0 ..``, as
    :func:`flash_attention_dropout_ref` draws it."""
    B, H, nq, _ = q.shape
    heads = H if heads is None else heads
    prob = torch.exp(_scores(q, k, scale) - lse[..., None])
    keep = dropout.keep_mask_plain((B, heads, nq, k.shape[2]), p, seed, base, first_pass,
                                   passes).narrow(1, h0, H)
    dropped = torch.where(keep, prob / (1.0 - p), 0.0)
    dpt = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = prob * (torch.where(keep, dpt / (1.0 - p), 0.0) - delta[..., None])
    return prob, dropped, ds


def flash_bwd_dq_dropout_ref(q, k, v, dout, lse, delta, scale: float, p: float,
                             seed: torch.Tensor, base: int, first_pass: int = 0,
                             passes: int = 1, heads: Optional[int] = None,
                             h0: int = 0) -> torch.Tensor:
    """Plain version of the dQ kernel's dropout instance: dQ = scale dS K
    with dS = P (dO V^T keep / (1 - p) - delta), P = exp(S - lse), in fp32,
    rounded once to q's dtype (the arguments as the forward's)."""
    _, _, ds = _dropout_bwd_ref(q, k, v, dout, lse, delta, scale, p, seed, base, first_pass,
                                passes, heads, h0)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_dropout_ref(q, k, v, dout, lse, delta, scale: float, p: float,
                              seed: torch.Tensor, base: int, first_pass: int = 0,
                              passes: int = 1, heads: Optional[int] = None,
                              h0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel's dropout instance: ``(dK, dV)``,
    dK = scale dS^T Q, dV = P~^T dO with P~ = P keep / (1 - p)."""
    _, dropped, ds = _dropout_bwd_ref(q, k, v, dout, lse, delta, scale, p, seed, base,
                                      first_pass, passes, heads, h0)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", dropped, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention", _SOURCES)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_launch.argtypes = [i, i] + [p] * 6 + [i, i, i, f, p]
    lib.flash_bwd_dq_launch.argtypes = [i, i] + [p] * 8 + [i, i, i, f, p]
    lib.flash_bwd_dkv_launch.argtypes = [i, i] + [p] * 9 + [i, i, i, f, p]
    ll = ctypes.c_longlong
    # the dropout launches: their tensors, scratch and bits, then the bits'
    # words, the shape, scale and the dropout's arguments
    tail = [ll, i, i, i, f, p, ll, ll] + [i] * 4 + [f, f, i, p]
    lib.flash_fwd_dropout_launch.argtypes = [i, i] + [p] * 7 + tail
    lib.flash_bwd_dq_dropout_launch.argtypes = [i, i] + [p] * 9 + tail
    lib.flash_bwd_dkv_dropout_launch.argtypes = [i, i] + [p] * 10 + tail
    for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_dkv_launch,
               lib.flash_fwd_dropout_launch, lib.flash_bwd_dq_dropout_launch,
               lib.flash_bwd_dkv_dropout_launch):
        fn.restype = ctypes.c_int
    lib.flash_wgmma_smem.argtypes = [i, i]
    lib.flash_wgmma_smem.restype = i
    return lib


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A (BH, N, D) kernel operand: on like's device, in like's dtype,
    contiguous, 16-byte aligned, N a multiple of the tile."""
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, "
                         f"expected {like.dtype} on {like.device}")
    if t.dim() != 3 or t.shape[-1] != like.shape[-1] or t.shape[0] != like.shape[0]:
        raise ValueError(f"flash_attention: {name} has shape {tuple(t.shape)}, "
                         f"expected (BH, N, {like.shape[-1]}) with BH={like.shape[0]}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous (BH, N, D)")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    if t.shape[1] % TILE or t.shape[1] == 0:
        raise ValueError(f"flash_attention: sequence length {t.shape[1]} of {name} "
                         f"is not a positive multiple of {TILE}")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"flash_attention: {name} too large for 32-bit offsets")


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: need fp32 or bf16, got {q.dtype}")
    if q.dim() != 3 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: need (BH, N, D) with D in {HEAD_DIMS}, "
                         f"got {tuple(q.shape)}")
    if q.shape[0] >= 2 ** 16:
        raise ValueError("flash_attention: B*H must be below 65536 (grid rows)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    if k.shape != v.shape:
        raise ValueError("flash_attention: k and v differ in shape")


def _launch(fn, q: torch.Tensor, *ptrs, nq: int, nk: int, scale: float) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(int(q.dtype == torch.bfloat16), q.shape[-1], *ptrs,
                q.shape[0], nq, nk, scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: {fn.__name__} failed (CUDA error {rc})")


def _scratch(like: torch.Tensor, images: int) -> torch.Tensor:
    """The fp32 kernels' pre-pass images: ``images`` x like's size, freed
    after the call; none for bf16."""
    n = images * like.numel() if like.dtype == torch.float32 else 0
    return torch.empty(n, device=like.device, dtype=torch.float32)


def launch_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on (BH, N, D) CUDA tensors: ``(out, lse)``.

    fp32 takes a scratch tensor of 4 x k's size for the split K/V tiles.
    """
    _check_operands(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], device=q.device, dtype=torch.float32)
    scratch = _scratch(k, 4)
    _launch(_library().flash_fwd_launch, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), scratch.data_ptr(), nq=q.shape[1], nk=k.shape[1],
            scale=scale)
    return out, lse


def _check_dropout(q: torch.Tensor, p: float, seed: torch.Tensor, first_pass: int, passes: int,
                   heads: int, h0: int) -> None:
    if not 0.0 < p < 1.0:
        raise ValueError(f"flash_attention_dropout: p {p} outside (0, 1)")
    if seed.device != q.device or seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("flash_attention_dropout: need one int64 seed on q's device")
    B, H = q.shape[:2]
    if passes < 1 or B % passes or first_pass < 0 or first_pass + passes > 2 ** 32:
        raise ValueError(f"flash_attention_dropout: {B} rows do not hold passes "
                         f"{first_pass}..{first_pass + passes - 1}")
    if h0 < 0 or h0 + H > heads:
        raise ValueError(f"flash_attention_dropout: heads {h0}..{h0 + H - 1} outside {heads}")


def dropout_group(heads: int, h0: int, local_heads: int, base: int) -> int:
    """The heads G whose keep bits one Philox call of the forward's dropout
    holds, for a call of heads ``h0 .. h0 + local_heads - 1`` of ``heads``
    at counter ``base``: the call's four words are heads 4m .. 4m + 3 of one
    weight when ``heads`` and ``base`` are multiples of 4, so one call
    serves 4 of the call's heads (or 2, on a 2-way head shard): the
    head-shared instance.  1 (the per-element instance) for every other
    shape."""
    if heads % 4 or base % 4:
        return 1
    for g in (4, 2):
        if h0 % g == 0 and local_heads % g == 0:
            return g
    return 1


def dropout_key_tile(dtype: torch.dtype, d: int) -> int:
    """Keys a tile of the forward kernel that runs ``dtype`` at head width
    ``d`` (bf16 128; 3xTF32 32 at D=128, 64 at D=64): the head-shared
    instance's bits of a row are N_k rounded up to it, BN / 32 words a tile."""
    return 128 if dtype == torch.bfloat16 else 32768 // (8 * d)


def dropout_bits_words(dtype: torch.dtype, d: int, local_heads: int, nq: int, nk: int) -> int:
    """32-bit words of the pre-pass's keep bits of one row b: ``local_heads``
    x N_q rows of N_k bits rounded up to the key tile (the forward's and
    dQ's layout; dK/dV's is the transposed one, N_q and N_k swapped)."""
    bn = dropout_key_tile(dtype, d)
    return local_heads * nq * -(-nk // bn) * (bn // 32)


def _check_4d(q: torch.Tensor, *others: torch.Tensor) -> None:
    if any(t.dim() != 4 for t in (q, *others)):
        raise ValueError("flash_attention_dropout: need (B, H, N, D) tensors")
    if any(not t.is_contiguous() for t in (q, *others)):
        raise ValueError("flash_attention_dropout: the operands must be contiguous "
                         "(B, H, N, D)")


def _launch_dropout(fn, q: torch.Tensor, k: torch.Tensor, tensors, scratch: torch.Tensor,
                    scale: float, p: float, seed: torch.Tensor, base: int, first_pass: int,
                    passes: int, heads: int, h0: int, group: int, bits_rows: int,
                    bits_cols: int) -> None:
    """One dropout launch ``fn`` on ``tensors`` (the entry point's pointers
    up to its scratch) with a bits scratch of at most ``DROP_BITS_BYTES`` (a
    slab of rows b of ``bits_rows`` x ``bits_cols`` bits a head; none where
    ``bits_rows`` is 0: the forward's per-element instance reads no bits)."""
    _check_dropout(q, p, seed, first_pass, passes, heads, h0)
    if base < 0:
        raise ValueError(f"flash_attention_dropout: negative counter base {base}")
    B, H, nq, d = q.shape
    words = 0
    if bits_rows:
        row = dropout_bits_words(q.dtype, d, H, bits_rows, bits_cols)
        words = row * max(1, min(B, DROP_BITS_BYTES // (4 * row)))
    bits = torch.empty(words, device=q.device, dtype=torch.int32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(int(q.dtype == torch.bfloat16), d, *(t.data_ptr() for t in tensors),
                scratch.data_ptr(), bits.data_ptr(), words, B * H, nq, k.shape[2], scale,
                seed.data_ptr(), base, first_pass, B // passes, heads, h0, H, 1.0 - p,
                1.0 / (1.0 - p), group, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_dropout: {fn.__name__} failed (CUDA error {rc})")


def launch_flash_forward_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: float, p: float, seed: torch.Tensor, base: int,
                                 first_pass: int, passes: int, heads: int,
                                 h0: int, group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward's dropout instance ``group`` on contiguous (B,
    H_local, N, D) CUDA tensors: ``(out, lse)``, lse fp32 (B, H_local, N_q)
    (the undropped softmax's, as the forward's).  ``group``: 1 the
    per-element instance, 2 or 4 the head-shared one (:func:`dropout_group`
    gives the served choice; the library raises on a group the shape does
    not allow).  fp32 takes the forward's scratch; the head-shared instance
    its keep bits, at most ``DROP_BITS_BYTES`` a slab of rows."""
    _check_4d(q, k, v)
    B, H, nq, d = q.shape
    q3, k3, v3 = (t.view(B * H, t.shape[2], d) for t in (q, k, v))
    _check_operands(q3, k3, v3)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
    if B:
        _launch_dropout(_library().flash_fwd_dropout_launch, q, k, (q, k, v, out, lse),
                        _scratch(k3, 4), scale, p, seed, base, first_pass, passes, heads, h0,
                        group, nq if group > 1 else 0, k.shape[2])
    return out, lse


def _check_dropout_backward(q, k, v, dout, lse, delta) -> None:
    _check_4d(q, k, v, dout)
    B, H, nq, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or not t.is_contiguous():
            raise ValueError(f"flash_attention_dropout: {name} must be contiguous (B, H, N_q)")
    _check_backward(*(t.view(B * H, t.shape[2], d) for t in (q, k, v, dout)),
                    lse.view(B * H, nq), delta.view(B * H, nq))


def launch_flash_bwd_dq_dropout(q, k, v, dout, lse, delta, scale: float, p: float,
                                seed: torch.Tensor, base: int, first_pass: int, passes: int,
                                heads: int, h0: int, group: int) -> torch.Tensor:
    """Launch the dQ kernel's dropout instance on contiguous (B, H_local, N,
    D) CUDA tensors, ``lse`` and ``delta`` fp32 (B, H_local, N_q), the
    arguments as the forward's: ``dq``.  The pre-pass redraws the keep bits
    (query-major), one Philox call for ``group`` heads (1: one a weight),
    a slab of rows at a time; fp32 takes the dQ kernel's scratch."""
    _check_dropout_backward(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    if q.shape[0]:
        _launch_dropout(_library().flash_bwd_dq_dropout_launch, q, k,
                        (q, k, v, dout, lse, delta, dq), _scratch(k, 6), scale, p, seed, base,
                        first_pass, passes, heads, h0, group, q.shape[2], k.shape[2])
    return dq


def launch_flash_bwd_dkv_dropout(q, k, v, dout, lse, delta, scale: float, p: float,
                                 seed: torch.Tensor, base: int, first_pass: int, passes: int,
                                 heads: int, h0: int,
                                 group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel's dropout instance (as
    :func:`launch_flash_bwd_dq_dropout`; its keep bits key-major): ``(dk, dv)``."""
    _check_dropout_backward(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.shape[0]:
        _launch_dropout(_library().flash_bwd_dkv_dropout_launch, q, k,
                        (q, k, v, dout, lse, delta, dk, dv), _scratch(q, 8), scale, p, seed,
                        base, first_pass, passes, heads, h0, group, k.shape[2], q.shape[2])
    return dk, dv


def flash_attention_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: float,
                            stream: "dropout.SeedStream", heads: Optional[int] = None,
                            h0: int = 0) -> torch.Tensor:
    """Attention over (B, H_local, N, D) tensors (scale D^-0.5) with dropout
    on its weights, the next site of the seed ``stream``: it takes the counters of the whole
    (B, ``heads``, N, N) weights, as ``stream.take`` on the materialized
    weights would, and this call's heads are ``h0 ..`` of the ``heads`` (a
    model-axis shard).  Through the ``flash_forward_dropout`` operator
    (``ops/library.py``): the dropout kernels for CUDA tensors (counted in
    ``flash_attention_dropout.launches``, and by instance in
    ``launches_shared`` and ``launches_each``; they raise on what they do
    not take), :func:`flash_attention_dropout_ref` for CPU ones.  Where
    autograd records the call, :class:`_FlashAttentionDropout`, whose
    backward runs the ``flash_backward_dq_dropout`` and
    ``flash_backward_dkv_dropout`` operators (their kernels counted in
    ``launches_dq`` and ``launches_dkv``; on the CPU their plain versions)."""
    from .prepared import records_grad

    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_dropout: unsupported device {q.device}")
    heads = q.shape[1] if heads is None else heads
    base = stream.take(q.shape[0] * heads * q.shape[2] * k.shape[2])
    args = (q.shape[-1] ** -0.5, p, stream.seed, base, stream.first_pass, stream.passes, heads, h0)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if records_grad(q, k, v):
        return _FlashAttentionDropout.apply(q, k, v, *args)
    return torch.ops.dmf.flash_forward_dropout(q, k, v, *args)[0]


flash_attention_dropout.launches = 0
flash_attention_dropout.launches_shared = 0  # the head-shared instance
flash_attention_dropout.launches_each = 0  # the per-element instance
flash_attention_dropout.launches_dq = 0  # the backward's dropout instances
flash_attention_dropout.launches_dkv = 0


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward over (BH, N, D) tensors, ``(out, lse)``, through the
    ``flash_forward`` operator (``ops/library.py``): the kernel for CUDA
    tensors (counted in ``flash_attention.launches``), the plain version for
    CPU ones."""
    return torch.ops.dmf.flash_forward(q, k, v, scale)


def _check_backward(q, k, v, dout, lse, delta) -> None:
    _check_operands(q, k, v)
    _check_operand("dout", dout, q)
    if dout.shape != q.shape:
        raise ValueError("flash_attention: dout must have q's shape")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != q.shape[:2] or not t.is_contiguous()
                or t.device != q.device or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} must be contiguous fp32 "
                             f"(BH, N_q) on {q.device}, 16-byte aligned")


def flash_bwd_dq(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    """Launch the dQ kernel; ``lse``, ``delta`` are fp32 (BH, N_q).

    fp32 takes a scratch tensor of 6 x k's size for K's, V's and K^T's images.
    """
    _check_backward(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    scratch = _scratch(k, 6)
    _launch(_library().flash_bwd_dq_launch, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            scratch.data_ptr(), nq=q.shape[1], nk=k.shape[1], scale=scale)
    flash_attention.launches_dq += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale: float):
    """Launch the dK/dV kernel; returns ``(dk, dv)``.

    fp32 takes a scratch tensor of 8 x q's size for Q's, dO's, Q^T's and
    dO^T's images.
    """
    _check_backward(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    scratch = _scratch(q, 8)
    _launch(_library().flash_bwd_dkv_launch, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), nq=q.shape[1], nk=k.shape[1], scale=scale)
    flash_attention.launches_dkv += 1
    return dk, dv


def backward_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Per-row dO.O in fp32: an elementwise product and a reduce, left to torch."""
    return (dout.float() * out.float()).sum(-1)


class _FlashAttention(torch.autograd.Function):
    """The kernels as one differentiable function over (BH, N, D) tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = backward_delta(out, dout)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None


class _FlashAttentionDropout(torch.autograd.Function):
    """Attention with weight dropout over (B, H_local, N, D) tensors,
    differentiable: the dropout forward saves its lse; the backward computes
    delta and runs the dropout instances of dQ and dK/dV (the operators of
    ``ops/library.py``), which redraw the same keep bits from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, p: float, seed, base: int, first_pass: int,
                passes: int, heads: int, h0: int):
        out, lse = torch.ops.dmf.flash_forward_dropout(q, k, v, scale, p, seed, base,
                                                       first_pass, passes, heads, h0)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.args = (scale, p, base, first_pass, passes, heads, h0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seed = ctx.saved_tensors
        scale, p, base, first_pass, passes, heads, h0 = ctx.args
        dout = dout.contiguous()
        delta = backward_delta(out, dout)
        args = (scale, p, seed, base, first_pass, passes, heads, h0)
        dq = torch.ops.dmf.flash_backward_dq_dropout(q, k, v, dout, lse, delta, *args)
        dk, dv = torch.ops.dmf.flash_backward_dkv_dropout(q, k, v, dout, lse, delta, *args)
        return (dq, dk, dv) + (None,) * 8


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, N, D) tensors (self- or cross-shaped), differentiable.

    CPU tensors take :func:`flash_attention_ref` (autograd through it).
    CUDA tensors launch the kernels (fp32 or bf16, D of 64 or 128, N_q and
    N_k multiples of 64, contiguous) and raise on anything else.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: need (B, H, N, D) tensors")
    B, H, nq, d = q.shape
    nk = k.shape[2]
    if any(not t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous (B, H, N, D)")
    out = _FlashAttention.apply(q.view(B * H, nq, d), k.view(B * H, nk, d),
                                v.view(B * H, nk, d), float(scale))
    return out.view(B, H, nq, d)


flash_attention.launches = 0
flash_attention.launches_dq = 0
flash_attention.launches_dkv = 0
