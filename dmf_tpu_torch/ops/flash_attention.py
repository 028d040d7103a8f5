"""Exact blocked (flash) attention with its gradient: wrapper and plain version.

Counterpart of ``dmf_tpu/ops/flash_attention.py::flash_attention`` (:281)
and its custom VJP (:261-277): the forward kernel ``_flash_kernel`` and the
backward kernels ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``.  The wrapper runs
the plain version below for tensors on the CPU, and the CUDA kernels in
``csrc/flash_attention.cu`` for tensors on a CUDA device, as a
``torch.autograd.Function`` whose forward launches the forward kernel and
whose backward computes ``delta = rowsum(dO * O)`` in plain torch (the JAX
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
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from .cuda_build import load_library

_SOURCES = ("flash_attention.cu",)
# the kernels' tile (rows of queries or keys); N must be a multiple of it
TILE = 64
HEAD_DIMS = (64, 128)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version over (..., N, D) tensors: ``(out, lse)``, ``lse`` fp32 (..., N_q).

    Materializes the fp32 softmax; differentiable by autograd, which makes
    it the oracle of the backward kernels too.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("...qk,...kd->...qd", p, v.float()).to(q.dtype)
    return out, lse


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("flash_attention", _SOURCES)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_launch.argtypes = [i, i] + [p] * 6 + [i, i, i, f, p]
    lib.flash_bwd_dq_launch.argtypes = [i, i] + [p] * 8 + [i, i, i, f, p]
    lib.flash_bwd_dkv_launch.argtypes = [i, i] + [p] * 9 + [i, i, i, f, p]
    for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_dkv_launch):
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


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
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
    flash_attention.launches += 1
    return out, lse


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
