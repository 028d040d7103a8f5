"""The fp32 flash kernels' 3xTF32 arithmetic, replayed on the CPU.

``flash_fwd_tf32x3``, ``flash_bwd_dq_tf32x3`` and ``flash_bwd_dkv_tf32x3``
(``dmf_tpu_torch/csrc/flash_attention.cu``) run fp32 attention and its
gradient on the tensor cores, which take fp32 only as TF32: every operand
(Q, K, V, dO and the P and dS they form) is split into ``hi = rna_tf32(a)``
and ``lo = rna_tf32(a - hi)``, and each k8 step sums ``hi*hi + hi*lo +
lo*hi``.  :func:`replay` computes the forward in plain torch in the
kernel's order: key tiles of 4096 / D keys (the kernel's ring tiles), the
online softmax in log2 units, each tile's P V into a sum of its own added
into the rescaled accumulator.  :func:`replay_backward` computes dQ, dK and
dV the same way: tiles of 2048 / D keys (dQ, taken in turn by two
accumulators that are added at the end) or queries (dK/dV), each tile's dS
K, P^T dO or dS^T Q into a sum of its own.  Each product of two 11-bit
significands is exact in fp32, so fp32 matmuls of the halves are the three
products; the tensor cores' own sums differ from them only in order.

The replays are held against the JAX kernels (``_flash_kernel``, and
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` under the custom VJP) in Pallas
interpret mode (as ``tests/test_torch_attention.py`` runs them) and against
float64, within the port's fp32 tolerance (1e-4 x max(1, max|ref|), the
card tests' ``TOL[float32]``; the gradients 1e-4 x max|ref|, as the card
tests hold them); one TF32 product (``hi*hi``) misses it.  The inputs' q
and k are scaled by 1.5 (scores of standard deviation 2.25), where one TF32
product's error shows above the tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (torch thread pool, MKL_CBWR)

import dmf_tpu.ops.flash_attention as jfa
from dmf_tpu_torch.ops.conv3x3 import rna_tf32
from dmf_tpu_torch.ops.flash_attention import flash_attention_ref

TOL = 1e-4  # TOL[float32] of the card tests and chip_smoke.py
LOG2E = 1.4426950408889634


def _halves(t):
    hi = rna_tf32(t)
    return hi, rna_tf32(t - hi)


def _product(a, b, products=3):
    """``a @ b`` over TF32-split operands: ``hi*hi + hi*lo + lo*hi``, or
    ``hi*hi`` alone for ``products=1``."""
    (ah, al), (bh, bl) = _halves(a), _halves(b)
    out = ah @ bh
    return out + ah @ bl + al @ bh if products == 3 else out


def replay(q, k, v, scale, products=3):
    """``(out, lse)`` of the 3xTF32 forward on (BH, N, D) fp32 tensors;
    ``products=1`` replays one TF32 product (``hi*hi``) in both matmuls."""
    bh, nq, d = q.shape
    bn = 4096 // d  # keys per ring tile: 32 at D=128, 64 at D=64
    c = scale * LOG2E
    product = functools.partial(_product, products=products)
    acc = torch.zeros(bh, nq, d)
    m = torch.full((bh, nq, 1), -1e30)
    l = torch.zeros(bh, nq, 1)
    for t0 in range(0, k.shape[1], bn):
        s = product(q, k[:, t0:t0 + bn].transpose(1, 2))  # raw scores, scaled in exp2
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s * c - m_new * c)
        alpha = torch.exp2((m - m_new) * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + product(p, v[:, t0:t0 + bn])
        m = m_new
    return acc / l, (m * scale + torch.log(l))[..., 0]


def replay_backward(q, k, v, dout, scale, products=3):
    """``(dq, dk, dv)`` of the 3xTF32 backward kernels on (BH, N, D) fp32
    tensors, from :func:`replay`'s ``(out, lse)`` and ``delta = rowsum(dO
    out)``: S = Q K^T and dP = dO V^T (dQ), S^T = K Q^T and dP^T = V dO^T
    (dK/dV), each element three products over D; P = exp2(S scale log2 e -
    lse log2 e), dS = P (dP - delta) scale, in fp32; then per streamed tile
    of 2048 / D rows (16 at D=128, 32 at D=64) its dS K (key tiles taken in
    turn by two fp32 sums, added at the end), P^T dO and dS^T Q (query
    tiles, one fp32 sum each), each the tile's own sum.  ``products=1``
    replays ``hi*hi`` alone in every product."""
    d = q.shape[-1]
    bt = 2048 // d
    c = scale * LOG2E
    product = functools.partial(_product, products=products)
    out, lse = replay(q, k, v, scale, products)
    lse2 = lse * LOG2E
    delta = (dout * out).sum(-1)
    # dQ over key tiles
    p = torch.exp2(product(q, k.transpose(1, 2)) * c - lse2[..., None])
    ds = p * (product(dout, v.transpose(1, 2)) - delta[..., None]) * scale
    acc = [torch.zeros_like(q), torch.zeros_like(q)]
    for i, t0 in enumerate(range(0, k.shape[1], bt)):
        acc[i % 2] += product(ds[..., t0:t0 + bt], k[:, t0:t0 + bt])
    dq = acc[0] + acc[1]
    # dK/dV over query tiles, on the transposed tiles
    pt = torch.exp2(product(k, q.transpose(1, 2)) * c - lse2[:, None, :])
    dst = pt * (product(v, dout.transpose(1, 2)) - delta[:, None, :]) * scale
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for t0 in range(0, q.shape[1], bt):
        dv += product(pt[..., t0:t0 + bt], dout[:, t0:t0 + bt])
        dk += product(dst[..., t0:t0 + bt], q[:, t0:t0 + bt])
    return dq, dk, dv


def _interpret(fn, *args):
    """Run ``fn`` with every ``pallas_call`` in interpret mode, unjitted."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    with jax.disable_jit():
        try:
            pl.pallas_call = functools.partial(orig, interpret=True)
            return fn(*args)
        finally:
            pl.pallas_call = orig


def _qkv(nq, nk, d, seed):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(2, n, d) * s).astype(np.float32)
                 for n, s in ((nq, 1.5), (nk, 1.5), (nk, 1.0)))


def _err(got, ref, floor=1.0):
    """Max |got - ref| over max(floor, max|ref|): the outputs' tolerance
    (floor 1), or the gradients' (floor 0: relative to their own scale)."""
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(floor, np.abs(ref).max()))


# (N_q, N_k, D): the validation shape's sequence at two widths, and ragged
# pairs (N % 128 = 64: the kernel's last 128-row query block half full)
CASES = [pytest.param(4096, 4096, 128, id="4096-d128"),
         pytest.param(192, 320, 64, id="192-320-d64"),
         pytest.param(320, 192, 128, id="320-192-d128")]


@pytest.mark.parametrize("nq,nk,d", CASES)
def test_tf32x3_replay_matches_pallas_interpret(nq, nk, d):
    q, k, v = _qkv(nq, nk, d, 0)
    scale = d ** -0.5
    blocks = (256, 512) if nq % 256 == 0 and nk % 512 == 0 else (64, 64)
    jout, jlse = _interpret(jfa._flash_forward, *map(jnp.asarray, (q, k, v)), scale, *blocks)
    out, lse = replay(*map(torch.from_numpy, (q, k, v)), scale)
    errs = {"out": _err(out.numpy(), jout), "lse": _err(lse.numpy(), np.asarray(jlse)[..., 0])}
    print(f"({nq}, {nk}, {d}) 3xTF32 replay vs JAX: {errs}")
    assert max(errs.values()) <= TOL


@pytest.mark.parametrize("d", [128, 64])
def test_tf32x3_replay_against_float64(d):
    """At (2, 4096, d) the replay is within the tolerance of a float64
    attention, as the plain fp32 version is; one TF32 product is not."""
    q, k, v = _qkv(4096, 4096, d, 1)
    scale = d ** -0.5
    s64 = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k.astype(np.float64)) * scale
    lse64 = np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1)) + s64.max(-1)
    out64 = np.exp(s64 - lse64[..., None]) @ v.astype(np.float64)
    del s64
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    errs = {}
    for name, (out, lse) in (("3xTF32", replay(tq, tk, tv, scale)),
                             ("one TF32 product", replay(tq, tk, tv, scale, products=1)),
                             ("plain fp32", flash_attention_ref(tq, tk, tv, scale))):
        errs[name] = (_err(out.numpy(), out64), _err(lse.numpy(), lse64))
    print(f"D={d}: (out, lse) error against float64 over max(1, max|ref|): {errs}")
    assert max(errs["3xTF32"]) <= TOL and max(errs["plain fp32"]) <= TOL
    assert min(errs["one TF32 product"]) > TOL


# the backward against JAX at 1024 (its 4096 is held against float64 below)
BWD_CASES = [pytest.param(1024, 1024, 128, id="1024-d128"), *CASES[1:]]


@pytest.mark.parametrize("nq,nk,d", BWD_CASES)
def test_tf32x3_backward_replay_matches_pallas_interpret(nq, nk, d):
    """The backward replay against ``jax.vjp`` of the JAX custom VJP (both
    backward kernels) in interpret mode."""
    q, k, v = _qkv(nq, nk, d, 2)
    dout = np.random.RandomState(3).randn(2, nq, d).astype(np.float32)
    scale = d ** -0.5
    blocks = (256, 512) if nq % 256 == 0 and nk % 512 == 0 else (64, 64)

    def grads(q, k, v):
        _, vjp = jax.vjp(lambda q, k, v: jfa._flash_attention(q, k, v, scale, *blocks), q, k, v)
        return vjp(jnp.asarray(dout))

    ref = _interpret(grads, *map(jnp.asarray, (q, k, v)))
    got = replay_backward(*map(torch.from_numpy, (q, k, v, dout)), scale)
    errs = {n: _err(g.numpy(), r, floor=0.0) for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    print(f"({nq}, {nk}, {d}) 3xTF32 backward replay vs JAX: {errs}")
    assert max(errs.values()) <= TOL


@pytest.mark.parametrize("d", [128, 64])
def test_tf32x3_backward_replay_against_float64(d):
    """At (2, 4096, d) the backward replay is within the tolerance of a
    float64 autograd, as the plain fp32 version's autograd is; one TF32
    product is not."""
    q, k, v = _qkv(4096, 4096, d, 4)
    dout = np.random.RandomState(5).randn(2, 4096, d).astype(np.float32)
    scale = d ** -0.5
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    s64 = torch.einsum("bqd,bkd->bqk", *leaves[:2]) * scale
    ref = torch.autograd.grad(torch.softmax(s64, -1) @ leaves[2], leaves,
                              torch.from_numpy(dout).double())
    del s64
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    plain = torch.autograd.grad(flash_attention_ref(*leaves, scale)[0], leaves,
                                torch.from_numpy(dout))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    errs = {}
    for name, got in (("3xTF32", replay_backward(tq, tk, tv, tdo, scale)),
                      ("one TF32 product", replay_backward(tq, tk, tv, tdo, scale, products=1)),
                      ("plain fp32", plain)):
        errs[name] = tuple(_err(g.numpy(), r.numpy(), floor=0.0) for g, r in zip(got, ref))
    print(f"D={d}: (dq, dk, dv) error against float64 over max|ref|: {errs}")
    assert max(errs["3xTF32"]) <= TOL and max(errs["plain fp32"]) <= TOL
    assert min(errs["one TF32 product"]) > TOL
