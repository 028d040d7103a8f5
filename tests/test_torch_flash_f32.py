"""The fp32 flash forward's 3xTF32 arithmetic, replayed on the CPU.

``flash_fwd_tf32x3`` (``dmf_tpu_torch/csrc/flash_attention.cu``) runs the
fp32 forward on the tensor cores, which take fp32 only as TF32: every
operand (Q, K, V and the softmax's P) is split into ``hi = rna_tf32(a)`` and
``lo = rna_tf32(a - hi)``, and each k8 step sums ``hi*hi + hi*lo + lo*hi``.
:func:`replay` computes that in plain torch in the kernel's order: key
tiles of 4096 / D keys (the kernel's ring tiles), the online softmax in
log2 units, each tile's P V into a sum of its own added into the rescaled
accumulator.  Each product of two 11-bit significands is exact in fp32, so
fp32 matmuls of the halves are the three products; the tensor cores' own
sums differ from them only in order.

The replay is held against the JAX ``_flash_kernel`` in Pallas interpret
mode (as ``tests/test_torch_attention.py`` runs it) and against a float64
attention, within the port's fp32 tolerance (1e-4 x max(1, max|ref|), the
card tests' ``TOL[float32]``); one TF32 product (``hi*hi``) misses it.
The inputs' q and k are scaled by 1.5 (scores of standard deviation 2.25),
where one TF32 product's error shows above the tolerance.
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


def replay(q, k, v, scale, products=3):
    """``(out, lse)`` of the 3xTF32 forward on (BH, N, D) fp32 tensors;
    ``products=1`` replays one TF32 product (``hi*hi``) in both matmuls."""
    bh, nq, d = q.shape
    bn = 4096 // d  # keys per ring tile: 32 at D=128, 64 at D=64
    c = scale * LOG2E

    def halves(t):
        hi = rna_tf32(t)
        return hi, rna_tf32(t - hi)

    def product(a, b):  # a @ b over split operands
        (ah, al), (bh_, bl) = halves(a), halves(b)
        out = ah @ bh_
        return out + ah @ bl + al @ bh_ if products == 3 else out

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


def _err(got, ref):
    """Max |got - ref| over max(1, max|ref|)."""
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / max(1.0, np.abs(ref).max()))


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
