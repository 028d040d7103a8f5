"""The port's flash attention and attention dispatch vs the JAX package, in fp32.

``flash_attention_ref`` (the CPU path and the kernels' oracle) is held
against the JAX ``flash_attention`` run through its Pallas kernels in
interpret mode, as ``tests/test_pallas_kernels.py`` runs them: the forward
output within 2e-5 and the logsumexp against ``_flash_forward``; gradients
(autograd through the plain version vs ``jax.grad`` through the custom VJP)
within atol 2e-4, rtol 1e-3.

A CPU replay of the bf16 backward kernels' arithmetic (their tiles, their
rounding points, their masks) is held against autograd through the plain
version at the card tests' bf16 tolerance, 2^-7 x max|plain|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (torch thread pool)

import dmf_tpu.ops.flash_attention as jfa
from dmf_tpu.ops.attention import _xla_attention
from dmf_tpu_torch.ops import attention as patt
from dmf_tpu_torch.ops import flash_attention as fa
from dmf_tpu_torch.ops.flash_attention import (backward_delta, flash_attention,
                                              flash_attention_ref)

SHAPES = [(256, 256), (512, 1024)]
# (N_q, N_k, D) of the gradient parity: D = 128 beside 64, and ragged pairs
# (N_q != N_k, N % 128 = 64: the kernels' last 128-row block is half full)
GRAD_CASES = [pytest.param(256, 256, 64, id="256-256"),
              pytest.param(512, 1024, 64, id="512-1024"),
              pytest.param(256, 256, 128, id="256-256-d128"),
              pytest.param(192, 320, 64, id="192-320"),
              pytest.param(192, 448, 128, id="192-448-d128")]


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


def _qkv(nq, nk, seed, scale=1.0, d=64):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(1, 2, n, d) * scale).astype(np.float32)
                 for n in (nq, nk, nk))


@pytest.mark.parametrize("nq,nk", SHAPES)
def test_forward_matches_pallas_interpret(nq, nk):
    q, k, v = _qkv(nq, nk, 0)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = _interpret(jfa.flash_attention.__wrapped__, jq, jk, jv)
    scale = 64 ** -0.5
    _, jlse = _interpret(jfa._flash_forward, jq.reshape(2, nq, 64), jk.reshape(2, nk, 64),
                         jv.reshape(2, nk, 64), scale, min(256, nq), min(512, nk))
    out, lse = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.reshape(2, nq).numpy(),
                               np.asarray(jlse).reshape(2, nq), atol=2e-5, rtol=0)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = (flash_attention.launches, flash_attention.launches_dq)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert torch.equal(got, out)
    assert (flash_attention.launches, flash_attention.launches_dq) == before


@pytest.mark.parametrize("nq,nk,d", GRAD_CASES)
def test_gradients_match_pallas_interpret(nq, nk, d):
    q, k, v = _qkv(nq, nk, 1, scale=0.5, d=d)
    cot = np.random.RandomState(2).randn(1, 2, nq, d).astype(np.float32)

    def loss(q, k, v):
        return (jfa.flash_attention.__wrapped__(q, k, v) * jnp.asarray(cot)).sum()

    ref = _interpret(jax.grad(loss, argnums=(0, 1, 2)), *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash_attention(tq, tk, tv) * torch.from_numpy(cot)).sum().backward()
    for got, r, name in zip((tq.grad, tk.grad, tv.grad), ref, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=2e-4, rtol=1e-3,
                                   err_msg=f"d{name}")


BM, BT = 128, 64  # the bf16 kernels' block rows and ring tile rows
LOG2E = 1.4426950408889634


def _replay_backward(q, k, v, dout, scale):
    """``(dq, dk, dv)`` of the bf16 kernels, replayed in fp32 on (BH, N, D) tensors.

    As ``flash_bwd_dq_wgmma`` / ``flash_bwd_dkv_wgmma`` compute them: the
    forward's bf16 ``out`` and fp32 ``lse``, ``delta = rowsum(dO * O)``;
    operands zero past N up to a whole 128-row block (what TMA reads);
    ``P = exp2(S scale log2 e - lse log2 e)`` in fp32 with P = 0 for keys past
    N_k (dQ) and queries past N_q (dK/dV); ``dS = P (dP - delta) scale`` from
    the fp32 P; P (for dV) and dS rounded to bf16 before their products; fp32
    accumulators summed tile by tile in the kernels' order (64 keys a step for
    dQ, 64 queries for dK/dV); outputs rounded once.
    """
    f = torch.nn.functional
    bh, nq, d = q.shape
    nk = k.shape[1]
    out, lse = flash_attention_ref(q, k, v, scale)
    delta = backward_delta(out, dout)
    nq_p, nk_p = -(-nq // BM) * BM, -(-nk // BM) * BM

    def rows(t, n):
        return f.pad(t.float(), (0, 0, 0, n - t.shape[1]))

    qf, dof, kf, vf = rows(q, nq_p), rows(dout, nq_p), rows(k, nk_p), rows(v, nk_p)
    lse2 = f.pad(lse, (0, nq_p - nq)) * LOG2E
    dl = f.pad(delta, (0, nq_p - nq))
    c = scale * LOG2E

    def rounded(t):
        return t.to(torch.bfloat16).float()

    acc = torch.zeros(bh, nq_p, d)
    for t in range(-(-nk // BT)):
        kt, vt = kf[:, t * BT:(t + 1) * BT], vf[:, t * BT:(t + 1) * BT]
        p = torch.exp2(qf @ kt.transpose(1, 2) * c - lse2[..., None])
        p = p.masked_fill(t * BT + torch.arange(BT) >= nk, 0.0)
        ds = p * (dof @ vt.transpose(1, 2) - dl[..., None]) * scale
        acc = acc + rounded(ds) @ kt
    acc_k, acc_v = torch.zeros(bh, nk_p, d), torch.zeros(bh, nk_p, d)
    for t in range(-(-nq // BT)):
        sl = slice(t * BT, (t + 1) * BT)
        qt, dot = qf[:, sl], dof[:, sl]
        p = torch.exp2(kf @ qt.transpose(1, 2) * c - lse2[:, None, sl])  # P^T
        p = p.masked_fill(t * BT + torch.arange(BT) >= nq, 0.0)
        ds = p * (vf @ dot.transpose(1, 2) - dl[:, None, sl]) * scale
        acc_v = acc_v + rounded(p) @ dot
        acc_k = acc_k + rounded(ds) @ qt
    return tuple(a[:, :n].to(torch.bfloat16) for a, n in
                 ((acc, nq), (acc_k, nk), (acc_v, nk)))


@pytest.mark.parametrize("nq,nk,d", [(128, 128, 64), (64, 192, 128), (192, 320, 64),
                                     (320, 192, 128), (4096, 4096, 64), (4096, 4096, 128)])
def test_bf16_backward_replay_within_card_tolerance(nq, nk, d):
    """The kernels' rounding points (P and dS to bf16, fp32 sums in tile
    order, masked rows and keys) stay within the card tests' bf16 tolerance,
    2^-7 x max|plain|, of autograd through the plain version, at the card
    tests' shapes: the tolerance covers the rounding before a card is
    involved."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, n, d).astype(np.float32)).to(torch.bfloat16)
               for n in (nq, nk, nk))
    cot = torch.from_numpy(rng.randn(2, nq, d).astype(np.float32)).to(torch.bfloat16)
    scale = d ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (flash_attention_ref(*leaves, scale)[0].float() * cot.float()).sum().backward()
    got = _replay_backward(q, k, v, cot, scale)
    for g, leaf, name in zip(got, leaves, ("dq", "dk", "dv")):
        ref = leaf.grad.float()
        err = (g.float() - ref).abs().max().item()
        assert g.dtype == torch.bfloat16 and g.shape == leaf.shape
        assert err <= 2.0 ** -7 * ref.abs().max().item(), name


def _jax_rule(nq, nk, return_weights):
    """ops/attention.py:53-59 of the JAX package, minus its TPU-backend term."""
    bq, bk = jfa.DEFAULT_BLOCK_Q, jfa.DEFAULT_BLOCK_K
    return (not return_weights and nq >= 512 and nq == nk
            and nq % min(bq, nq) == 0 and nq % min(bk, nq) == 0)


@pytest.mark.parametrize("nq,nk,rw", [
    (16, 16, True), (16, 16, False), (256, 256, False), (511, 511, False),
    (512, 512, False), (512, 512, True), (768, 768, False), (1024, 1024, False),
    (2304, 2304, False), (4096, 4096, False), (4096, 4096, True), (512, 1024, False),
    (1024, 512, False), (8192, 8192, False)])
def test_dispatch_rule_matches_jax(nq, nk, rw):
    assert patt.use_flash(nq, nk, rw) == _jax_rule(nq, nk, rw)


@pytest.mark.parametrize("return_weights", [False, True])
def test_plain_route_matches_xla_route(return_weights):
    q, k, v = _qkv(16, 24, 3)
    jout, jw = _xla_attention(*map(jnp.asarray, (q, k, v)), 64 ** -0.5)
    got = patt.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                            return_weights=return_weights)
    out = got[0] if return_weights else got
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=0)
    if return_weights:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jw), atol=2e-6, rtol=0)


def test_cpu_tensors_at_flash_shapes_take_the_plain_route():
    """N=512 qualifies for the flash route, but only CUDA tensors take it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(512, 512, 4))
    before = flash_attention.launches
    out = patt.scaled_dot_product_attention(q, k, v)
    torch.testing.assert_close(out, patt.plain_attention(q, k, v, 0.125)[0])
    assert flash_attention.launches == before


def test_backward_rejects_unaligned_statistics():
    """The dK/dV kernel bulk-copies each tile's lse and delta entries, which
    needs 16-byte aligned rows: the backward checks refuse an lse or delta
    one element past an aligned address."""
    q = torch.zeros(2, 64, 64)
    good = torch.zeros(2, 64)
    bad = torch.zeros(2 * 64 + 1)[1:].view(2, 64)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    fa._check_backward(q, q, q, q, good, good)
    for lse, delta, name in ((bad, good, "lse"), (good, bad, "delta")):
        with pytest.raises(ValueError, match=f"{name} must be .*16-byte aligned"):
            fa._check_backward(q, q, q, q, lse, delta)


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 1, 64, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
