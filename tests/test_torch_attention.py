"""The port's flash attention and attention dispatch vs the JAX package, in fp32.

``flash_attention_ref`` (the CPU path and the kernels' oracle) is held
against the JAX ``flash_attention`` run through its Pallas kernels in
interpret mode, as ``tests/test_pallas_kernels.py`` runs them: the forward
output within 2e-5 and the logsumexp against ``_flash_forward``; gradients
(autograd through the plain version vs ``jax.grad`` through the custom VJP)
within atol 2e-4, rtol 1e-3.
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
from dmf_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

SHAPES = [(256, 256), (512, 1024)]


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


def _qkv(nq, nk, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(1, 2, n, 64) * scale).astype(np.float32)
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


@pytest.mark.parametrize("nq,nk", SHAPES)
def test_gradients_match_pallas_interpret(nq, nk):
    q, k, v = _qkv(nq, nk, 1, scale=0.5)
    cot = np.random.RandomState(2).randn(1, 2, nq, 64).astype(np.float32)

    def loss(q, k, v):
        return (jfa.flash_attention.__wrapped__(q, k, v) * jnp.asarray(cot)).sum()

    ref = _interpret(jax.grad(loss, argnums=(0, 1, 2)), *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash_attention(tq, tk, tv) * torch.from_numpy(cot)).sum().backward()
    for got, r, name in zip((tq.grad, tk.grad, tv.grad), ref, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=2e-4, rtol=1e-3,
                                   err_msg=f"d{name}")


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


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 1, 64, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
