"""The backward of the attention-weight dropout (the training route) on the CPU.

At the flash shapes a training call of the port's MHSA (``mc=True`` with a
``torch.Generator``) draws one seed from the generator and runs
``flash_attention_dropout`` under autograd: the ``flash_forward_dropout``
operator, then ``flash_backward_dq_dropout`` and
``flash_backward_dkv_dropout``, whose CPU implementations are the plain
versions ``flash_bwd_dq_dropout_ref`` / ``flash_bwd_dkv_dropout_ref`` (the
explicit formulas, not autograd).  Held here, fp32:

* (a) the plain backward against ``jax.vjp`` of JAX's weights route
  (``_xla_attention``'s weights times the seed route's keep mask / (1 - p),
  times V) at rel 1e-5, over drop rates, passes, counter bases, 4 and 2
  heads and a 2-way head shard (heads ``h0 ..`` of the whole mask);
* (b) the whole CPU route (the autograd function over the three operators)
  against autograd through ``flash_attention_dropout_ref``;
* (c) the dropout forward's lse equal to ``flash_attention_ref``'s (the
  undropped softmax's), which the backward takes;
* (d) MHSA at 512 tokens in train mode with a ``torch.Generator``: the fused
  route on the seed drawn from it, its input and parameter gradients
  against JAX's module function with that mask injected; a data mesh
  rank's rows take their counters of the whole batch's weights.

The kernels are held on the card (``tests/test_torch_cuda.py`` under the
``cuda`` mark, ``chip_smoke.py`` phases 3j and 3h).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_dropout import SEED, _jax_mhsa
from test_torch_helpers import assert_close

from dmf_tpu.ops.attention import _xla_attention
from dmf_tpu_torch.ops import dropout, flash_attention
from dmf_tpu_torch.ops.flash_attention import (attention_lse, backward_delta,
                                               flash_attention_dropout,
                                               flash_attention_dropout_ref, flash_attention_ref,
                                               flash_bwd_dkv_dropout_ref,
                                               flash_bwd_dq_dropout_ref)

N, D = 64, 16


def _inputs(b, h, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, h, N, D).astype(np.float32)) for _ in range(4)]


def _plain_grads(q, k, v, dout, args):
    """The plain forward's out and lse, delta, then the plain backward."""
    out = flash_attention_dropout_ref(q, k, v, *args)
    lse = attention_lse(q, k, args[0])
    delta = backward_delta(out, dout)
    dq = flash_bwd_dq_dropout_ref(q, k, v, dout, lse, delta, *args)
    return (dq, *flash_bwd_dkv_dropout_ref(q, k, v, dout, lse, delta, *args))


# (p, passes, first pass, counter base, whole heads, h0, local heads)
CASES = [(0.1, 1, 0, 0, 4, 0, 4), (0.3, 2, 3, 12, 4, 0, 4), (0.1, 3, 0, 8, 2, 0, 2),
         (0.2, 1, 5, 6, 4, 0, 4), (0.1, 2, 1, 36, 4, 2, 2), (0.5, 1, 0, 0, 4, 0, 2)]


@pytest.mark.parametrize("p,passes,first,base,heads,h0,local", CASES)
def test_plain_backward_is_jax_vjp_of_the_weights_route(p, passes, first, base, heads, h0, local):
    b = 2 * passes
    q, k, v, dout = _inputs(b, local, seed=passes + heads + h0)
    seed = torch.tensor(SEED)
    scale = D ** -0.5
    keep = dropout.keep_mask_plain((b, heads, N, N), p, seed, base, first, passes)
    keep = jnp.asarray(keep.narrow(1, h0, local).numpy())

    def weights_route(q_, k_, v_):
        _, w = _xla_attention(q_, k_, v_, scale)
        return jnp.einsum("bhqk,bhkd->bhqd", w * keep / (1.0 - p), v_)

    _, vjp = jax.vjp(weights_route, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(dout.numpy()))
    got = _plain_grads(q, k, v, dout, (scale, p, seed, base, first, passes, heads, h0))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, w, rtol=1e-5, what=name)


@pytest.mark.parametrize("p,passes,first,base,heads,h0,local", CASES[1:5])
def test_cpu_route_matches_autograd_through_the_plain_forward(p, passes, first, base, heads,
                                                               h0, local):
    """``flash_attention_dropout`` under autograd (the operators' CPU
    implementations) against autograd through the plain forward, and the
    stream advanced as the forward's site."""
    b = 2 * passes
    q, k, v, dout = _inputs(b, local, seed=7 + h0)
    seed = torch.tensor(SEED)
    args = (D ** -0.5, p, seed, base, first, passes, heads, h0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_dropout_ref(*leaves, *args), leaves, dout)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    stream = dropout.SeedStream(seed, counter=base, first_pass=first, passes=passes)
    out = flash_attention_dropout(*leaves, p, stream, heads=heads, h0=h0)
    assert out.grad_fn is not None and "FlashAttentionDropout" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, dout)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, w, rtol=1e-5, what=name)
    assert stream.counter == base + b * heads * N * N // passes


def test_forward_lse_is_the_undropped_softmax():
    q, k, v, _ = _inputs(2, 4, seed=3)
    out, lse = torch.ops.dmf.flash_forward_dropout(q, k, v, D ** -0.5, 0.1, torch.tensor(SEED),
                                                   0, 0, 1, 4, 0)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    assert torch.equal(lse, flash_attention_ref(q, k, v, D ** -0.5)[1])
    assert torch.equal(out, flash_attention_dropout_ref(q, k, v, D ** -0.5, 0.1,
                                                        torch.tensor(SEED), 0))


def test_train_mode_mhsa_matches_jax_with_the_drawn_mask(monkeypatch):
    """Train mode at 512 tokens: one seed drawn from the generator, the
    fused route at counter 0 (the forward's plain version called once, the
    backward operators once each), the gradients of the input and of every
    parameter against ``jax.vjp`` of JAX's module function with that seed's
    mask injected into its weights."""
    p = 0.1
    x, _, params, pm = _jax_mhsa(p)
    B, n, C, H = 2, 512, 32, 2
    calls = []
    ref = flash_attention.flash_attention_dropout_ref
    monkeypatch.setattr(flash_attention, "flash_attention_dropout_ref",
                        lambda *a, **kw: calls.append(a[4:7]) or ref(*a, **kw))
    xt = torch.from_numpy(x).requires_grad_()
    out = pm(xt, mc=True, generator=torch.Generator().manual_seed(9))
    cot = np.random.RandomState(5).randn(*out.shape).astype(np.float32)
    out.backward(torch.from_numpy(cot))
    seed = torch.randint(0, 2 ** 63 - 1, (1,), generator=torch.Generator().manual_seed(9),
                         dtype=torch.int64)
    assert len(calls) == 1 and calls[0][0] == p and torch.equal(calls[0][1], seed)
    assert calls[0][2] == 0
    keep = jnp.asarray(dropout.keep_mask_plain((B, H, n, n), p, seed, 0).numpy())

    def module(x_, prm):
        qkv = x_ @ prm["qkv"]["kernel"] + prm["qkv"]["bias"]
        q, k, v = qkv.reshape(B, n, 3, H, C // H).transpose(2, 0, 3, 1, 4)
        _, w = _xla_attention(q, k, v, (C // H) ** -0.5)
        o = jnp.einsum("bhqk,bhkd->bhqd", w * keep / (1.0 - p), v)
        return o.transpose(0, 2, 1, 3).reshape(B, n, C) @ prm["proj"]["kernel"] + \
            prm["proj"]["bias"]

    want_out, vjp = jax.vjp(module, jnp.asarray(x), params)
    assert_close(out, want_out, rtol=1e-4, what="out")
    gx, gp = vjp(jnp.asarray(cot))
    assert_close(xt.grad, gx, rtol=1e-4, what="x")
    for name in ("qkv", "proj"):
        layer = getattr(pm, name)
        assert_close(layer.weight.grad.T, gp[name]["kernel"], rtol=1e-4, what=f"{name} kernel")
        assert_close(layer.bias.grad, gp[name]["bias"], rtol=1e-4, what=f"{name} bias")


def test_data_rank_takes_its_rows_of_the_global_draw(monkeypatch):
    """Under a data mesh's step (``parallel/mesh.py::RowShard``) a rank's
    rows of a training call take their counters of the whole batch's
    weights: rows 2.. of a 4-row batch on their own equal those rows of the
    whole batch's call, the same generator seed."""
    from types import SimpleNamespace

    from dmf_tpu_torch.models import transformer

    x, _, _, pm = _jax_mhsa(0.1)
    x = torch.from_numpy(np.concatenate([x, 0.5 * x[::-1]]))
    with torch.no_grad():
        whole = pm(x, mc=True, generator=torch.Generator().manual_seed(9))
        monkeypatch.setattr(transformer, "active_shard", lambda: SimpleNamespace(start=2))
        part = pm(x[2:], mc=True, generator=torch.Generator().manual_seed(9))
    assert_close(part, whole[2:], rtol=1e-6)
    assert not torch.allclose(part, whole[:2])
