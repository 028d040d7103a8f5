"""The port's hybrid CNN->Transformer modules vs the JAX package, in fp32.

Weights go JAX variables -> ``ref_ckpt`` (``transformer_stage`` /
``export_reference_encoder``) -> the port's strict loader.  Tolerance:
``RTOL`` from ``test_torch_helpers`` (relative 1e-4 against the tensor's
scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_close, hybrid_cfg, jax_encoder, nchw, nhwc,
                                port_encoder, randomize)

from dmf_tpu.models.ref_ckpt import _Exporter, _to_host
from dmf_tpu.models.transformer import MultiHeadSelfAttention as JaxMHSA
from dmf_tpu.models.transformer import TransformerStage as JaxStage
from dmf_tpu.ops.attention import _xla_attention
from dmf_tpu_torch.models import load_reference_state_dict
from dmf_tpu_torch.models.transformer import MultiHeadSelfAttention, TransformerStage

EMBED, HEADS, DEPTH = 32, 2, 2


@pytest.fixture(scope="module")
def stage_pair():
    x = np.random.RandomState(0).randn(2, 16, 16, 8).astype(np.float32)
    jm = JaxStage(embed_dim=EMBED, depth=DEPTH, heads=HEADS, patch_size=2)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 1)
    exp = _Exporter()
    exp.transformer_stage(_to_host(v["params"]), "stage")
    pm = TransformerStage(8, EMBED, depth=DEPTH, heads=HEADS, patch_size=2)
    report = load_reference_state_dict(
        pm, {k[len("stage."):]: val for k, val in exp.out.items()})
    return x, jm, v, pm, report


def test_transformer_stage(stage_pair):
    x, jm, v, pm, report = stage_pair
    ref = jm.apply(v, jnp.asarray(x), train=False)
    out = pm(nchw(x))
    assert out.shape == (2, EMBED, 8, 8)
    assert_close(nhwc(out), ref)
    assert report["dropped"] == []
    assert "transformer.layers.1.attn.qkv.weight" in report["loaded"]


def test_stage_keeps_the_token_order(stage_pair):
    """Tokens are the map's pixels in row-major (h, w) order, as JAX flattens
    NHWC: a channels_last input gives the same result as a contiguous one."""
    x, _, _, pm, _ = stage_pair
    a = pm(nchw(x))
    b = pm(nchw(x).contiguous(memory_format=torch.channels_last))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mc_attention_with_injected_mask():
    """``mc=True``: dropout on the materialized weights, then the value
    product.  The port's mask is reproduced from a twin generator and
    injected into the JAX XLA route's weights (x mask / (1 - p)) here."""
    p = 0.1
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, EMBED).astype(np.float32)
    jm = JaxMHSA(EMBED, HEADS, attn_drop=p, proj_drop=0.0)
    params = randomize(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                               train=False), 4)["params"]
    pm = MultiHeadSelfAttention(EMBED, HEADS, attn_drop=p, proj_drop=0.0)
    exp = _Exporter()
    exp.dense(_to_host(params)["qkv"], "qkv")
    exp.dense(_to_host(params)["proj"], "proj")
    load_reference_state_dict(pm, exp.out)

    out = pm(torch.from_numpy(x), mc=True, generator=torch.Generator().manual_seed(9))
    keep = torch.empty(2, HEADS, 24, 24).uniform_(
        generator=torch.Generator().manual_seed(9)) < (1.0 - p)
    assert 0.0 < keep.float().mean() < 1.0

    B, N, C, D = 2, 24, EMBED, EMBED // HEADS
    qkv = jnp.asarray(x) @ params["qkv"]["kernel"] + params["qkv"]["bias"]
    q, k, v = qkv.reshape(B, N, 3, HEADS, D).transpose(2, 0, 3, 1, 4)
    _, w = _xla_attention(q, k, v, D ** -0.5)
    w = w * jnp.asarray(keep.numpy()) / (1.0 - p)
    ref = jnp.einsum("bhqk,bhkd->bhqd", w, v).transpose(0, 2, 1, 3).reshape(B, N, C)
    ref = ref @ params["proj"]["kernel"] + params["proj"]["bias"]
    assert_close(out, ref)
    # and with dropout off the module is the JAX module
    assert_close(pm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x),
                                                   train=False))


@pytest.mark.parametrize("use_backbone", [False, True])
def test_hybrid_encoder(use_backbone):
    """The hybrid encoder without (``hybrid-nb``) and with a backbone: logits,
    mask and features; the strict loader takes exactly what the exporter
    emits (no f3 blend with a backbone, encoder.py:177-188)."""
    cfg = hybrid_cfg(use_backbone=use_backbone)
    x = np.random.RandomState(5).rand(2, 32, 32, 6).astype(np.float32)
    jm, v = jax_encoder(cfg.dwi_model, 6, x, seed=6)
    pm, report = port_encoder(cfg.dwi_model, 6, v)
    assert pm.block3 is None
    assert ("f3_weight" in report["loaded"]) == (not use_backbone)
    assert any(k.startswith("f2_to_f3.") for k in report["dropped"])
    logits, aux, mask = jm.apply(v, jnp.asarray(x), train=False)
    plog, paux, pmask = pm(nchw(x))
    assert_close(plog, logits, what="logits")
    assert_close(nhwc(pmask), mask, what="mask")
    assert pm.feature_size == aux["raw_feats"][2].shape[1]  # f2's side / patch
    for i, f in enumerate(aux["raw_feats"]):
        assert_close(nhwc(paux["raw_feats"][i]), f, what=f"raw_feats.{i}")
    for i, f in enumerate(aux["proj_pairs"]):
        assert_close(nhwc(paux["proj_pairs"][i]), f, what=f"proj_pairs.{i}")


def test_hybrid_rejects_mask_stage_f3():
    import dataclasses

    from test_torch_helpers import port_config

    from dmf_tpu_torch.models import Encoder

    mc = hybrid_cfg().dwi_model
    mc = dataclasses.replace(mc, mask=dataclasses.replace(mc.mask, mask_stage="f3"))
    with pytest.raises(ValueError, match="f3"):
        Encoder("dwi", port_config(mc), 6, 4)


def test_init_weights_sets_layerscale():
    from dmf_tpu_torch.models import init_weights

    pm = TransformerStage(8, EMBED, depth=1, heads=HEADS)
    with torch.no_grad():
        pm.transformer.layers[0].gamma1.zero_()
    init_weights(pm, torch.Generator().manual_seed(0))
    blk = pm.transformer.layers[0]
    assert torch.equal(blk.gamma1, torch.full((EMBED,), 0.1))
    assert torch.equal(blk.norm1.weight, torch.ones(EMBED))
