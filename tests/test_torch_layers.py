"""Port layers vs ``dmf_tpu.models.layers``, one module at a time, in fp32.

Each JAX module gets random variables; ``ref_ckpt``'s exporter writes them in
the reference torch layout and the port module loads them strictly, so the
test also pins the port's parameter names.  Tolerance: ``RTOL`` from
``test_torch_helpers`` (relative 1e-4 against the tensor's scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from test_torch_helpers import assert_close, nchw, nhwc, randomize

from dmf_tpu.models import layers as jl
from dmf_tpu.models.ref_ckpt import _Exporter, _to_host
from dmf_tpu_torch.models import layers as pl
from dmf_tpu_torch.models.weights import load_reference_state_dict


def _init(module, *args, seed=0, **kw):
    template = module.init({"params": jax.random.PRNGKey(0),
                            "dropout": jax.random.PRNGKey(1)}, *args, **kw)
    return randomize(template, seed)


def _transplant(port_module, variables, name, export):
    """Export JAX variables under ``name`` and load them into the port module."""
    exp = _Exporter()
    export(exp, _to_host(variables["params"]),
           _to_host(variables.get("batch_stats", {})), name)
    holder = nn.Module()
    holder.add_module(name, port_module)
    load_reference_state_dict(holder, exp.out)
    return port_module


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_se_block():
    x = _x(2, 6, 6, 8)
    jm = jl.SEBlock(8)
    v = _init(jm, jnp.asarray(x))
    ref_out, ref_w = jm.apply(v, jnp.asarray(x))
    pm = _transplant(pl.SEBlock(8), v, "m", lambda e, p, s, k: e.se(p, k))
    out, w = pm(nchw(x))
    assert_close(nhwc(out), ref_out)
    assert_close(nhwc(w), ref_w)


def test_mask_guided_spatial_attention():
    img, mask = _x(2, 8, 8, 16), _x(2, 32, 32, 1, seed=1)
    jm = jl.MaskGuidedSpatialAttention()
    v = _init(jm, jnp.asarray(img), jnp.asarray(mask))
    ref_out, ref_a = jm.apply(v, jnp.asarray(img), jnp.asarray(mask))
    pm = _transplant(pl.MaskGuidedSpatialAttention(), v, "m",
                     lambda e, p, s, k: e.spatial_attention(p, k))
    out, a = pm(nchw(img), nchw(mask))
    assert_close(nhwc(out), ref_out)
    assert_close(nhwc(a), ref_a)


def test_recon_head():
    x = _x(2, 8, 8, 8)
    jm = jl.ReconHead(8, 1)
    v = _init(jm, jnp.asarray(x), train=False)
    pm = _transplant(pl.ReconHead(8, 1), v, "m",
                     lambda e, p, s, k: e.recon_head(p, s, k))
    assert_close(nhwc(pm(nchw(x))), jm.apply(v, jnp.asarray(x), train=False))


@pytest.mark.parametrize("size", [64, 16, 32])  # down chain, resize, identity
def test_mask_head_resize(size):
    x = _x(2, size, size, 16)
    jm = jl.MaskHeadResize(out_size=32)
    v = _init(jm, jnp.asarray(x))
    pm = _transplant(pl.MaskHeadResize(16, size, out_size=32), v, "mask_head",
                     lambda e, p, s, k: e.mask_head(p, k))
    assert (pm.chain_name is not None) == (size == 64)
    assert_close(nhwc(pm(nchw(x))), jm.apply(v, jnp.asarray(x)))


RES_CASES = {
    "skip_se_recon": dict(in_ch=8, out_ch=16, downsample=True, use_se=True, recon_ch=1),
    "identity_no_se": dict(in_ch=16, out_ch=16, use_se=False, recon_ch=0),
    "repeats": dict(in_ch=8, out_ch=16, downsample=True, use_se=True, recon_ch=1,
                    num_repeats=2),
}


@pytest.mark.parametrize("case", sorted(RES_CASES))
@pytest.mark.parametrize("mc", [False, True])
def test_res_lite_block(case, mc):
    """Eval and MC (BN frozen, dropout 0 so both packages are deterministic)."""
    kw = RES_CASES[case]
    x = _x(2, 16, 16, kw["in_ch"])
    jm = jl.ResLiteBlock(dropout=0.0, **kw)
    v = _init(jm, jnp.asarray(x), train=False)
    ref, ref_r = jm.apply(v, jnp.asarray(x), train=False, mc=mc)
    pm = _transplant(pl.ResLiteBlock(dropout=0.0, **kw), v, "m",
                     lambda e, p, s, k: e.res_block(p, s, k))
    out, r = pm(nchw(x), mc=mc, generator=torch.Generator().manual_seed(0))
    assert_close(nhwc(out), ref)
    assert (r is None) == (ref_r is None)
    if r is not None:
        assert_close(nhwc(r), ref_r)
    assert pm(nchw(x), recon=False)[1] is None


def test_res_lite_block_mc_dropout_is_seeded():
    """With dropout on, MC passes differ between seeds and repeat per seed."""
    pm = pl.ResLiteBlock(8, 16, downsample=True, use_se=True, dropout=0.3)
    x = nchw(_x(2, 16, 16, 8))
    runs = [pm(x, mc=True, generator=torch.Generator().manual_seed(s))[0]
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2])
    assert torch.equal(pm(x)[0], pm(x)[0])


def test_projector():
    x = _x(2, 8, 8, 8)
    jm = jl.Projector(8)
    v = _init(jm, jnp.asarray(x), train=False)
    pm = _transplant(pl.Projector(8, 8), v, "m", lambda e, p, s, k: e.projector(p, s, k))
    assert_close(nhwc(pm(nchw(x))), jm.apply(v, jnp.asarray(x), train=False))


def test_classification_head():
    x = _x(2, 4, 4, 32)
    jm = jl.ClassificationHead(4)
    v = _init(jm, jnp.asarray(x))
    pm = _transplant(pl.ClassificationHead(32, 4), v, "m",
                     lambda e, p, s, k: e.dense(p["Dense_0"], k + ".fc"))
    assert_close(pm(nchw(x)), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("downsample", [True, False])
def test_feature_down_align(downsample):
    x = _x(2, 8, 8, 8)
    jm = jl.FeatureDownAlign(8, 16, downsample=downsample)
    v = _init(jm, jnp.asarray(x), train=False)
    pm = _transplant(pl.FeatureDownAlign(8, 16, downsample), v, "m",
                     lambda e, p, s, k: e.down_align(p, s, k))
    assert_close(nhwc(pm(nchw(x))), jm.apply(v, jnp.asarray(x), train=False))


def test_fusion_reduce():
    x = _x(2, 4, 4, 32)
    jm = jl.FusionReduce(16)
    v = _init(jm, jnp.asarray(x), train=False)

    def export(e, p, s, k):
        e.conv(p["Conv_0"], k + ".reduce.0")
        e.bn_wrapper(p["BatchNorm_0"], s["BatchNorm_0"], k + ".reduce.1")

    pm = _transplant(pl.FusionReduce(32, 16), v, "m", export)
    assert_close(nhwc(pm(nchw(x))), jm.apply(v, jnp.asarray(x), train=False))


def test_batchnorm_ignores_train_flag():
    bn = pl.BatchNorm2d(4)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    x = torch.randn(2, 4, 3, 3)
    bn.train()
    a = bn(x)
    bn.eval()
    assert torch.equal(a, bn(x))
