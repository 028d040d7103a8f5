"""Port backbone, adapter, encoder and fusion vs the JAX package, in fp32.

Weights go JAX -> ``ref_ckpt.export_reference_*`` -> ``load_reference_state_dict``
(strict accounting).  The ResNet-50 runs at full width with one block per
stage.  Tolerance: ``RTOL`` from ``test_torch_helpers`` (relative 1e-4
against the tensor's scale).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (BACKBONE_LAYERS, assert_close, jax_encoder,
                                jax_fusion, nchw, nhwc, port_encoder,
                                port_fusion, randomize, resnet_layers, tiny_cfg)

from dmf_tpu.models.backbones import importers
from dmf_tpu.models.backbones.resnet import ResNetFeatures as JaxResNet
from dmf_tpu_torch.models import load_reference_state_dict
from dmf_tpu_torch.models.adapter import BackboneAdapter
from dmf_tpu_torch.models.backbones import ResNetFeatures


@pytest.mark.parametrize("deep", [False, True])  # resnet50 / resnet50d
def test_resnet_features(deep):
    x = np.random.RandomState(0).randn(2, 32, 32, 6).astype(np.float32)
    jm = JaxResNet(in_channels=6, layers=BACKBONE_LAYERS, deep_stem=deep, avg_down=deep)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 1)
    with resnet_layers(BACKBONE_LAYERS):
        sd = importers.export_resnet50(v["params"], v["batch_stats"], deep_stem=deep)
    pm = ResNetFeatures(6, BACKBONE_LAYERS, deep_stem=deep, avg_down=deep)
    load_reference_state_dict(pm, sd)
    refs = jm.apply(v, jnp.asarray(x), train=False)
    outs = pm(nchw(x))
    assert [o.shape[-1] for o in outs] == [8, 4, 4, 4]
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert_close(nhwc(o), r, what=f"C{i + 2}")


def test_adapter_necks():
    """The neck stages (conv3x3+BN+GELU, kernel 2's call sites) and chain concat."""
    from flax import linen as nn

    from dmf_tpu.models.adapter import BackboneAdapter as JaxAdapter
    from dmf_tpu.models.ref_ckpt import _export_adapter_necks, _Exporter, _to_host

    class Stub(nn.Module):  # hands the adapter fixed "backbone features"
        @nn.compact
        def __call__(self, x, train):
            return [x, x[..., :8] * 0.5, x[..., :12] - 0.2]

    x = np.random.RandomState(0).randn(2, 8, 8, 16).astype(np.float32)
    chains = ((0,), (1,), (1, 2))
    jm = JaxAdapter(backbone=Stub(), selected_indices_chains=chains,
                    out_channels=(8, 8, 16))
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 2)
    exp = _Exporter()
    _export_adapter_necks(exp, _to_host(v["params"]), _to_host(v["batch_stats"]))
    pm = BackboneAdapter((16, 8, 12), chains, (8, 8, 16))
    load_reference_state_dict(
        pm, {k[len("backbone_adapter."):]: val for k, val in exp.out.items()})
    xt = nchw(x)
    outs = pm([xt, xt[:, :8] * 0.5, xt[:, :12] - 0.2])
    for o, r in zip(outs, jm.apply(v, jnp.asarray(x), train=False)):
        assert_close(nhwc(o), r)


@pytest.fixture(scope="module")
def encoder_pair():
    cfg = tiny_cfg(dropout=0.0)
    x = np.random.RandomState(4).rand(2, 32, 32, 6).astype(np.float32)
    jm, v = jax_encoder(cfg.dwi_model, 6, x, seed=3)
    pm, report = port_encoder(cfg.dwi_model, 6, v)
    return cfg, x, jm, v, pm, report


def _flat_aux(aux):
    out = {}
    for k, val in aux.items():
        if isinstance(val, (list, tuple)):
            for i, t in enumerate(val):
                out[f"{k}.{i}"] = t
        else:
            out[k] = val
    return out


@pytest.mark.parametrize("mc", [False, True])
def test_encoder(encoder_pair, mc):
    """Logits, mask and every aux leaf, eval and MC (dropout 0)."""
    cfg, x, jm, v, pm, _ = encoder_pair
    logits, aux, mask = jm.apply(v, jnp.asarray(x), train=False, mc=mc)
    g = torch.Generator().manual_seed(0)
    plog, paux, pmask = pm(nchw(x), mc=mc, generator=g)
    assert_close(plog, logits, what="logits")
    assert_close(nhwc(pmask), mask, what="mask")
    ja, pa = _flat_aux(aux), _flat_aux(paux)
    assert set(ja) == set(pa)
    for k in ja:
        if ja[k] is None:
            assert pa[k] is None, k
        else:
            assert_close(nhwc(pa[k]), ja[k], what=k)


@pytest.mark.parametrize("use_backbone,stage", [(False, "f1"), (True, "f3")])
def test_encoder_variants(use_backbone, stage):
    """Off the default path: no backbone (block1 on the raw input) and the
    other mask stages; MC with dropout 0."""
    import dataclasses

    cfg = tiny_cfg(dropout=0.0, use_backbone=use_backbone)
    mc = dataclasses.replace(cfg.dwi_model, mask=dataclasses.replace(
        cfg.dwi_model.mask, mask_stage=stage))
    x = np.random.RandomState(5).rand(2, 32, 32, 6).astype(np.float32)
    jm, v = jax_encoder(mc, 6, x, seed=6)
    pm, _ = port_encoder(mc, 6, v)
    logits, aux, mask = jm.apply(v, jnp.asarray(x), train=False, mc=True)
    plog, paux, pmask = pm(nchw(x), mc=True, generator=torch.Generator().manual_seed(0))
    assert_close(plog, logits, what="logits")
    assert_close(nhwc(pmask), mask, what="mask")
    for i, f in enumerate(aux["raw_feats"]):
        assert_close(nhwc(paux["raw_feats"][i]), f, what=f"raw_feats.{i}")


def test_encoder_prefix_split_and_lean(encoder_pair):
    cfg, x, jm, v, pm, _ = encoder_pair
    pre = pm(nchw(x), prefix_only=True)
    jpre = jm.apply(v, jnp.asarray(x), train=False, prefix_only=True)
    for a, b in zip(pre[2], jpre[2]):
        assert_close(nhwc(a), b)
    full = pm(nchw(x))
    lean = pm(None, prefix=pre, lean=True)
    assert torch.allclose(lean[0], full[0], rtol=1e-5, atol=1e-6)
    assert torch.allclose(lean[2], full[2], rtol=1e-5, atol=1e-6)
    assert lean[1]["proj_pairs"] is None and lean[1]["recon_feats"] == [None, None]


def test_fusion_model(encoder_pair):
    cfg, x, jm, v, pm, _ = encoder_pair
    _, aux_j, mask_j = jm.apply(v, jnp.asarray(x), train=False)
    feats = aux_j["raw_feats"]
    other = [f * 0.5 + 0.1 for f in feats]
    fm, fv = jax_fusion(cfg, feats, other, mask_j, mask_j * 0.3)
    logits, fmask, faux = fm.apply(fv, feats, other, mask_j, mask_j * 0.3, train=False)
    pf, report = port_fusion(cfg, fv, pm.feature_size)
    tfeats = [nchw(np.asarray(f)) for f in feats]
    tother = [nchw(np.asarray(f)) for f in other]
    tm = nchw(np.asarray(mask_j))
    plog, pmask, paux = pf(tfeats, tother, tm, tm * 0.3)
    assert_close(plog, logits, what="logits")
    assert_close(nhwc(pmask), fmask, what="mask")
    for k, val in faux.items():
        p = paux[k]
        assert_close(nhwc(p) if p.dim() == 4 else p, val, what=k)
    lean_logits, _, _ = pf(tfeats, tother, tm, tm * 0.3, lean=True)
    assert torch.allclose(lean_logits, plog)
    # the reference fusion carries all four mask-head chains
    assert any(k.startswith("mask_head.down_") for k in report["dropped"])


def test_strict_load_accounting(encoder_pair):
    """Exactly the documented reference-only keys are dropped; a missing or
    an unknown key is an error; ``model.``/``_orig_mod.`` wrapping is accepted."""
    cfg, x, jm, v, pm, report = encoder_pair
    dropped = report["dropped"]
    assert any(k.startswith("backbone_adapter.backbone.") for k in dropped)
    assert any(k.startswith("mask_head.down_") for k in dropped)
    assert any(k.startswith("f2_to_f3.") for k in dropped)  # mask stage is f2
    assert all(k.startswith(("backbone_adapter.backbone.", "mask_head.down_",
                             "f2_to_f3.")) for k in dropped)
    assert "backbone.conv1.weight" in report["loaded"]
    assert set(report["loaded"]) == set(pm.state_dict())

    from dmf_tpu.models.ref_ckpt import export_reference_encoder
    with resnet_layers(BACKBONE_LAYERS):
        sd = export_reference_encoder(v)
    lightning = {"model." + k: val for k, val in sd.items()}
    assert load_reference_state_dict(pm, lightning)["dropped"] == dropped
    missing = dict(sd)
    del missing["block1.se.fc.1.weight"]
    with pytest.raises(KeyError, match="missing"):
        load_reference_state_dict(pm, missing)
    extra = dict(sd, **{"block1.extra.weight": np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(pm, extra)
    bad = dict(sd, **{"classification_head.fc.bias": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_reference_state_dict(pm, bad)


def test_import_is_jax_free():
    code = ("import sys, dmf_tpu_torch, dmf_tpu_torch.models, dmf_tpu_torch.evals.predict, "
            "dmf_tpu_torch.data.preprocess, dmf_tpu_torch.ops.epilogue_triton, "
            "dmf_tpu_torch.ops.conv3x3; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'triton'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
