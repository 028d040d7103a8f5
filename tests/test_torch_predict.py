"""The port's serving slice vs the JAX package, in fp32: preprocessing and the
whole fusion predictor (two backboned encoders + fusion) in every mode.

MC modes run with dropout 0, where both packages are deterministic (their
mask streams cannot match bit for bit); the port's own MC statistics are
checked with dropout on.  Tolerance: ``RTOL`` from ``test_torch_helpers``
(relative 1e-4 against the tensor's scale) unless a test states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_close, hybrid_cfg, jax_encoder, jax_fusion,
                                port_config, port_encoder, port_fusion, tiny_cfg,
                                volumes)

from dmf_tpu.data import preprocess as jpre
from dmf_tpu.evals.predict import make_fusion_predictor as jax_predictor
from dmf_tpu_torch.data import preprocess as ppre
from dmf_tpu_torch.evals.predict import make_fusion_predictor, tta_views


class TestPreprocess:
    @pytest.mark.parametrize("skip_last,zero_last", [(True, True), (True, False),
                                                     (False, False)])
    def test_dwi_normalize(self, skip_last, zero_last):
        x = np.random.RandomState(0).rand(2, 16, 16, 13).astype(np.float32) * 50
        ref = jpre.dwi_normalize(jnp.asarray(x), skip_last=skip_last, zero_last=zero_last)
        out = ppre.dwi_normalize(torch.from_numpy(x), skip_last=skip_last,
                                 zero_last=zero_last)
        assert_close(out, ref)

    @pytest.mark.parametrize("batched_map", [False, True])
    def test_append_adc(self, batched_map):
        rng = np.random.RandomState(1)
        img = rng.rand(2, 32, 32, 13).astype(np.float32)
        adc = rng.rand(*((2,) if batched_map else ()), 16, 16, 1).astype(np.float32)
        ref = jpre.append_adc(jnp.asarray(img), jnp.asarray(adc))
        out = ppre.append_adc(torch.from_numpy(img), torch.from_numpy(adc))
        assert_close(out, ref)

    def test_histogram_percentiles(self):
        flat = np.random.RandomState(2).gamma(2.0, 1.0, (3, 1024, 6)).astype(np.float32)
        q = jnp.asarray(jpre.DEFAULT_LANDMARKS, jnp.float32)
        ref = jax.vmap(lambda f: jpre._histogram_percentiles(f, q))(jnp.asarray(flat))
        out = ppre._histogram_percentiles(torch.from_numpy(flat), torch.from_numpy(np.array(q)))
        assert_close(out, ref)

    @pytest.mark.parametrize("stride", [1, 3])
    def test_nyul_transform_fast(self, stride):
        img = np.random.RandomState(3).gamma(2.0, 1.0, (2, 32, 32, 6)).astype(np.float32)
        lm = np.asarray(jpre.DEFAULT_LANDMARKS, np.float32)
        scale = np.linspace(0.0, 1.0, len(lm)).astype(np.float32)
        chan = np.tile(scale[None], (6, 1))
        ref = jpre.nyul_transform_fast(jnp.asarray(img), jnp.asarray(chan), jnp.asarray(lm),
                                       jnp.asarray(scale), percentile_stride=stride)
        out = ppre.nyul_transform_fast(torch.from_numpy(img), torch.from_numpy(lm),
                                       torch.from_numpy(scale), percentile_stride=stride)
        assert_close(out, ref)
        single = ppre.nyul_transform_fast(torch.from_numpy(img[0]), torch.from_numpy(lm),
                                          torch.from_numpy(scale), percentile_stride=stride)
        assert torch.allclose(single, out[0])


def test_tta_views():
    x = torch.arange(2 * 4 * 4 * 1.0).reshape(2, 4, 4, 1)
    v = tta_views(x)
    assert torch.equal(v[2:4], x.flip(2)) and torch.equal(v[4:6], x.flip(1))
    assert torch.equal(v[6:], x.flip(1, 2)) and torch.equal(v[:2], x)


@pytest.fixture(scope="module")
def slice_pair():
    """Both packages' encoders + fusion on the same random weights."""
    cfg = tiny_cfg(dropout=0.0, mc_passes=3)
    xd, xc = volumes(0)
    jd, vd = jax_encoder(cfg.dwi_model, 14, xd, seed=1)
    jc, vc = jax_encoder(cfg.dce_model, 6, xc, seed=2)
    _, ad, md = jd.apply(vd, jnp.asarray(xd), train=False)
    _, ac, mc_ = jc.apply(vc, jnp.asarray(xc), train=False)
    jf, vf = jax_fusion(cfg, ad["raw_feats"], ac["raw_feats"], md, mc_, seed=3)
    pd, _ = port_encoder(cfg.dwi_model, 14, vd)
    pc, _ = port_encoder(cfg.dce_model, 6, vc)
    pf, _ = port_fusion(cfg, vf, pd.feature_size)
    return cfg, (xd, xc), (jd, jc, jf), (vd, vc, vf), (pd, pc, pf)


@pytest.mark.parametrize("mode", ["normal", "tta", "mc", "tta_mc"])
def test_slice_matches_jax_predictor(slice_pair, mode):
    cfg, (xd, xc), jmods, jvars, pmods = slice_pair
    jpred = jax_predictor(cfg, *jmods, mode=mode)
    jmean, jstd, jaux = jpred(*jvars, jnp.asarray(xd), jnp.asarray(xc),
                              jax.random.PRNGKey(0))
    ppred = make_fusion_predictor(port_config(cfg), *pmods, mode=mode)
    mean, std, aux = ppred(torch.from_numpy(xd), torch.from_numpy(xc),
                           torch.Generator().manual_seed(0))
    assert_close(mean, jmean, what="mean")
    # std of near-identical probabilities: absolute agreement at 1e-5
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=0, atol=1e-5)
    assert set(aux) == set(jaux)
    for k, v in jaux.items():
        assert_close(aux[k], v, what=k)


def test_mc_chunking_is_the_same_ensemble(slice_pair):
    """With dropout 0 every pass is identical, so any chunking must give the
    same mean; shapes and pass bookkeeping are exercised for chunk 1 and 2."""
    cfg, (xd, xc), _, _, pmods = slice_pair
    outs = [make_fusion_predictor(port_config(cfg), *pmods, mode="tta_mc", mc_passes=4,
                                  mc_chunk=c)(
        torch.from_numpy(xd), torch.from_numpy(xc), torch.Generator().manual_seed(0))
        for c in (None, 1, 2)]
    for m, s, _ in outs[1:]:
        assert torch.allclose(m, outs[0][0], rtol=1e-5, atol=1e-6)


def test_mc_dropout_ensemble_statistics():
    """Dropout on: the ensemble has spread, the same seed repeats it exactly,
    another seed changes it, and probabilities stay normalized."""
    from dmf_tpu_torch.models import build_fusion_models

    cfg = port_config(tiny_cfg(dropout=0.3, mc_passes=4))
    g = torch.Generator().manual_seed(0)
    models = build_fusion_models(cfg, "cpu", torch.float32, g, backbone_layers=(1, 1, 1, 1))
    xd, xc = (torch.from_numpy(a) for a in volumes(1))
    pred = make_fusion_predictor(cfg, *models, mode="tta_mc", mc_chunk=2)
    m1, s1, _ = pred(xd, xc, torch.Generator().manual_seed(5))
    m2, s2, _ = pred(xd, xc, torch.Generator().manual_seed(5))
    m3, _, _ = pred(xd, xc, torch.Generator().manual_seed(6))
    assert torch.equal(m1, m2) and torch.equal(s1, s2)
    assert not torch.equal(m1, m3)
    assert float(s1.mean()) > 1e-6
    assert torch.allclose(m1.sum(-1), torch.ones(2), atol=1e-5)
    with pytest.raises(ValueError, match="generator"):
        pred(xd, xc)


@pytest.fixture(scope="module")
def hybrid_pair():
    """``hybrid-nb`` encoders + fusion of both packages on the same weights."""
    cfg = hybrid_cfg()
    xd, xc = volumes(7)
    jd, vd = jax_encoder(cfg.dwi_model, 14, xd, seed=11)
    jc, vc = jax_encoder(cfg.dce_model, 6, xc, seed=12)
    _, ad, md = jd.apply(vd, jnp.asarray(xd), train=False)
    _, ac, mc_ = jc.apply(vc, jnp.asarray(xc), train=False)
    jf, vf = jax_fusion(cfg, ad["raw_feats"], ac["raw_feats"], md, mc_, seed=13)
    pd, _ = port_encoder(cfg.dwi_model, 14, vd)
    pc, _ = port_encoder(cfg.dce_model, 6, vc)
    pf, _ = port_fusion(cfg, vf, pd.feature_size)
    return cfg, (xd, xc), (jd, jc, jf), (vd, vc, vf), (pd, pc, pf)


@pytest.mark.parametrize("mode", ["normal", "tta"])
def test_hybrid_nb_matches_jax_predictor(hybrid_pair, mode):
    """The hybrid-transformer (no backbone) fusion predictor, the slice's
    serving modes, against the JAX package in fp32."""
    cfg, (xd, xc), jmods, jvars, pmods = hybrid_pair
    jmean, jstd, jaux = jax_predictor(cfg, *jmods, mode=mode)(
        *jvars, jnp.asarray(xd), jnp.asarray(xc), jax.random.PRNGKey(0))
    mean, std, aux = make_fusion_predictor(port_config(cfg), *pmods, mode=mode)(
        torch.from_numpy(xd), torch.from_numpy(xc))
    assert_close(mean, jmean, what="mean")
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=0, atol=1e-5)
    assert set(aux) == set(jaux)
    for k, v in jaux.items():
        assert_close(aux[k], v, what=k)


@pytest.mark.parametrize("mode", ["mc", "tta_mc"])
def test_hybrid_nb_mc_modes_at_toy_size(hybrid_pair, mode):
    """MC modes on the hybrid encoders take the attention-weights route with
    the transformer's fixed dropout 0.1, whose masks cannot match the JAX
    stream: hold the ensemble by its invariants (normalized, finite, spread,
    the same generator seed repeats it)."""
    cfg, (xd, xc), _, _, pmods = hybrid_pair
    pred = make_fusion_predictor(port_config(cfg), *pmods, mode=mode)
    xd, xc = torch.from_numpy(xd), torch.from_numpy(xc)
    mean, std, _ = pred(xd, xc, torch.Generator().manual_seed(3))
    again, _, _ = pred(xd, xc, torch.Generator().manual_seed(3))
    assert mean.shape == (2, cfg.class_num) and torch.isfinite(std).all()
    assert torch.allclose(mean.sum(-1), torch.ones(2), atol=1e-5)
    assert float(std.mean()) > 0.0 and torch.equal(mean, again)
