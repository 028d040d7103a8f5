"""The port's int8 post-training quantization (``dmf_tpu_torch/ops/quant.py``)
against the JAX package's (``dmf_tpu/ops/quant.py``), on the CPU.

Toy geometry of ``test_torch_helpers`` (32^2, channels (8, 16, 32), the
(1, 1, 1, 1) ResNet-50 at full channel width, fusion channels 16); both
packages get the same weights through the reference exporters.  JAX's
QuantSet entries are matched to the port's module names through the weight
transplant: the JAX kernel (HWIO) and the port's conv weight (OIHW) hold the
same numbers.

* weights: ``quantize_kernel_per_channel`` and ``build_quant_set`` bit-equal
  (int8 weights and scales, the selection at three thresholds);
* one conv at a time on JAX's own input tensor: the scale, the int8 input,
  the int32 accumulators and the outputs bit-equal to ``_quant_conv_call``
  run op by op (the code as written); against the compiled program, as JAX
  serves it, static outputs within 1 ulp (XLA contracts the dequantize's
  product and bias add into an FMA: 1 fp32 ulp of the product, bf16
  outputs 1 bf16 ulp) and the dynamic scale within 1 ulp (XLA takes
  ``/ 127`` as ``* fp32(1 / 127)``; the port divides, as the source does);
  the static and dynamic quantize at inputs on rounding ties, where the
  reciprocal and the division round apart, bit-equal to JAX's;
* calibration (``calibration_mc=False``): static ``x_scale`` within rel
  1e-5 at ``percentile`` 100 and 99.9;
* whole models, ``tta`` with dropout off: the port's int8 predictor against
  JAX's on the same QuantSets, the argmax equal and the probabilities within
  ``PROB_TOL``, which is held below a tenth of the port's own int8-vs-fp32
  distance in the same test;
* MC and the hybrid, the ports of ``tests/test_quant.py:186-363``; the
  entry points (``test_fusion_model(int8=True)``, the serving artifact) and
  ``torch.library.opcheck`` on the three operators.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_helpers import fusion_stack, port_config, tiny_cfg, volumes

from dmf_tpu.evals.predict import make_fusion_predictor as jax_predictor
from dmf_tpu.ops import quant as jq
from dmf_tpu_torch.evals.predict import make_fusion_predictor
from dmf_tpu_torch.ops import library, quant
from dmf_tpu_torch.serving import (export_serving, load_serving, make_serving_fn,
                                   serving_variables)

# the port's int8 probabilities against JAX's on the same QuantSets, in
# ``tta`` (a rounding flip at a quantization boundary is allowed; measured
# 1.5e-8 at toy size); the test holds it below a tenth of the port's own
# int8-vs-fp32 distance there (measured 3.2e-5: the toy's random weights
# leave the probabilities near uniform)
PROB_TOL = 2e-6
LOW = dict(min_fan_in=64, min_out=8)  # the toy necks and ResLite convs too


def _conv_kernels(params):
    """JAX ``{"/path": HWIO kernel}`` of every 4-D conv kernel."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[-1] == "kernel" and np.ndim(leaf) == 4:
            out["/" + "/".join(str(k) for k in keys[:-1])] = np.asarray(leaf)
    return out


def name_map(params, model):
    """JAX module path -> the port's module name, by equal weights."""
    port = {np.ascontiguousarray(m.weight.detach().numpy()).tobytes(): name
            for name, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)}
    out = {}
    for path, k in _conv_kernels(params).items():
        key = np.ascontiguousarray(k.transpose(3, 2, 0, 1)).tobytes()
        if key in port:
            out[path] = port[key]
    return out


@pytest.fixture(scope="module")
def stack():
    """Backboned encoders and the fusion head of both packages on the same
    weights, dropout off; the port's config; the name maps."""
    cfg = tiny_cfg(dropout=0.0, use_backbone=True, mc_passes=3)
    xd, xc = volumes(0)
    jmods, jvars, pmods = fusion_stack(cfg, xd, xc)
    maps = [name_map(v["params"], m) for v, m in zip(jvars, pmods)]
    return cfg, port_config(cfg), jmods, jvars, pmods, maps, (xd, xc)


# ------------------------------------------------------------------ weights
def test_quantize_kernel_per_channel_bit_equal():
    rng = np.random.RandomState(0)
    k = rng.randn(3, 3, 16, 8).astype(np.float32)  # HWIO
    # exact .5 ties: channel 0 with amax 127 (scale 1), values at n + 1/2
    k[..., 0] = rng.randint(-120, 120, k.shape[:3]) + 0.5
    k[0, 0, 0, 0] = 127.0
    k[..., 1] *= 1e-14  # below the 1e-12 amax floor
    jqk, jscale = jq.quantize_kernel_per_channel(k)
    q, scale = quant.quantize_kernel_per_channel(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    assert q.dtype == torch.int8 and q.shape == (8, 3, 3, 16) and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqk).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert (np.abs(q.numpy()) <= 127).all()


@pytest.mark.parametrize("min_fan_in,min_out", [(256, 32), (64, 8), (1000, 64)])
def test_build_quant_set_selects_and_quantizes_as_jax(stack, min_fan_in, min_out):
    _, _, _, jvars, pmods, maps, _ = stack
    for v, m, names in zip(jvars, pmods, maps):
        jset = jq.build_quant_set(v["params"], min_fan_in=min_fan_in, min_out=min_out)
        pset = quant.build_quant_set(m, min_fan_in=min_fan_in, min_out=min_out)
        assert set(jset) <= set(names), "a JAX conv without a port twin"
        assert {names[k] for k in jset} == set(pset)
        for path, e in jset.items():
            np.testing.assert_array_equal(pset[names[path]]["kernel_q"].numpy(),
                                          np.asarray(e["kernel_q"]).transpose(3, 0, 1, 2))
            np.testing.assert_array_equal(pset[names[path]]["scale"].numpy(),
                                          np.asarray(e["scale"]))
    assert quant.build_quant_set(pmods[0]), "the backbone's convs must be quantized"


def _jax_leaf(params, path, leaf):
    node = params
    for k in path.strip("/").split("/"):
        node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
    return node.get(leaf)


def test_bf16_models_take_the_quant_sets_of_their_fp32_weights(stack):
    """Models served in bf16 are quantized from their fp32 weights, as JAX
    quantizes its fp32 params whatever the compute dtype: the QuantSets
    (int8 weights, scales, and the biases in fp32) bit-equal to JAX's, the
    quantized copies of the bf16 models holding them in fp32, equal to an
    fp32 quantized copy cast after; a bf16 weight is refused."""
    cfg, pcfg, _, jvars, pmods, maps, (xd, xc) = stack
    bf16 = [copy.deepcopy(m).to(torch.bfloat16) for m in pmods]
    with pytest.raises(ValueError, match="fp32 model"):
        quant.build_quant_set(bf16[0], **LOW)
    _, psets = quant.make_quantized_fusion_apply(*bf16, weights=pmods, **LOW)
    n_bias = 0
    for key, v, names in zip(("dwi", "dce", "fusion"), jvars, maps):
        jset = jq.build_quant_set(v["params"], **LOW)
        assert {names[k] for k in jset} == set(psets[key])
        for path, e in jset.items():
            got = psets[key][names[path]]
            np.testing.assert_array_equal(got["kernel_q"].numpy(),
                                          np.asarray(e["kernel_q"]).transpose(3, 0, 1, 2))
            np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(e["scale"]))
            jb = _jax_leaf(v["params"], path, "bias")
            assert ("bias" in got) == (jb is not None), path
            if jb is not None:
                n_bias += 1
                assert got["bias"].dtype == torch.float32
                np.testing.assert_array_equal(got["bias"].numpy(), np.asarray(jb))
    assert n_bias, "no quantized conv with a bias"
    for key, m32, m16 in zip(("dwi", "dce", "fusion"), pmods, bf16):
        served = quant.quantized_copy(m16, psets[key])
        cast = quant.quantized_copy(m32, psets[key]).to(torch.bfloat16)
        a, b = served.state_dict(), cast.state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        for name, e in psets[key].items():
            q = served.get_submodule(name)
            assert q.w_scale.dtype == torch.float32 and torch.equal(q.w_scale, e["scale"])
            if "bias" in e:
                assert q.bias.dtype == torch.float32 and torch.equal(q.bias, e["bias"])
    fwd = quant.make_quantized_fusion_fwd(*bf16, psets)
    mean, _, _ = make_fusion_predictor(pcfg, *bf16, mode="tta", fwd_override=fwd)(
        torch.from_numpy(xd), torch.from_numpy(xc))
    assert torch.isfinite(mean).all()


def test_plain_versions_refuse_other_scales():
    """The kernels take fp32 scales only; so do the plain versions, so that
    no device serves rounded scales."""
    x = torch.randn(2, 8, 5, 5)
    with pytest.raises(ValueError, match="fp32"):
        quant.quantize_ref(x, torch.tensor(0.1, dtype=torch.bfloat16), divide=False)
    xq = quant.quantize_ref(x, torch.tensor(0.05), divide=False)
    wq = torch.ones(4, 3, 3, 8, dtype=torch.int8)
    geo = ((1, 1), (1, 1), (1, 1))
    for ws, xs in ((torch.ones(4, dtype=torch.bfloat16), torch.tensor(0.05)),
                   (torch.ones(4), torch.tensor(0.05, dtype=torch.bfloat16)),
                   (torch.ones(4), None)):
        with pytest.raises(ValueError, match="fp32"):
            quant.int8_conv_ref(xq, wq, ws, xs, None, *geo, torch.float32)


def test_se_convs_are_not_quantized(stack):
    """The SE blocks' 1x1 convs are the JAX model's Dense layers."""
    pset = quant.build_quant_set(stack[4][0], min_fan_in=1, min_out=1)
    assert pset and not any(".se." in k or k.startswith("modality_attention") for k in pset)


# --------------------------------------------------------- one conv at a time
# (Cin, Cout, kernel, stride, padding, dilation, side): the shape classes of
# the served convs
CONVS = {
    "1x1": (32, 48, 1, 1, 0, 1, 9),
    "1x1_s2": (32, 64, 1, 2, 0, 1, 9),
    "3x3": (16, 32, 3, 1, 1, 1, 8),
    "3x3_s2": (16, 32, 3, 2, 1, 1, 9),
    "3x3_d2": (32, 40, 3, 1, 2, 2, 9),
    "3x3_d4": (16, 32, 3, 1, 4, 4, 10),
    "stem7_c14": (14, 64, 7, 2, 3, 1, 16),
    "stem7_c6": (6, 64, 7, 2, 3, 1, 16),
    "patch16_c14": (14, 48, 16, 16, 0, 1, 32),
}


def _jax_conv(name, bias):
    cin, cout, k, s, p, d, _ = CONVS[name]
    return fnn.Conv(cout, (k, k), strides=(s, s), padding=((p, p), (p, p)),
                    kernel_dilation=(d, d), use_bias=bias)


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONVS))
def test_conv_matches_quant_conv_call(name, dtype, static):
    cin, cout, k, s, p, d, side = CONVS[name]
    bias = list(CONVS).index(name) % 2 == 0
    rng = np.random.RandomState(list(CONVS).index(name))
    x = (rng.randn(2, side, side, cin) * 3).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.5).astype(np.float32) if bias else None
    jqk, jscale = jq.quantize_kernel_per_channel(w)
    q = {"kernel_q": jnp.asarray(jqk), "scale": jnp.asarray(jscale)}
    if static:  # a scale that clips: the clamp to +-127 is exercised
        q["x_scale"] = jnp.float32(max(float(np.abs(x).max()) * 0.8, 1e-12) / 127.0)
    conv = _jax_conv(name, bias)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))

    jb = None if b is None else jnp.asarray(b)
    # JAX's code op by op, as written ...
    jy_eager = jq._quant_conv_call(conv, jx, q, jb)
    jxq, jxs = ((jq._static_quantize(jx, q["x_scale"]), q["x_scale"]) if static
                else jq._dynamic_quantize(jx))
    jacc = jax.lax.conv_general_dilated(
        jxq, q["kernel_q"], (s, s), ((p, p), (p, p)), rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    # ... and compiled, as JAX serves it: XLA contracts the dequantize's
    # float(acc) * scale + bias into an FMA and takes the dynamic scale's
    # / 127 as * fp32(1 / 127)
    jy = jax.jit(lambda t: jq._quant_conv_call(conv, t, q, jb))(jx)
    jxs_c = jax.jit(lambda t: jq._dynamic_quantize(t)[1])(jx)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
    conv_t = torch.nn.Conv2d(cin, cout, k, s, p, d, bias=bias)
    with torch.no_grad():
        conv_t.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        if bias:
            conv_t.bias.copy_(torch.from_numpy(b))
    # fp32 parameters and a bf16 input, as the JAX module holds them
    pq, pscale = quant.quantize_kernel_per_channel(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    qmod = quant.QuantConv2d(conv_t, {"kernel_q": pq, "scale": pscale,
                                      **({"x_scale": torch.tensor(np.asarray(q["x_scale"]))}
                                         if static else {})})
    if static:
        xs = qmod.x_scale
        xq = quant._static_quantize(tx, xs)
    else:
        xq, xs = quant._dynamic_quantize(tx)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), np.asarray(jxq))
    acc = quant.int8_conv(xq, pq, pscale, xs, None, (s, s), (p, p), (d, d), torch.int32)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), np.asarray(jacc))
    with torch.no_grad():
        y = qmod(tx)
    assert y.dtype == tdt
    got = y.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(jy_eager.astype(jnp.float32)))
    if not static:  # the compiled scale is 1 ulp off where fp32(1/127) rounds it so
        assert abs(float(xs) - float(jxs_c)) <= np.spacing(np.float32(jxs_c))
        return
    ref = np.asarray(jy.astype(jnp.float32))
    # 1 ulp of the unfused product (under cancellation by the bias the
    # contracted result can sit more ulps of itself away), or of the result
    prod = np.asarray(jacc).astype(np.float32) * (np.float32(jxs) * np.asarray(jscale))
    ulp = np.spacing(np.maximum(np.abs(ref), np.abs(prod)).astype(np.float32))
    if dtype == "bfloat16":
        ulp = np.maximum(ulp, np.spacing(np.abs(ref)) * 2.0 ** 16)  # 8 significand bits
    assert (np.abs(got - ref) <= ulp).all(), float(np.abs(got - ref).max())


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rounds_as_jax_at_ties(dtype, static):
    """Inputs at (k + 1/2) x the scale in use, where ``x * (1 / scale)``
    (static) and ``x / scale`` (dynamic) round apart: each path bit-equal to
    JAX's; in fp32 the two paths differ on these inputs, so the test tells
    them apart (a bf16 input cannot sit that close to a tie)."""
    rng = np.random.RandomState(7)
    amax = np.float32(127 * 0.0123)
    # the dynamic scale as JAX's code computes it (max(amax, 1e-12) / 127 in fp32)
    s = np.float32(0.0123) if static else np.float32(amax / np.float32(127.0))
    k = rng.randint(-126, 126, 4096).astype(np.float32)
    x = ((k + 0.5) * s).astype(np.float32)
    x[0] = amax * np.float32(1.5 if static else 1.0)  # past the clamp when static
    x[1] = -x[0]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    if static:
        jq_, scale = jq._static_quantize(jx, jnp.float32(s)), torch.tensor(s)
        got = quant._static_quantize(tx, scale)
    else:
        jq_, jscale = jq._dynamic_quantize(jx)
        got, scale = quant._dynamic_quantize(tx)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq_))
    assert int(got.max()) == 127 and int(got.min()) == -127
    if dtype == "float32":
        other = quant.quantize_ref(tx, scale, divide=static)
        assert not torch.equal(other, got), "the two roundings agree on every input"


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        quant.dynamic_quantize(torch.zeros(3, device="meta"))


# --------------------------------------------------------------- calibration
@pytest.mark.parametrize("percentile", [100.0, 99.9])
def test_calibrate_act_scales_matches_jax(stack, percentile):
    """The DWI encoder, ``calibration_mc`` off: every calibrated conv's
    x_scale within rel 1e-5 of JAX's."""
    _, _, (jd, _, _), (vd, _, _), (pd, _, _), (names, _, _), (xd, _) = stack
    jset = jq.build_quant_set(vd["params"], **LOW)
    jq.calibrate_act_scales(jd, vd, jset, jnp.asarray(xd), percentile=percentile, train=False)
    pset = quant.build_quant_set(pd, **LOW)
    quant.calibrate_act_scales(pd, pset, torch.from_numpy(xd).permute(0, 3, 1, 2),
                               percentile=percentile)
    assert len(pset) > 20 and all("x_scale" in e for e in pset.values())
    for path, e in jset.items():
        got = pset[names[path]]["x_scale"]
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(e["x_scale"]), rtol=1e-5, err_msg=path)


def test_percentile_matches_jnp():
    a = np.random.RandomState(3).rand(10007).astype(np.float32)
    for p in (99.9, 50.0, 0.0, 100.0, 37.3):
        got = quant._percentile(torch.from_numpy(a), p)
        np.testing.assert_allclose(float(got), float(jnp.percentile(a, p)), rtol=1e-6)


def test_calibration_leaves_the_models_untouched(stack):
    pd = stack[4][0]
    before = {k: v.clone() for k, v in pd.state_dict().items()}
    modules = [type(m) for m in pd.modules()]
    pset = quant.build_quant_set(pd, **LOW)
    quant.calibrate_act_scales(pd, pset, torch.from_numpy(stack[6][0]).permute(0, 3, 1, 2))
    assert [type(m) for m in pd.modules()] == modules
    for k, v in pd.state_dict().items():
        assert torch.equal(v, before[k]), k


# --------------------------------------------------------------- whole models
@pytest.fixture(scope="module")
def qsets(stack):
    """Both packages' QuantSets for all three models (the LOW thresholds),
    JAX's calibrated with MC off; the port's carry JAX's x_scales, so both
    sides serve the same QuantSets."""
    cfg, _, jmods, jvars, pmods, maps, (xd, xc) = stack
    variables = dict(zip(("dwi", "dce", "fusion"), jvars))
    _, jsets = jq.make_quantized_fusion_apply(*jmods, variables, calibration=(
        jnp.asarray(xd), jnp.asarray(xc)), **LOW)
    psets = {}
    for key, m, names in zip(("dwi", "dce", "fusion"), pmods, maps):
        psets[key] = quant.build_quant_set(m, **LOW)
        for path, e in jsets[key].items():
            if names[path] in psets[key] and "x_scale" in e:
                psets[key][names[path]]["x_scale"] = torch.tensor(np.asarray(e["x_scale"]))
    return jsets, psets


def test_quantized_fusion_apply_calibrates_as_jax(stack, qsets):
    """``make_quantized_fusion_apply``'s own calibration (MC off) gives JAX's
    x_scales; JAX also calibrates the fusion head's unconsumed
    ``fusion_conv_reduce`` / ``refine`` convs, which no eval forward runs."""
    _, _, _, _, pmods, maps, (xd, xc) = stack
    jsets, _ = qsets
    _, psets = quant.make_quantized_fusion_apply(*pmods, calibration=(xd, xc), **LOW)
    for key, names in zip(("dwi", "dce", "fusion"), maps):
        for path, e in jsets[key].items():
            got = psets[key][names[path]].get("x_scale")
            if got is None:
                assert "fusion_conv_reduce" in path or "refine" in path, path
                continue
            np.testing.assert_allclose(float(got), float(e["x_scale"]), rtol=1e-5,
                                       err_msg=path)


def test_quantized_encoder_matches_quantized_apply(stack, qsets):
    _, _, (jd, _, _), (vd, _, _), (pd, _, _), _, (xd, _) = stack
    jsets, psets = qsets
    jl, _, _ = jax.jit(lambda v, x: jq.quantized_apply(jd, v, jsets["dwi"], x, train=False))(
        vd, jnp.asarray(xd))
    pl, _, _ = quant.quantized_apply(pd, psets["dwi"], torch.from_numpy(xd).permute(0, 3, 1, 2))
    with torch.no_grad():
        fl, _, _ = pd(torch.from_numpy(xd).permute(0, 3, 1, 2))
    d_q = float(np.abs(pl.numpy() - np.asarray(jl)).max())
    d_fp = float((pl - fl).abs().max())
    assert d_q <= 1e-4 * max(1.0, float(np.abs(np.asarray(jl)).max())) and d_q < d_fp / 10


def test_int8_predictor_matches_jax(stack, qsets):
    """``make_quantized_fusion_fwd`` through ``fwd_override`` in ``tta``,
    dropout off."""
    mode = "tta"
    cfg, pcfg, jmods, jvars, pmods, _, (xd, xc) = stack
    jsets, psets = qsets
    jfwd = jq.make_quantized_fusion_fwd(*jmods, jsets)
    jmean, jstd, _ = jax_predictor(cfg, *jmods, mode=mode, fwd_override=jfwd)(
        *jvars, jnp.asarray(xd), jnp.asarray(xc), jax.random.PRNGKey(0))
    args = (torch.from_numpy(xd), torch.from_numpy(xc), torch.Generator().manual_seed(0))
    fwd = quant.make_quantized_fusion_fwd(*pmods, psets)
    mean, std, _ = make_fusion_predictor(pcfg, *pmods, mode=mode, fwd_override=fwd)(*args)
    fp_mean, _, _ = make_fusion_predictor(pcfg, *pmods, mode=mode)(*args)
    jmean, jstd = np.asarray(jmean), np.asarray(jstd)
    np.testing.assert_array_equal(mean.numpy().argmax(-1), jmean.argmax(-1))
    d_q = float(np.abs(mean.numpy() - jmean).max())
    d_fp = float((mean - fp_mean).abs().max())
    assert d_q <= PROB_TOL <= d_fp / 10, (d_q, d_fp)
    np.testing.assert_allclose(std.numpy(), jstd, rtol=0, atol=PROB_TOL)


def test_quantized_fusion_apply_matches_jax_apply_fn(stack):
    """``make_quantized_fusion_apply``'s ``apply_fn`` against JAX's, dynamic
    scales (no calibration): the logits' argmax equal, logits and fused mask
    within 1e-4 and below a tenth of their int8-vs-fp32 distance."""
    _, _, jmods, jvars, pmods, _, (xd, xc) = stack
    variables = dict(zip(("dwi", "dce", "fusion"), jvars))
    japply, _ = jq.make_quantized_fusion_apply(*jmods, variables, **LOW)
    jl, jm = jax.jit(lambda v, a, b: japply(v, a, b)[:2])(variables, jnp.asarray(xd),
                                                             jnp.asarray(xc))
    apply_fn, _ = quant.make_quantized_fusion_apply(*pmods, **LOW)
    pl, pm, _, parts, _ = apply_fn(torch.from_numpy(xd), torch.from_numpy(xc))
    assert set(parts) == {"dwi_aux", "dce_aux", "dwi_mask", "dce_mask"}
    with torch.no_grad():
        (_, d_aux, d_mask), (_, c_aux, c_mask) = (
            m(torch.from_numpy(x).permute(0, 3, 1, 2)) for m, x in zip(pmods, (xd, xc)))
        fl, fm, _ = pmods[2](d_aux["raw_feats"], c_aux["raw_feats"], d_mask, c_mask)
    jl, jm = np.asarray(jl), np.asarray(jm).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(pl.numpy().argmax(-1), jl.argmax(-1))
    for got, ref, fp in ((pl, jl, fl), (pm, jm, fm)):
        d_q = float(np.abs(got.numpy() - ref).max())
        d_fp = float((got - fp).abs().max())
        assert d_q <= 1e-4 * max(1.0, float(np.abs(ref).max())) and d_q < d_fp / 10, (d_q, d_fp)


# ----------------------------------------------------------- MC and hybrid
@pytest.fixture(scope="module")
def mc_stack():
    """The port's toy fusion models with dropout on (0.3), 3 MC passes."""
    from dmf_tpu_torch.models import build_fusion_models

    pcfg = port_config(tiny_cfg(dropout=0.3, use_backbone=True, mc_passes=3))
    models = build_fusion_models(pcfg, "cpu", torch.float32, torch.Generator().manual_seed(0),
                                 backbone_layers=(1, 1, 1, 1))
    xd, xc = (torch.from_numpy(a) for a in volumes(4))
    return pcfg, models, xd, xc


def test_hybrid_with_empty_qsets_is_the_fp_predictor(mc_stack):
    """tests/test_quant.py:284-305: bit-equal in ``tta_mc`` under one generator."""
    pcfg, models, xd, xc = mc_stack
    hfwd = quant.make_hybrid_fusion_fwd(*models, {"dwi": {}, "dce": {}, "fusion": {}})
    mp, sp, _ = make_fusion_predictor(pcfg, *models, mode="tta_mc")(
        xd, xc, torch.Generator().manual_seed(3))
    mh, sh, _ = make_fusion_predictor(pcfg, *models, mode="tta_mc", fwd_override=hfwd)(
        xd, xc, torch.Generator().manual_seed(3))
    assert torch.equal(mp, mh) and torch.equal(sp, sh)


@pytest.mark.parametrize("hybrid", [False, True])
def test_int8_tta_mc_ensemble_within_jax_bounds(mc_stack, hybrid):
    """tests/test_quant.py:186-281 and :307-363: the int8 (or int8-prefix)
    ``tta_mc`` ensemble against the fp one under one generator seed: mean and
    std within 0.05, the same argmax; calibrated with MC dropout on."""
    pcfg, models, xd, xc = mc_stack
    _, psets = quant.make_quantized_fusion_apply(
        *models, calibration=(xd, xc), calibration_mc=True,
        calibration_rng=torch.Generator().manual_seed(1))
    assert psets["dwi"] and all("x_scale" in e for e in psets["dwi"].values())
    make = quant.make_hybrid_fusion_fwd if hybrid else quant.make_quantized_fusion_fwd
    fwd = make(*models, psets)
    mp, sp, _ = make_fusion_predictor(pcfg, *models, mode="tta_mc")(
        xd, xc, torch.Generator().manual_seed(7))
    mq, sq, _ = make_fusion_predictor(pcfg, *models, mode="tta_mc", fwd_override=fwd)(
        xd, xc, torch.Generator().manual_seed(7))
    assert (mp - mq).abs().max() < 0.05 and (sp - sq).abs().max() < 0.05
    assert torch.equal(mp.argmax(-1), mq.argmax(-1))
    assert not torch.equal(mp, mq), "the int8 convs ran"
    assert (sq > 0).all()


def test_hybrid_degrades_to_fp_in_deterministic_modes(mc_stack):
    pcfg, models, xd, xc = mc_stack
    psets = {k: quant.build_quant_set(m) for k, m in zip(("dwi", "dce", "fusion"), models)}
    hfwd = quant.make_hybrid_fusion_fwd(*models, psets)
    for mode in ("normal", "tta"):
        fp = make_fusion_predictor(pcfg, *models, mode=mode)(xd, xc)
        hy = make_fusion_predictor(pcfg, *models, mode=mode, fwd_override=hfwd)(xd, xc)
        assert torch.equal(fp[0], hy[0]) and torch.equal(fp[1], hy[1])


def test_int8_neck_takes_the_conv_bn_gelu_route(mc_stack):
    """A quantized copy's necks launch no kernel 2 (the conv3x3_bn_gelu
    operator is never called), and its convs go through the int8 operators."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.name().startswith("dmf::"):
                key = func.name().split("::")[1].split(".")[0]
                self.calls[key] = self.calls.get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    pcfg, models, xd, xc = mc_stack
    qset = quant.build_quant_set(models[0], **LOW)
    assert sum(k.startswith("backbone_adapter.necks") for k in qset) == 6
    qd = quant.quantized_copy(models[0], qset)
    with torch.no_grad(), Calls() as calls:
        qd(xd.permute(0, 3, 1, 2), prefix_only=True)
    assert calls.calls.get("conv3x3_bn_gelu", 0) == 0
    prefix = sum(k.startswith("backbone") for k in qset)  # backbone and adapter
    assert calls.calls["int8_conv"] == calls.calls["dynamic_quantize"] == prefix
    assert calls.calls.get("quantize", 0) == 0
    assert all(isinstance(models[0].get_submodule(k), torch.nn.Conv2d) for k in qset)


def test_fwd_override_must_be_a_pass_forward(mc_stack):
    pcfg, models, _, _ = mc_stack
    with pytest.raises(TypeError, match="PassForward"):
        make_fusion_predictor(pcfg, *models, fwd_override=lambda *a: None)


# --------------------------------------------------------------- entry points
class _Stop(Exception):
    pass


def test_test_fusion_model_int8_calibrates_on_validation(monkeypatch, tmp_path, mc_stack):
    """``test_fusion_model(int8=True, calibration_data=val)`` runs and its
    calibration reads the first 8 validation volumes, never the test split;
    ``fusion_model_test`` forwards both; ``run_fusion_model`` passes the
    validation split (run_fusion.py:243-248)."""
    from dmf_tpu_torch.pipeline import run_fusion
    from dmf_tpu_torch.train.fusion import FusionNetwork
    from dmf_tpu_torch.train.state import TrainState

    pcfg, models, _, _ = mc_stack
    pcfg = pcfg.replace(batch_size=3)
    rng = np.random.RandomState(9)

    def split(n):
        return {"dwi": rng.rand(n, 32, 32, 14).astype(np.float32),
                "dce": rng.rand(n, 32, 32, 6).astype(np.float32),
                "labels": rng.randint(0, pcfg.class_num, n)}

    val, test = split(10), split(5)
    seen = []
    real = quant.make_quantized_fusion_apply

    def spy(*a, calibration=None, **kw):
        seen.append((calibration, kw))
        return real(*a, calibration=calibration, **kw)

    monkeypatch.setattr(quant, "make_quantized_fusion_apply", spy)
    state = TrainState.create(FusionNetwork(*models))
    res = run_fusion.fusion_model_test(pcfg, state, test, seed=2, int8=True,
                                       calibration_data=val)
    (dwi, dce), kw = seen[0]
    np.testing.assert_array_equal(dwi, val["dwi"][:8])
    np.testing.assert_array_equal(dce, val["dce"][:8])
    assert kw["calibration_mc"] is True  # tta_mc serves with dropout on
    assert np.isfinite(res["probs"]).all() and res["probs"].shape == (5, pcfg.class_num)
    np.testing.assert_allclose(res["probs"].sum(-1), 1.0, rtol=1e-5)
    fp = run_fusion.test_fusion_model(pcfg, state, test, seed=2)
    assert not np.array_equal(fp["probs"], res["probs"])
    # the last resort: the test split
    run_fusion.test_fusion_model(pcfg.replace(test_mode="tta"), state, test, int8=True)
    np.testing.assert_array_equal(seen[1][0][0], test["dwi"][:5])
    assert seen[1][1]["calibration_mc"] is False

    calls = []

    def stop(*a, **kw):
        calls.append(kw)
        raise _Stop

    monkeypatch.setattr(run_fusion, "test_fusion_model", stop)
    monkeypatch.setattr(run_fusion, "fit_fusion", lambda *a, **kw: type(
        "Fit", (), {"best_state": state, "state": state})())
    monkeypatch.setattr(run_fusion, "build_fusion_state", lambda *a, **kw: state)
    fd = {"train": val, "val": val, "test": test}
    with pytest.raises(_Stop):
        run_fusion.run_fusion_model(pcfg, 0, {"state": state}, {"state": state},
                                    fusion_data=fd, base_dir=str(tmp_path))
    assert calls[0]["calibration_data"] is val


def test_int8_artifact_equals_eager_seed_route(mc_stack):
    """An int8 ``tta_mc`` artifact exported on the CPU (the int8 weights and
    scales as arguments, no tensor held) against the eager int8 predictor on
    the seed route: bit for bit."""
    pcfg, models, xd, xc = mc_stack
    _, psets = quant.make_quantized_fusion_apply(*models, calibration=(xd, xc),
                                                 calibration_mc=True, **LOW)
    fwd = quant.make_quantized_fusion_fwd(*models, psets)
    fn = make_serving_fn(pcfg, *models, mode="tta_mc", fwd_override=fwd)
    variables = serving_variables(*models, fwd_override=fwd)
    assert set(variables) == {"dwi", "dce", "fusion", *fwd.modules}
    assert "backbone.conv1.weight_q" in variables["int8_dwi"]
    args = (variables, xd, xc, torch.tensor(11))
    served = load_serving(export_serving(fn, args))
    got = served(*args)
    eager = make_fusion_predictor(pcfg, *models, mode="tta_mc", fwd_override=fwd)(
        xd, xc, torch.tensor(11))
    assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])
    # fresh int8 weights ride in as arguments: other scales, other numbers
    bumped = {k: dict(v) for k, v in variables.items()}
    bumped["int8_dwi"]["backbone.conv1.w_scale"] = variables["int8_dwi"][
        "backbone.conv1.w_scale"] * 1.5
    assert not torch.equal(served(bumped, xd, xc, torch.tensor(11))[0], got[0])


def _opcheck_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 6, 6, generator=g)
    xq = torch.randint(-127, 128, (2, 16, 6, 6), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (8, 3, 3, 16), generator=g, dtype=torch.int8)
    ws, xs = torch.rand(8, generator=g) * 0.01, torch.tensor(0.02)
    cl = torch.channels_last
    return {
        "int8_conv_f32": ("int8_conv", (xq, wq, ws, xs, torch.randn(8), [1, 1], [1, 1], [1, 1],
                                        torch.float32)),
        "int8_conv_i32_cl": ("int8_conv", (xq.contiguous(memory_format=cl), wq, ws, None, None,
                                           [2, 2], [2, 2], [2, 2], torch.int32)),
        "int8_conv_bf16": ("int8_conv", (xq, wq, ws, xs, None, [1, 2], [0, 1], [1, 1],
                                         torch.bfloat16)),
        "quantize": ("quantize", (x, xs, False)),
        "quantize_cl_div": ("quantize", (x.contiguous(memory_format=cl), xs, True)),
        "dynamic_quantize": ("dynamic_quantize", (x.to(torch.bfloat16),)),
    }


@pytest.mark.parametrize("case", list(_opcheck_cases()))
def test_opcheck(case):
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(getattr(torch.ops.dmf, op).default, args)


def test_operators_registered():
    assert {"int8_conv", "quantize", "dynamic_quantize"} <= set(library.OPERATORS)
    counts = library.launch_counts()
    assert {"int8_conv", "quantize", "dynamic_quantize"} <= set(counts)
