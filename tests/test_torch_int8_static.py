"""The int8 static route on the CPU: a calibrated ``QuantConv2d`` quantizes
its input at the static scale (``quantize``, by the fp32 reciprocal) and
runs the int8 conv (``int8_conv``).  At toy size:

* ``quantize_ref`` then ``int8_conv_ref``, the wrappers and a
  ``QuantConv2d`` are bit-equal, op by op, to JAX's ``_static_quantize``
  followed by ``_quant_conv_call`` (``dmf_tpu/ops/quant.py:89-139``), in
  fp32 and bf16, over the served shape classes (1x1, 3x3 at strides 1 and
  2, dilation 2, the 7x7 stems at Cin 6 and 14, Cout 32 / 96 / 160, a
  ragged last pixel tile);
* an exported int8 forward holds one ``dmf::quantize`` and one
  ``dmf::int8_conv`` node a static conv; a dynamic one a
  ``dmf::dynamic_quantize`` and an int8_conv node a conv, and no abs-max;
* the two operators' fake implementations give the CPU results' shape,
  dtype and strides on float maps (``torch.library.opcheck`` and a
  fake-mode call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dmf_tpu.ops import quant as jq
from dmf_tpu_torch.ops import library, quant
from dmf_tpu_torch.serving import operator_nodes

# (Cin, Cout, kernel, stride, padding, dilation, side): N = 2 and the sides
# leave the last 128-pixel tile ragged where there are more than 128 pixels
SHAPES = {
    "1x1_c96": (32, 96, 1, 1, 0, 1, 9),
    "3x3_c32": (16, 32, 3, 1, 1, 1, 7),
    "3x3_s2_c160": (32, 160, 3, 2, 1, 1, 9),
    "3x3_d2_c96": (16, 96, 3, 1, 2, 2, 8),
    "stem7_c14": (14, 32, 7, 2, 3, 1, 12),
    "stem7_c6": (6, 32, 7, 2, 3, 1, 11),
}


def _case(name, dtype):
    """Inputs from a seed with a static scale that clips, the QuantSet entry
    (JAX's and the port's: the same numbers), and a bias on every other
    shape."""
    cin, cout, k, s, p, d, side = SHAPES[name]
    idx = list(SHAPES).index(name)
    rng = np.random.RandomState(100 + idx)
    x = (rng.randn(2, side, side, cin) * 3).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.5).astype(np.float32) if idx % 2 == 0 else None
    kq, scale = jq.quantize_kernel_per_channel(w)
    xs = np.float32(float(np.abs(x).max()) * 0.8 / 127.0)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    wq = torch.from_numpy(np.asarray(kq)).permute(3, 0, 1, 2).contiguous()  # OHWI
    port = dict(x=tx.permute(0, 3, 1, 2), wq=wq, w_scale=torch.from_numpy(np.asarray(scale)),
                x_scale=torch.tensor(xs), bias=None if b is None else torch.from_numpy(b),
                geo=((s, s), (p, p), (d, d)),
                conv=torch.nn.Conv2d(cin, cout, k, s, p, d, bias=b is not None))
    jaxs = dict(x=jx, q={"kernel_q": jnp.asarray(kq), "scale": jnp.asarray(scale),
                         "x_scale": jnp.float32(xs)},
                bias=None if b is None else jnp.asarray(b),
                conv=fnn.Conv(cout, (k, k), strides=(s, s), padding=((p, p), (p, p)),
                              kernel_dilation=(d, d), use_bias=b is not None))
    return port, jaxs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_static_route_is_quantize_then_conv_as_jax(name, dtype):
    t, j = _case(name, dtype)
    args = (t["wq"], t["w_scale"], t["x_scale"], t["bias"], *t["geo"])
    out_dtype = t["x"].dtype
    xq = quant.quantize_ref(t["x"], t["x_scale"], divide=False)
    got = quant.int8_conv_ref(xq, *args, out_dtype)
    assert got.dtype == out_dtype
    # the int8 input and its int32 sums, and JAX's code op by op
    acc = quant.int8_conv_ref(xq, *args, torch.int32)
    jxq = jq._static_quantize(j["x"], j["q"]["x_scale"])
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), np.asarray(jxq))
    (s, _), (p, _), (d, _) = t["geo"]
    jacc = jax.lax.conv_general_dilated(
        jxq, j["q"]["kernel_q"], (s, s), ((p, p), (p, p)), rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), np.asarray(jacc))
    jy = jq._quant_conv_call(j["conv"], j["x"], j["q"], j["bias"])
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    # the wrappers (the operators' CPU implementations) and a calibrated
    # QuantConv2d give the same bits
    wrapped = quant.int8_conv(quant.quantize(t["x"], t["x_scale"]), *args, out_dtype)
    assert torch.equal(wrapped, got)
    q = {"kernel_q": t["wq"], "scale": t["w_scale"], "x_scale": t["x_scale"]}
    if t["bias"] is not None:
        q["bias"] = t["bias"]
    with torch.no_grad():
        assert torch.equal(quant.QuantConv2d(t["conv"], q)(t["x"]), got)


def _quant_stack(static):
    """Two 3x3 convs and a 1x1 with BatchNorm / ReLU between them, quantized
    (calibrated: static scales; else dynamic), and an input."""
    g = torch.Generator().manual_seed(7)
    net = torch.nn.Sequential(
        torch.nn.Conv2d(16, 32, 3, padding=1), torch.nn.BatchNorm2d(32), torch.nn.ReLU(),
        torch.nn.Conv2d(32, 32, 3, padding=2, dilation=2), torch.nn.ReLU(),
        torch.nn.Conv2d(32, 48, 1)).eval()
    with torch.no_grad():
        for prm in net.parameters():
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.2)
    x = torch.randn(2, 16, 9, 9, generator=g)
    qset = quant.build_quant_set(net, min_fan_in=16, min_out=8)
    if static:
        quant.calibrate_act_scales(net, qset, x)
    return quant.quantized_copy(net, qset), x, len(qset)


@pytest.mark.parametrize("static", [True, False])
def test_exported_int8_forward_operators(static):
    """A static QuantConv2d is one ``dmf::quantize`` and one
    ``dmf::int8_conv`` node; a dynamic one dynamic_quantize and int8_conv."""
    qnet, x, n = _quant_stack(static)
    with torch.no_grad():
        nodes = operator_nodes(torch.export.export(qnet, (x,)))
    if static:
        expect = {"quantize": n, "int8_conv": n}
    else:
        expect = {"dynamic_quantize": n, "int8_conv": n}
    assert nodes == dict.fromkeys(library.OPERATORS, 0) | expect


def _op_cases():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 7, 6, generator=g) * 2
    wq = torch.randint(-127, 128, (24, 3, 3, 16), generator=g, dtype=torch.int8)
    ws, xs = torch.rand(24, generator=g) * 0.01, torch.tensor(0.015)
    cl = torch.channels_last
    return {
        "bf16_cl": (x.to(torch.bfloat16).contiguous(memory_format=cl), wq, ws, xs,
                    torch.randn(24, generator=g), [1, 1], [1, 1], [1, 1], torch.bfloat16),
        "f32_i32": (x, wq, ws, xs, None, [2, 1], [1, 0], [1, 2], torch.int32),
        "f32_f32_cl": (x.contiguous(memory_format=cl), wq, ws, xs, None, [1, 1], [2, 2], [2, 2],
                       torch.float32),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_static_route_operators(case):
    """opcheck of ``quantize`` on the float map and of ``int8_conv`` on its
    int8 copy, and each fake implementation's shape, dtype and strides
    against the CPU implementation's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, wq, ws, xs, *rest = _op_cases()[case]
    xq = torch.ops.dmf.quantize(x, xs, False)
    for op, args in ((torch.ops.dmf.quantize.default, (x, xs, False)),
                     (torch.ops.dmf.int8_conv.default, (xq, wq, ws, xs, *rest))):
        torch.library.opcheck(op, args)
        real = op(*args)
        with FakeTensorMode() as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                        for a in args))
        assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
