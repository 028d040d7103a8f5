"""The dynamic int8 quantize (``dmf::dynamic_quantize``, ``ops/quant.py``)
against the JAX package's ``_dynamic_quantize`` (``dmf_tpu/ops/quant.py:76-87``),
on the CPU.

The operator computes ``scale = max(max|x|, 1e-12) / 127`` in fp32 and
``clip(rne(x / scale), -127, 127)`` as int8 in one call; on the CPU it runs
its plain version, on the card one launch of ``csrc/int8_quantize.cu``
(``tests/test_torch_cuda.py`` holds the two together there).  Here:

* codes and scale bit-equal to JAX's, fp32 and bf16, contiguous (NCHW) and
  channels_last inputs, sizes that are no multiple of 4, 8 or 16;
* an all-zero input gives the scale ``1e-12 / 127``; an input holding a NaN
  gives a NaN scale on both sides (JAX's max keeps NaN, and so does the
  port's);
* the fake implementation gives the CPU results' shapes, dtypes and memory
  format, and ``torch.library.opcheck`` passes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from dmf_tpu.ops import quant as jq
from dmf_tpu_torch.ops import library, quant  # noqa: F401  (registers dmf::)

# NHWC; sizes 210, 153, 1155 and 4099 elements
SHAPES = [(2, 5, 7, 3), (1, 3, 3, 17), (3, 7, 11, 5), (1, 1, 4099, 1)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, dtype, seed, scale=3.0):
    """The same values for both packages: JAX's array (NHWC) and the port's
    (N, C, H, W) tensor, the bf16 rounding JAX's own."""
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(DTYPES[dtype])
    return jx, tx.permute(0, 3, 1, 2)


def _layout(t, channels_last):
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return t.contiguous(memory_format=fmt), fmt


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("channels_last", [False, True])
def test_dynamic_quantize_matches_jax(shape, dtype, channels_last):
    jx, tx = _inputs(shape, dtype, seed=sum(shape))
    tx, fmt = _layout(tx, channels_last)
    jxq, jscale = jq._dynamic_quantize(jx)
    before = quant.dynamic_quantize.launches
    xq, scale = quant._dynamic_quantize(tx)
    assert quant.dynamic_quantize.launches == before  # the CPU runs the plain version
    assert xq.dtype == torch.int8 and xq.is_contiguous(memory_format=fmt)
    assert scale.dtype == torch.float32 and scale.shape == ()
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), np.asarray(jxq))
    ref_q, ref_s = quant.dynamic_quantize_ref(tx)
    assert torch.equal(ref_q, xq) and torch.equal(ref_s, scale)
    assert int(xq.abs().max()) == 127


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dynamic_quantize_zero_input(dtype):
    jx, tx = _inputs((2, 3, 5, 3), dtype, seed=0, scale=0.0)
    jxq, jscale = jq._dynamic_quantize(jx)
    xq, scale = quant.dynamic_quantize(tx)
    tiny = np.float32(np.float32(1e-12) / np.float32(127.0))
    assert scale.item() == tiny == float(jscale)
    assert not xq.any() and not np.asarray(jxq).any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("channels_last", [False, True])
def test_dynamic_quantize_nan_scale(dtype, channels_last):
    """A NaN anywhere gives a NaN scale, as JAX's ``jnp.max`` does (the codes
    are not compared: NaN's cast to int8 is the backend's choice)."""
    x = (np.random.RandomState(3).randn(2, 3, 4, 5) * 2).astype(np.float32)
    x[1, 2, 0, 3] = np.nan
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(DTYPES[dtype])
    tx, _ = _layout(tx.permute(0, 3, 1, 2), channels_last)
    _, jscale = jq._dynamic_quantize(jx)
    xq, scale = quant.dynamic_quantize(tx)
    assert np.isnan(float(jscale)) and torch.isnan(scale)
    assert xq.dtype == torch.int8 and xq.shape == tx.shape


@pytest.mark.parametrize("dtype", list(DTYPES.values()))
@pytest.mark.parametrize("channels_last", [False, True])
def test_dynamic_quantize_fake(dtype, channels_last):
    """The fake implementation: the CPU results' shapes, dtypes and strides."""
    x, fmt = _layout(torch.randn(2, 6, 5, 7).to(dtype), channels_last)
    xq, scale = torch.ops.dmf.dynamic_quantize(x)
    with FakeTensorMode() as mode:
        fq, fs = torch.ops.dmf.dynamic_quantize(mode.from_tensor(x))
    assert fq.shape == xq.shape and fq.dtype == torch.int8 and fq.stride() == xq.stride()
    assert fq.is_contiguous(memory_format=fmt)
    assert fs.shape == scale.shape == () and fs.dtype == scale.dtype == torch.float32


@pytest.mark.parametrize("dtype", list(DTYPES.values()))
@pytest.mark.parametrize("channels_last", [False, True])
def test_dynamic_quantize_opcheck(dtype, channels_last):
    x, _ = _layout(torch.randn(2, 6, 5, 7, generator=torch.Generator().manual_seed(4))
                   .to(dtype), channels_last)
    torch.library.opcheck(torch.ops.dmf.dynamic_quantize.default, (x,))
