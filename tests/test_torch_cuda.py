"""The port's hand-written kernels on the card, against their plain versions.

Marked ``cuda``: without a CUDA device every test here skips (the decision is
made in a fixture, at run time).  On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``.  Tolerances are
relative to ``max(1, max|plain|)``: 1e-4 in fp32 (TF32 off; sums in another
order) and 2^-7 in bf16 (one bf16 ulp).
"""

import pytest
import torch

from dmf_tpu_torch.ops import conv3x3 as k2
from dmf_tpu_torch.ops import epilogue as k1

pytestmark = pytest.mark.cuda

# the suite runs under several pytest-xdist workers; keep each torch pool small
torch.set_num_threads(2)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dtype):
    bound = TOL[dtype] * max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= bound


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [128, 200])
def test_se_epilogue_kernel(dev, dtype, c):
    from dmf_tpu_torch.ops import epilogue_triton

    g = torch.Generator(device=dev).manual_seed(0)
    x = _cl(torch.randn(6, c, 12, 10, device=dev, generator=g).to(dtype))
    idn = _cl(torch.randn(6, c, 12, 10, device=dev, generator=g).to(dtype))
    w1 = torch.randn(c // 2, c, device=dev, generator=g) * c ** -0.5
    w2 = torch.randn(c, c // 2, device=dev, generator=g) * c ** -0.5
    b1 = torch.randn(c // 2, device=dev, generator=g) * 0.1
    b2 = torch.randn(c, device=dev, generator=g) * 0.1
    args = (x, idn, w1, b1, w2, b2)
    k1.se_epilogue.launches = 0
    _close(k1.se_epilogue(*args), k1.se_epilogue_ref(*args), dtype)
    out = k1.se_epilogue(*args, drop_rate=0.3, generator=torch.Generator(device=dev).manual_seed(4))
    seed = epilogue_triton.draw_seed(torch.Generator(device=dev).manual_seed(4), dev)
    keep = epilogue_triton.keep_mask(x, 0.3, seed)
    _close(out, k1.se_epilogue_ref(*args, drop_rate=0.3, keep=keep), dtype)
    assert k1.se_epilogue.launches == 2
    with pytest.raises(ValueError, match="channels_last"):
        k1.se_epilogue(x.contiguous(), idn.contiguous(), w1, b1, w2, b2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 7, 136, 24), (1, 16, 16, 64, 128)])
def test_conv3x3_kernel(dev, dtype, shape):
    n, h, w, cin, cout = shape
    g = torch.Generator(device=dev).manual_seed(1)
    x = _cl(torch.randn(n, cin, h, w, device=dev, generator=g).to(dtype))
    wt = torch.randn(cout, cin, 3, 3, device=dev, generator=g) * (9 * cin) ** -0.5
    stats = [torch.randn(cout, device=dev, generator=g) * 0.1 for _ in range(3)]
    var = torch.rand(cout, device=dev, generator=g) + 0.5
    gamma = torch.rand(cout, device=dev, generator=g) + 0.5
    args = (x, wt, stats[0], gamma, stats[1], stats[2], var)
    k2.conv3x3_bn_gelu.launches = 0
    out = k2.conv3x3_bn_gelu(*args)
    assert out.is_contiguous(memory_format=torch.channels_last)
    _close(out, k2.conv3x3_bn_gelu_ref(*args), dtype)
    assert k2.conv3x3_bn_gelu.launches == 1
    with pytest.raises(ValueError, match="channels_last"):
        k2.conv3x3_bn_gelu(x.contiguous(), *args[1:])
