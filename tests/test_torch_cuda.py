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
from dmf_tpu_torch.ops import dwi_norm, histogram, se
from dmf_tpu_torch.ops import epilogue as k1
from dmf_tpu_torch.ops import flash_attention as fa

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
@pytest.mark.parametrize("n,h,w,c", [
    (6, 12, 10, 128),   # HW = 120, not a multiple of the pixel block
    (6, 12, 10, 200),   # C not a power of two
    (1, 33, 17, 200),   # N = 1, HW = 561
    (3, 16, 16, 512),
    (301, 3, 3, 256),   # 3 maps per MLP block on 132 SMs, the last block with one
    (2, 5, 7, 1002),    # C not a multiple of the vector: scalar loads, 1024 threads
    (32, 16, 16, 768)])  # a ViT-backed ResLite block's map (768 channels on 16^2)
def test_se_epilogue_kernel(dev, dtype, n, h, w, c):
    from dmf_tpu_torch.ops import epilogue_cuda

    g = torch.Generator(device=dev).manual_seed(0)
    x = _cl(torch.randn(n, c, h, w, device=dev, generator=g).to(dtype))
    idn = _cl(torch.randn(n, c, h, w, device=dev, generator=g).to(dtype))
    w1 = torch.randn(c // 2, c, device=dev, generator=g) * c ** -0.5
    w2 = torch.randn(c, c // 2, device=dev, generator=g) * c ** -0.5
    b1 = torch.randn(c // 2, device=dev, generator=g) * 0.1
    b2 = torch.randn(c, device=dev, generator=g) * 0.1
    args = (x, idn, w1, b1, w2, b2)
    k1.se_epilogue.launches = 0
    ref = k1.se_epilogue_ref(*args)
    out = k1.se_epilogue(*args)
    _close(out, ref, dtype)
    # a second call gives the same bits: the pool's sum order is fixed
    assert torch.equal(out, k1.se_epilogue(*args))
    out = k1.se_epilogue(*args, drop_rate=0.3, generator=torch.Generator(device=dev).manual_seed(4))
    seed = epilogue_cuda.draw_seed(torch.Generator(device=dev).manual_seed(4), dev)
    keep = epilogue_cuda.keep_mask(x, 0.3, seed)
    _close(out, k1.se_epilogue_ref(*args, drop_rate=0.3, keep=keep), dtype)
    assert k1.se_epilogue.launches == 3
    with pytest.raises(ValueError, match="channels_last"):
        k1.se_epilogue(x.contiguous(), idn.contiguous(), w1, b1, w2, b2)


@pytest.mark.parametrize("base", [0, 2 ** 31 - 40, 2 ** 32 - 41, 2 ** 40 + 3])
def test_keep_mask_bits_match_philox_past_2_31(dev, base):
    """The kernel's keep bits equal the plain numpy Philox4x32-10 at element
    indices that straddle 2^31 and 2^32 (64-bit counter and offsets)."""
    from dmf_tpu_torch.ops import epilogue_cuda

    x = _cl(torch.zeros(2, 5, 3, 7, device=dev))
    for seed in (12345, (0x5EED << 32) | 77, 2 ** 63 - 2):
        got = epilogue_cuda.keep_mask(x, 0.2, torch.tensor([seed], device=dev), base=base)
        flat = got.permute(0, 2, 3, 1).reshape(-1).cpu().numpy()
        assert (flat == epilogue_cuda.keep_mask_ref(base, x.numel(), 0.2, seed)).all()


def test_conv3x3_refuses_autograd(dev):
    """Kernel 2 has no backward: a call autograd would record raises, and
    under no_grad it runs."""
    x = _cl(torch.randn(1, 16, 8, 8, device=dev))
    wt = (torch.randn(16, 16, 3, 3, device=dev) * 0.1).requires_grad_()
    ones, zeros = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        k2.conv3x3_bn_gelu(x, wt, None, ones, zeros, zeros, ones)
    with pytest.raises(RuntimeError, match="no backward"):
        k2.conv3x3_bn_gelu(x.clone().requires_grad_(), wt.detach(), None, ones, zeros,
                           zeros, ones)
    with torch.no_grad():
        assert k2.conv3x3_bn_gelu(x, wt, None, ones, zeros, zeros, ones).shape == x.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 9, 7, 136, 24),     # Cin not a multiple of 64, Cout under a tile, M = 126 ragged
    (1, 16, 16, 64, 128),
    (2, 32, 32, 3072, 256),  # a K loop of 432 steps, many times the ring's depth
    (3, 5, 1, 64, 200),     # W = 1; Cout not a multiple of the channel tile
    (1, 64, 64, 128, 128),
    (2, 6, 5, 16, 16),      # Cin under one K step: the weight box is wider than Cin
    (4, 16, 16, 3840, 768),  # the ViT's neck_f3_conv0: K = 34560, five token maps
    (4, 16, 16, 768, 768)])  # the ViT's second neck convs
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
    ref = k2.conv3x3_bn_gelu_ref(*args)
    _close(out, ref, dtype)
    assert k2.conv3x3_bn_gelu.launches == 1
    # two calls give the same bits: no split-K, a fixed K order
    assert torch.equal(out, k2.conv3x3_bn_gelu(*args))
    if dtype == torch.bfloat16:  # both channel tiles of the bf16 kernel
        for tile in (128, 256):
            _close(k2.conv3x3_bn_gelu(*args, _tile_n=tile), ref, dtype)
    else:  # 3xTF32: a step's accumulator fits beside the sum at 128 channels only
        _close(k2.conv3x3_bn_gelu(*args, _tile_n=128), ref, dtype)
        with pytest.raises(ValueError, match="128-channel"):
            k2.conv3x3_bn_gelu(*args, _tile_n=256)
    with pytest.raises(ValueError, match="channels_last"):
        k2.conv3x3_bn_gelu(x.contiguous(), *args[1:])


@pytest.mark.parametrize("dtype,cin,cout", [(torch.float32, 6, 8), (torch.float32, 8, 12),
                                            (torch.bfloat16, 12, 8)])
def test_conv3x3_shape_rule(dev, dtype, cin, cout):
    """The 16-byte chunks and TMA rows need Cin % 4 (fp32) or % 8 (bf16) and
    Cout % 8: the wrapper raises on anything else, launching nothing."""
    x = _cl(torch.randn(1, cin, 5, 5, device=dev).to(dtype))
    ones = torch.ones(cout, device=dev)
    k2.conv3x3_bn_gelu.launches = 0
    with pytest.raises(ValueError, match="multiple"):
        k2.conv3x3_bn_gelu(x, torch.randn(cout, cin, 3, 3, device=dev), None, ones, ones,
                           ones, ones)
    assert k2.conv3x3_bn_gelu.launches == 0


def _close_rel(got, ref, dtype):
    """Gradients are far below 1 in magnitude: hold them relative to their
    own scale, max|plain| (fp32: sums in another order; bf16: one bf16 ulp,
    covering the output rounding and P, dS rounded to bf16 for the products)."""
    bound = TOL[dtype] * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("nq,nk", [(128, 128), (64, 192), (4096, 4096), (192, 192),
                                   (192, 320), (320, 64), (1024, 448)])
def test_flash_attention_kernels(dev, dtype, d, nq, nk):
    """The forward at BH = 2 against the plain version (out, lse), then
    autograd through ``flash_attention`` against the plain version's: N % 128
    = 64 (the last query block half full), N_q != N_k, D 64 and 128.  fp32
    (the 3xTF32 forward) also: q and k scaled by 1.5, where one TF32 product
    would miss the tolerance (tests/test_torch_flash_f32.py), out and lse
    within TOL[float32] of a float64 attention, two calls the same bits."""
    f32 = dtype == torch.float32
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(1, 2, n, d, device=dev, generator=g) * s
               for n, s in ((nq, 1.5 if f32 else 1.0), (nk, 1.5 if f32 else 1.0), (nk, 1.0)))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    cot = torch.randn(1, 2, nq, d, device=dev, generator=g).to(dtype)
    fa.flash_attention.launches = fa.flash_attention.launches_dq = 0
    fa.flash_attention.launches_dkv = 0
    heads = (q.view(2, nq, d), k.view(2, nk, d), v.view(2, nk, d))
    out, lse = fa.flash_forward(*heads, d ** -0.5)
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v)
    _close(out.view_as(q), ref_out, dtype)
    _close(lse.view(1, 2, nq), ref_lse, dtype)
    if f32:
        again = fa.flash_forward(*heads, d ** -0.5)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        s64 = torch.einsum("bqd,bkd->bqk", heads[0].double(), heads[1].double()) * d ** -0.5
        lse64 = torch.logsumexp(s64, -1)
        _close(out, torch.exp(s64 - lse64[..., None]) @ heads[2].double(), dtype)
        _close(lse, lse64, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (fa.flash_attention(*leaves).float() * cot.float()).sum().backward()
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (fa.flash_attention_ref(*ref_leaves)[0].float() * cot.float()).sum().backward()
    for a, b in zip(leaves, ref_leaves):
        _close_rel(a.grad, b.grad, dtype)
    assert (fa.flash_attention.launches, fa.flash_attention.launches_dq,
            fa.flash_attention.launches_dkv) == (3 if f32 else 2, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("nq,nk", [(192, 192), (192, 320), (320, 64), (1024, 448),
                                   (4096, 4096)])
def test_flash_backward_kernels(dev, dtype, d, nq, nk):
    """The dQ and dK/dV kernels under autograd through ``flash_attention`` at
    BH = 3: N % 128 = 64 (a bf16 block's last 128 rows half full, TMA reading
    zeros past N instead of the next head's rows), N_q != N_k, D 64 and 128;
    two backward calls give the same bits (no atomics), one launch of each
    kernel per backward.  fp32 (the 3xTF32 kernels): q and k scaled by 1.5,
    where one TF32 product would miss the tolerance
    (tests/test_torch_flash_f32.py)."""
    f32 = dtype == torch.float32
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(1, 3, n, d, device=dev, generator=g) * s
               for n, s in ((nq, 1.5 if f32 else 1.0), (nk, 1.5 if f32 else 1.0), (nk, 1.0)))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    cot = torch.randn(1, 3, nq, d, device=dev, generator=g).to(dtype)
    fa.flash_attention.launches = fa.flash_attention.launches_dq = 0
    fa.flash_attention.launches_dkv = 0
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fa.flash_attention(*leaves).float() * cot.float()).sum().backward()
        grads.append([t.grad for t in leaves])
    assert (fa.flash_attention.launches, fa.flash_attention.launches_dq,
            fa.flash_attention.launches_dkv) == (2, 2, 2)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (fa.flash_attention_ref(*ref_leaves)[0].float() * cot.float()).sum().backward()
    for a, b, again in zip(grads[0], ref_leaves, grads[1]):
        _close_rel(a, b.grad, dtype)
        assert torch.equal(a, again)


def test_flash_attention_wrapper_raises(dev):
    q = torch.randn(1, 2, 128, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiple of 64"):
        r = torch.randn(1, 2, 100, 64, device=dev)
        fa.flash_attention(r, r, r)
    with pytest.raises(ValueError, match="D in"):
        r = torch.randn(1, 2, 128, 32, device=dev)
        fa.flash_attention(r, r, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("flags", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("shape", [(3, 37, 29, 13), (2, 64, 64, 14),
                                   (8, 256, 256, 13)])  # the served batch
def test_dwi_normalize_kernel(dev, dtype, flags, shape):
    g = torch.Generator(device=dev).manual_seed(3)
    img = (torch.rand(shape, device=dev, generator=g) * 2000.0 + 10.0).to(dtype)
    dwi_norm.dwi_normalize.launches = 0
    out = dwi_norm.dwi_normalize(img, skip_last=flags[0], zero_last=flags[1])
    ref = dwi_norm.dwi_normalize_ref(img, skip_last=flags[0], zero_last=flags[1])
    assert out.dtype == dtype and out.shape == img.shape
    # outputs in [0, 1]: fp32 1e-6 (a ddof=0 std is off by far more at these
    # pixel counts), bf16 and fp16 one ulp
    tol = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}[dtype]
    assert (out[..., :-1].float() - ref[..., :-1].float()).abs().max().item() <= tol
    if flags[0]:  # the last channel kept or zeroed, exactly
        assert torch.equal(out[..., -1], ref[..., -1])
    assert dwi_norm.dwi_normalize.launches == 1
    # a second call gives the same bits: the statistics' sum order is fixed
    assert torch.equal(out, dwi_norm.dwi_normalize(img, skip_last=flags[0], zero_last=flags[1]))


def _hist_rows(dev, g, p, kind):
    """(g, p) fp32 rows for kernel 8: ``rand`` cubed, or 60 % of each row set
    to the background value 0 (``crowded``), every value equal
    (``constant``: span clamped to 1e-12), one element past a 16-byte
    boundary (``unaligned``), or values on bin edges and one ulp either side
    (``edges``)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    if kind == "edges":
        e = torch.arange(4097, device=dev, dtype=torch.float32) / 4096.0
        e = torch.cat([e, torch.nextafter(e, e + 1), torch.nextafter(e, e - 1)]).clamp(0, 1)
        e = e * 0.964 + 0.013  # a span that is no power of two
        idx = torch.randint(0, e.numel(), (g, p), device=dev, generator=gen)
        flat = e[idx]
        flat[:, 0], flat[:, 1] = 0.013, 0.977
        return flat
    if kind == "constant":
        return torch.full((g, p), 0.3, device=dev)
    buf = torch.rand(g * p + 1, device=dev, generator=gen) ** 3
    flat = buf[1:].view(g, p) if kind == "unaligned" else buf[: g * p].view(g, p)
    if kind == "unaligned":
        assert flat.is_contiguous() and flat.data_ptr() % 16
    if kind == "crowded":
        flat[torch.rand(g, p, device=dev, generator=gen) < 0.6] = 0.0
    return flat


@pytest.mark.parametrize("g,p,kind", [
    (5, 10007, "rand"), (3, 65536, "rand"),
    (1, 2, "rand"), (48, 2, "rand"), (4096, 2, "rand"),
    (1, 3, "rand"), (48, 3, "rand"), (4096, 3, "rand"),
    (1, 10007, "rand"), (48, 10007, "rand"), (4096, 10007, "rand"),
    (1, 65539, "rand"), (48, 65539, "rand"), (4096, 65539, "rand"),
    (1, 2 ** 20, "rand"), (48, 2 ** 20, "rand"),   # slices past the shared-memory budget
    (48, 65536, "crowded"), (4, 2 ** 20, "crowded"),
    (3, 1000, "constant"), (48, 65539, "constant"),
    (5, 4099, "unaligned"), (3, 65536, "edges")])
def test_histogram_percentiles_kernel(dev, g, p, kind):
    flat = _hist_rows(dev, g, p, kind)
    percents = (0, 1, 10, 25, 30, 40, 50, 60, 75, 80, 90, 99, 100)
    histogram.histogram_percentiles.launches = 0
    out = histogram.histogram_percentiles(flat, percents)
    ref = histogram.histogram_percentiles_ref(flat, percents)
    span = (flat.max(1).values - flat.min(1).values).clamp(min=1e-12)[:, None]
    # the same bins and in-bin interpolation (exact counts): within 1e-6 * span
    assert ((out - ref).abs() / span).max().item() <= 1e-6
    assert histogram.histogram_percentiles.launches == 1
    # a second call gives the same bits: counts are exact in any order
    assert torch.equal(out, histogram.histogram_percentiles(flat, percents))
    if p >= 64 * 64:
        img = flat[:, : 64 * 64].reshape(-1, 64, 64, 1).expand(-1, -1, -1, 2).contiguous()
        scale = torch.linspace(0.0, 1.0, len(percents), device=dev)
        got = histogram.nyul_transform_hist(img, percents, scale)
        assert torch.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,side", [
    (6, 40), (14, 33), (128, 16),
    (14, 256), (6, 256),   # the modality attention's maps at 256^2
    (200, 9),              # C not a multiple of the vector, a flat period of 25 or 50
    (1002, 5)])            # a period past 256 threads: scalar loads, 1002 threads
def test_se_scale_kernel(dev, dtype, c, side):
    g = torch.Generator(device=dev).manual_seed(5)
    mid = max(c // 2, 1)
    x = _cl(torch.randn(4, c, side, side, device=dev, generator=g).to(dtype))
    w1 = torch.randn(mid, c, 1, 1, device=dev, generator=g) * c ** -0.5
    w2 = torch.randn(c, mid, 1, 1, device=dev, generator=g) * mid ** -0.5
    b1 = torch.randn(mid, device=dev, generator=g) * 0.1
    b2 = torch.randn(c, device=dev, generator=g) * 0.1
    se.se_scale.launches = 0
    out, s = se.se_scale(x, w1, b1, w2, b2)
    ref_out, ref_s = se.se_scale_ref(x, w1, b1, w2, b2)
    assert out.is_contiguous(memory_format=torch.channels_last) and s.shape == (4, c, 1, 1)
    assert s.dtype == dtype
    _close(out, ref_out, dtype)
    _close(s, ref_s, dtype)
    assert se.se_scale.launches == 1
    # a second call gives the same bits: the pool's sum order is fixed
    again = se.se_scale(x, w1, b1, w2, b2)
    assert torch.equal(out, again[0]) and torch.equal(s, again[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_inputs_take_scalar_loads(dev, dtype):
    """Maps and images one element past a 16-byte boundary: both kernels
    plan vector width 1 and still match their plain versions."""
    from dmf_tpu_torch.ops import dwi_norm_cuda, se_cuda

    g = torch.Generator(device=dev).manual_seed(7)
    n, side, c = 2, 48, 14
    buf = torch.randn(n * side * side * c + 1, device=dev, generator=g).to(dtype)
    x = buf[1:].view(n, side, side, c).permute(0, 3, 1, 2)  # channels_last, unaligned
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16
    assert se_cuda.plan(n, side * side, c, x.element_size(), False, 132)[0] == 1
    w1 = torch.randn(7, c, device=dev, generator=g) * c ** -0.5
    w2 = torch.randn(c, 7, device=dev, generator=g) * 7 ** -0.5
    b1, b2 = torch.zeros(7, device=dev), torch.zeros(c, device=dev)
    out, s = se.se_scale(x, w1, b1, w2, b2)
    ref_out, ref_s = se.se_scale_ref(x, w1, b1, w2, b2)
    _close(out, ref_out, dtype)
    _close(s, ref_s, dtype)
    img = buf[1:].view(n, side, side, c).abs() * 500.0 + 10.0  # an aligned copy
    img = buf.clone()[1:].view_as(img).copy_(img)               # unaligned again
    assert img.is_contiguous() and img.data_ptr() % 16
    assert dwi_norm_cuda.plan(side * side, c, img.element_size(), False)[0] == 1
    got = dwi_norm.dwi_normalize(img)
    ref = dwi_norm.dwi_normalize_ref(img)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_no_triton_imported(dev):
    """Kernels 6 and 7 are CUDA C++: a fresh interpreter that runs both
    wrappers on the card has not imported triton."""
    import subprocess
    import sys

    code = ("import sys, torch\n"
            "from dmf_tpu_torch.ops import dwi_norm, se\n"
            "x = torch.rand(2, 14, 8, 8, device='cuda').contiguous("
            "memory_format=torch.channels_last)\n"
            "w1, w2 = torch.rand(7, 14, device='cuda'), torch.rand(14, 7, device='cuda')\n"
            "se.se_scale(x, w1, torch.zeros(7, device='cuda'), w2, "
            "torch.zeros(14, device='cuda'))\n"
            "dwi_norm.dwi_normalize(torch.rand(2, 8, 8, 13, device='cuda'))\n"
            "torch.cuda.synchronize()\n"
            "assert se.se_scale.launches == 1 and dwi_norm.dwi_normalize.launches == 1\n"
            "assert 'triton' not in sys.modules, 'triton imported'\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=600)


def test_new_wrappers_raise(dev):
    img = torch.rand(2, 8, 8, 13, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        dwi_norm.dwi_normalize(img.transpose(1, 2))
    with pytest.raises(ValueError, match="device"):
        dwi_norm.dwi_normalize(img.to("meta"))
    flat = torch.rand(4, 100, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        histogram.histogram_percentiles(flat.t().contiguous().t(), (50,))
    with pytest.raises(ValueError, match="fp32"):
        histogram.histogram_percentiles(flat.half(), (50,))
    x = torch.rand(2, 14, 8, 8, device=dev)
    w1, w2 = torch.rand(7, 14, 1, 1, device=dev), torch.rand(14, 7, 1, 1, device=dev)
    b1, b2 = torch.zeros(7, device=dev), torch.zeros(14, device=dev)
    with pytest.raises(ValueError, match="channels_last"):
        se.se_scale(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="device"):
        se.se_scale(_cl(x), w1.cpu(), b1, w2, b2)
    # no backward: a call autograd would record raises, on both SE kernels
    w1g = w1.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        se.se_scale(_cl(x), w1g, b1, w2, b2)
    y = _cl(torch.rand(2, 14, 8, 8, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        k1.se_epilogue(y, y, w1g, b1, w2, b2)
    with torch.no_grad():
        assert se.se_scale(_cl(x), w1g, b1, w2, b2)[0].shape == x.shape


def test_train_route_launches_no_kernel(dev):
    """The single-modality train step at toy size on the card: its batch
    preparation launches kernel 7 once, the step none of kernels 1, 2 and 6
    (the ``train=True`` route); the eval step takes the served route (3 SE
    epilogues, 6 neck convs, the modality SE); and the eval route under
    autograd raises instead of dropping the gradient."""
    import dataclasses

    from dmf_tpu_torch import default_parameters, resolve_backbone_config
    from dmf_tpu_torch.data.modality import ModalityProcessor
    from dmf_tpu_torch.losses import get_classification_loss_fn, get_mask_loss_fn
    from dmf_tpu_torch.pipeline import build_single_model
    from dmf_tpu_torch.train.optim import SingleModelOptController, build_group_spec
    from dmf_tpu_torch.train.single import make_single_eval_step, make_single_train_step
    from dmf_tpu_torch.train.state import TrainState

    cfg = default_parameters(foundation_model_unfreeze_timer=0)
    cfg = cfg.replace(dwi_model=resolve_backbone_config(dataclasses.replace(
        cfg.dwi_model, input_size=32, channels=(8, 16, 32), proj_dim=8)))
    model, cfg = build_single_model(cfg, "dwi", device=dev, backbone_layers=(1, 1, 1, 1))
    g = torch.Generator(device=dev).manual_seed(0)
    proc = ModalityProcessor(cfg, "dwi", adc_map=torch.full((32, 32, 1), 0.5, device=dev),
                             device=dev)
    counters = (k1.se_epilogue, k2.conv3x3_bn_gelu, se.se_scale, dwi_norm.dwi_normalize)
    for f in counters:
        f.launches = 0
    batch = {"imgs": proc.train_batch(g, torch.rand(4, 32, 32, 13, device=dev) * 1000),
             "masks": (torch.rand(4, 32, 32, 1, device=dev) > 0.8).float(),
             "labels": torch.arange(4, device=dev), "aux_w": 1.0}
    assert [f.launches for f in counters] == [0, 0, 0, 1]
    clf = get_classification_loss_fn(cfg, [0, 1, 2, 3], "dwi")
    spec = build_group_spec([n for n, _ in model.named_parameters()], True)
    ctrl = SingleModelOptController(cfg, "dwi")
    ctrl.on_epoch_start(0)
    state = TrainState.create(model)
    metrics = make_single_train_step(cfg, "dwi", clf, get_mask_loss_fn(cfg, "dwi"), spec)(
        state, batch, g, ctrl.hyperparams())
    assert torch.isfinite(metrics["loss"]) and metrics["grad_nonfinite"].item() == 0
    assert [f.launches for f in counters] == [0, 0, 0, 1]
    make_single_eval_step(cfg, "dwi", clf, get_mask_loss_fn(cfg, "dwi"))(state, batch)
    assert [f.launches for f in counters] == [3, 6, 1, 1]
    with pytest.raises(RuntimeError, match="no backward"):
        model(batch["imgs"].permute(0, 3, 1, 2))


def _toy_cfg(remat=False):
    import dataclasses

    from dmf_tpu_torch import default_parameters

    cfg = default_parameters(batch_size=4)
    mc = dataclasses.replace(cfg.dwi_model, input_size=32, channels=(8, 16, 32), proj_dim=8,
                             use_backbone=False, dropout=0.2, remat=remat)
    return cfg.replace(dwi_model=mc, debug_training=False)


def _deterministic(fn):
    """``fn()`` with cuDNN's and torch's deterministic algorithms (warn-only);
    the flags restored."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = old


def test_remat_train_step_on_card(dev):
    """Two train steps at toy width with remat on and off from the same
    weights, batches and generator seed, deterministic algorithms: the
    losses, parameters, BatchNorm statistics and the dropout generator's
    state bit-equal."""
    from dmf_tpu_torch.losses import get_classification_loss_fn, get_mask_loss_fn
    from dmf_tpu_torch.pipeline import build_single_model
    from dmf_tpu_torch.train.optim import SingleModelOptController, build_group_spec
    from dmf_tpu_torch.train.single import make_single_train_step
    from dmf_tpu_torch.train.state import TrainState

    g = torch.Generator(device=dev).manual_seed(1)
    batches = [{"imgs": torch.rand(4, 32, 32, 14, device=dev, generator=g),
                "masks": (torch.rand(4, 32, 32, 1, device=dev, generator=g) > 0.7).float(),
                "labels": torch.arange(4, device=dev), "aux_w": 1.0} for _ in range(2)]

    def run(remat):
        cfg = _toy_cfg(remat)
        model, cfg = build_single_model(cfg, "dwi", device=dev)
        state = TrainState.create(model)
        spec = build_group_spec([n for n, _ in model.named_parameters()], False)
        step = make_single_train_step(cfg, "dwi", get_classification_loss_fn(
            cfg, [0, 1, 2, 3], "dwi"), get_mask_loss_fn(cfg, "dwi"), spec)
        ctrl = SingleModelOptController(cfg, "dwi")
        ctrl.on_epoch_start(0)
        drop = torch.Generator(device=dev).manual_seed(2)
        losses = [step(state, b, drop, ctrl.hyperparams())["loss"] for b in batches]
        return torch.stack(losses), model.state_dict(), drop.get_state()

    (l0, s0, g0), (l1, s1, g1) = (_deterministic(lambda r=r: run(r)) for r in (False, True))
    assert torch.equal(l1, l0)
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k
    assert torch.equal(g0, g1)


def test_multifold_epoch_on_card(dev, tmp_path):
    """One epoch of K=2 folds through ``fit_single_multifold`` at toy width
    against ``fit_single`` per fold, deterministic algorithms: the histories
    (wall times aside) and the final parameters bit-equal, the train steps
    timed per fold by CUDA events, and the validation and the epoch-0 mask
    triptych on the served route (kernels 1 and 6 launched)."""
    import copy

    import numpy as np

    from dmf_tpu_torch.pipeline import build_single_model
    from dmf_tpu_torch.train import SingleModelOptController, TrainState, fit_single
    from dmf_tpu_torch.train.multifold_loop import fit_single_multifold

    class Noisy:
        def train_batch(self, generator, imgs, adc=None):
            x = torch.as_tensor(imgs, device=dev)
            return x + (torch.rand(x.shape, device=dev, generator=generator) - 0.5) * 0.1

        def eval_split(self, imgs, adc=None):
            return np.asarray(imgs)

    r = np.random.RandomState(0)
    folds = [{name: {"imgs": r.rand(n, 32, 32, 14).astype(np.float32),
                     "masks": (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32),
                     "labels": np.arange(n) % 4} for name, n in (("train", nt), ("val", 6))}
             for nt in (10, 14)]
    cfg = _toy_cfg()
    model, cfg = build_single_model(cfg, "dwi", device=dev)

    def seq():
        return [fit_single(cfg, "dwi", TrainState.create(copy.deepcopy(model)), f["train"],
                           f["val"], Noisy(), SingleModelOptController(cfg, "dwi"),
                           str(tmp_path / f"seq{i}"), num_epochs=1, seed=0)
                for i, f in enumerate(folds)]

    def par():
        return fit_single_multifold(
            cfg, "dwi", [TrainState.create(copy.deepcopy(model)) for _ in folds],
            [f["train"] for f in folds], [f["val"] for f in folds], [Noisy(), Noisy()],
            [SingleModelOptController(cfg, "dwi") for _ in folds],
            [str(tmp_path / f"par{i}") for i in range(2)], num_epochs=1, seed=0)

    ours, theirs = _deterministic(par), _deterministic(seq)
    k1.se_epilogue.launches = se.se_scale.launches = 0
    for o, t in zip(ours, theirs):
        assert len(o.step_ms) == len(t.step_ms) == o.state.step
        untimed = [{k: v for k, v in r.history[0].items() if not k.endswith("_time")}
                   for r in (o, t)]
        assert untimed[0] == untimed[1]
        so, st = o.state.model.state_dict(), t.state.model.state_dict()
        assert all(torch.equal(so[k], st[k]) for k in st)
    assert [o.state.step for o in ours] == [3, 4]
    _deterministic(par)
    # per fold: 2 validation batches and the triptych's forward of one sample
    assert k1.se_epilogue.launches == 2 * 3 * 3 and se.se_scale.launches == 2 * 3


def test_serving_artifact_on_card(dev, tmp_path):
    """The fusion serving program exported on the card (toy widths, a
    (1, 1, 1, 1) ResNet-50, fp32, ``tta_mc``), saved and reloaded: one
    request launches each kernel operator as often as the graph holds its
    node; the same seed gives the same bits, another seed other numbers; and
    the request agrees with the CPU export of the same weights and seed
    (the same dropout masks) within 1e-4."""
    import copy
    import dataclasses

    from dmf_tpu_torch import default_parameters, resolve_backbone_config
    from dmf_tpu_torch.models import build_fusion_models
    from dmf_tpu_torch.ops import library
    from dmf_tpu_torch.serving import (export_program, export_serving, load_serving,
                                       make_serving_fn, operator_nodes, serving_variables)

    cfg = default_parameters(mc_passes=3)
    mc = resolve_backbone_config(dataclasses.replace(
        cfg.dwi_model, input_size=32, channels=(8, 16, 32), proj_dim=8, dropout=0.3))
    fs = dataclasses.replace(cfg.fusion_model.fusion_specific, fusion_channels=16,
                             dwi_out_channels=32, dce_out_channels=32)
    cfg = cfg.replace(dwi_model=mc, dce_model=mc,
                      fusion_model=dataclasses.replace(mc, fusion_specific=fs))
    cpu = build_fusion_models(cfg, "cpu", torch.float32, torch.Generator().manual_seed(0),
                              backbone_layers=(1, 1, 1, 1))
    card = [copy.deepcopy(m).to(dev).to(memory_format=torch.channels_last) for m in cpu]
    g = torch.Generator().manual_seed(1)
    xd = torch.rand(2, 32, 32, cfg.dwi_channel_num, generator=g)
    xc = torch.rand(2, 32, 32, cfg.dce_channel_num, generator=g)

    def args(models, device, seed=5):
        return (serving_variables(*models), xd.to(device), xc.to(device),
                torch.tensor(seed, dtype=torch.int64, device=device))

    fn = make_serving_fn(cfg, *card, mode="tta_mc")
    nodes = operator_nodes(export_program(fn, args(card, dev)))
    assert nodes == dict.fromkeys(library.OPERATORS, 0) | {
        "se_epilogue": 12, "keep_mask": 12, "conv3x3_bn_gelu": 12, "se_scale": 4}
    path = str(tmp_path / "tta_mc.pt2")
    export_serving(fn, args(card, dev), path=path)
    served = load_serving(path)
    library.reset_launch_counts()
    mean, std = served(*args(card, dev))
    torch.cuda.synchronize()
    assert library.launch_counts() == nodes
    again = served(*args(card, dev))
    assert torch.equal(mean, again[0]) and torch.equal(std, again[1])
    assert not torch.equal(mean, served(*args(card, dev, seed=6))[0])
    assert torch.isfinite(mean).all() and (std > 0).all()
    on_cpu = load_serving(export_serving(make_serving_fn(cfg, *cpu, mode="tta_mc"),
                                         args(cpu, "cpu")))(*args(cpu, "cpu"))
    for got, ref in zip((mean, std), on_cpu):
        assert (got.cpu() - ref).abs().max().item() <= 1e-4
