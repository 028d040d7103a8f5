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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 24, 5, 3), (6, 1002, 2, 3), (6, 5, 7)])
def test_pass_words_match_the_plain_masks(dev, dtype, shape):
    """With pass words: kernel 1's dropout and its keep-mask kernel give the
    plain version's bits for 3 passes from pass 2^31 - 1 (a per-pass count
    that is not a multiple of 4 among them), each pass the bits it draws
    alone, and kernel 1 the plain epilogue on those masks."""
    from dmf_tpu_torch.ops import dropout, epilogue_cuda

    seed = torch.tensor([(0x5EED << 32) | 3], device=dev)
    x = torch.randn(*shape, device=dev).to(dtype)
    x = _cl(x) if x.dim() == 4 else x
    first, base = 2 ** 31 - 1, 2 ** 32 - 8
    keep = epilogue_cuda.keep_mask(x, 0.3, seed, base, first, 3)
    ref = dropout.keep_mask_plain(x.shape, 0.3, seed.cpu(), base, first, 3)
    assert torch.equal(keep.cpu(), ref)
    for p in range(3):
        one = epilogue_cuda.keep_mask(x[2 * p:2 * p + 2], 0.3, seed, base, first + p)
        assert torch.equal(one, keep[2 * p:2 * p + 2])
    if x.dim() == 4:
        c = x.shape[1]
        idn = _cl(torch.randn(*shape, device=dev).to(dtype))
        w = (torch.randn(c // 2, c, device=dev) * c ** -0.5, torch.zeros(c // 2, device=dev),
             torch.randn(c, c // 2, device=dev) * c ** -0.5, torch.zeros(c, device=dev))
        stream = dropout.SeedStream(seed, counter=base, first_pass=first, passes=3)
        out = k1.se_epilogue(x, idn, *w, drop_rate=0.3, generator=stream)
        _close(out, k1.se_epilogue_ref(x, idn, *w, drop_rate=0.3, keep=keep), dtype)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n,rows,first,passes,base,local,h0", [
    (256, 2, 0, 1, 0, 4, 0), (192, 1, 3, 3, 2 ** 32 - 6, 4, 0), (320, 2, 7, 2, 1000, 2, 2),
    (1024, 1, 0, 2, 4, 2, 0)])
def test_flash_dropout_kernels(dev, dtype, d, n, rows, first, passes, base, local, h0):
    """The forward's dropout variant against its plain version on the card
    (on the operands in fp32: in bf16 the plain version is the weights
    route, which rounds the logits to bf16, where the kernel keeps S in
    fp32): N % 128 = 64 (a half-full query block and key tile), several
    pass words, counter bases past 2^32 and not a multiple of 4, a head
    shard (``h0 = 2`` of 4 heads); two calls the same bits, one launch a
    call through the operator."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(rows * passes, local, n, d, device=dev, generator=g).to(dtype)
               for _ in range(3))
    seed = torch.tensor([(0x5EED << 32) | 3], device=dev)
    args = (d ** -0.5, 0.1, seed, base, first, passes, 4, h0)
    fa.flash_attention_dropout.launches = 0
    out, lse = torch.ops.dmf.flash_forward_dropout(q, k, v, *args)
    assert fa.flash_attention_dropout.launches == 1
    again = fa.launch_flash_forward_dropout(q, k, v, *args, fa.dropout_group(4, h0, local, base))
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    _close(out, fa.flash_attention_dropout_ref(q.float(), k.float(), v.float(), *args), dtype)
    _close(lse, fa.attention_lse(q, k, d ** -0.5), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dropout_keep_bits(dev, dtype):
    """q = 0 (uniform P) and V one-hot over keys w .. w + 127: out != 0 is
    the kernel's mask of that window, bit-equal to the keep-mask kernel's
    mask of the whole (B, H, N, N) weights, heads h0 .. of a shard."""
    from dmf_tpu_torch.ops import epilogue_cuda

    n, d, passes, first, base, h0 = 512, 128, 2, 1, 2 ** 33 + 2, 2
    seed = torch.tensor([77], device=dev)
    q = torch.zeros(2 * passes, 2, n, d, device=dev, dtype=dtype)
    keep = epilogue_cuda.keep_mask(q.new_empty(()).expand(2 * passes, 4, n, n), 0.1, seed,
                                   base, first, passes)
    for w in (0, n - d):
        v = torch.zeros_like(q)
        v[:, :, w:w + d] = torch.eye(d, device=dev, dtype=dtype)
        out = fa.launch_flash_forward_dropout(q, q, v, d ** -0.5, 0.1, seed, base, first,
                                              passes, 4, h0, fa.dropout_group(4, h0, 2, base))[0]
        assert torch.equal(out != 0, keep[:, h0:h0 + 2, :, w:w + d])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("heads,local,h0,rows,first,passes,base", [
    (4, 4, 0, 2, 0, 1, 0), (4, 4, 0, 1, 5, 2, 2 ** 33 + 4), (4, 2, 2, 2, 3, 1, 1000),
    (4, 2, 0, 1, 0, 3, 8), (8, 8, 0, 1, 1, 2, 16), (8, 4, 4, 2, 0, 1, 4)])
def test_flash_dropout_head_shared_is_per_element(dev, dtype, d, heads, local, h0, rows, first,
                                                  passes, base):
    """The head-shared instance (one Philox call for G = 4 heads, or 2 on a
    2-way shard) bit-equal to the per-element instance on the same inputs
    and counter base and to the operator's route, and within tolerance of
    the plain version, on a ragged N_q (192: a half-full query block) and N_k
    (320: a half-full bf16 key tile)."""
    group = fa.dropout_group(heads, h0, local, base)
    assert group in (2, 4)
    g = torch.Generator(device=dev).manual_seed(7)
    b = rows * passes
    q = torch.randn(b, local, 192, d, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(b, local, 320, d, device=dev, generator=g).to(dtype) for _ in range(2))
    seed = torch.tensor([(0x5EED << 32) | 11], device=dev)
    args = (d ** -0.5, 0.1, seed, base, first, passes, heads, h0)
    shared = fa.launch_flash_forward_dropout(q, k, v, *args, group)
    for other in (fa.launch_flash_forward_dropout(q, k, v, *args, 1),
                  torch.ops.dmf.flash_forward_dropout(q, k, v, *args)):
        assert all(torch.equal(a, b) for a, b in zip(shared, other))
    _close(shared[0], fa.flash_attention_dropout_ref(q.float(), k.float(), v.float(), *args),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dropout_head_shared_slabs(dev, dtype, monkeypatch):
    """The head-shared instance over rows b in slabs (its keep bits' scratch
    capped at two rows here: slabs of 2, 2 and 1 of 5 rows, a pass each)
    bit-equal to the per-element instance."""
    d, n, passes = 64, 192, 5
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(passes, 4, n, d, device=dev, generator=g).to(dtype)
               for _ in range(3))
    seed = torch.tensor([(0x5EED << 32) | 13], device=dev)
    args = (d ** -0.5, 0.1, seed, 8, 2, passes, 4, 0)
    monkeypatch.setattr(fa, "DROP_BITS_BYTES",
                        8 * fa.dropout_bits_words(dtype, d, 4, n, n))
    shared = fa.launch_flash_forward_dropout(q, k, v, *args, 4)
    assert all(torch.equal(a, b)
               for a, b in zip(shared, fa.launch_flash_forward_dropout(q, k, v, *args, 1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("local,h0,base", [(4, 0, 0), (4, 0, 2 ** 33 + 4), (2, 2, 1000),
                                          (2, 0, 12)])
def test_flash_dropout_head_shared_keep_bits(dev, dtype, local, h0, base):
    """q = 0 and V one-hot over keys w .. w + 127 (phase 3i(b)'s windows):
    the head-shared instance's mask, ``out != 0``, bit-equal to the
    keep-mask kernel's mask of the whole (B, 4, N, N) weights, heads h0 .."""
    from dmf_tpu_torch.ops import epilogue_cuda

    n, d, passes, first = 512, 128, 2, 1
    assert fa.dropout_group(4, h0, local, base) == (4 if local == 4 else 2)
    seed = torch.tensor([78], device=dev)
    q = torch.zeros(2 * passes, local, n, d, device=dev, dtype=dtype)
    keep = epilogue_cuda.keep_mask(q.new_empty(()).expand(2 * passes, 4, n, n), 0.1, seed,
                                   base, first, passes)
    for w in (0, n - d):
        v = torch.zeros_like(q)
        v[:, :, w:w + d] = torch.eye(d, device=dev, dtype=dtype)
        out = fa.launch_flash_forward_dropout(q, q, v, d ** -0.5, 0.1, seed, base, first,
                                              passes, 4, h0,
                                              fa.dropout_group(4, h0, local, base))[0]
        assert torch.equal(out != 0, keep[:, h0:h0 + local, :, w:w + d])


def test_flash_dropout_launches_by_instance(dev):
    """The operator counts each launch in ``launches`` and in its instance's
    count: the served shape (4 heads, base % 4 == 0) the head-shared one, a
    base = 2 mod 4 the per-element one; a group the shape does not allow
    raises."""
    from dmf_tpu_torch.ops import library

    q = torch.randn(2, 4, 128, 64, device=dev)
    seed = torch.tensor([1], device=dev)
    fn = fa.flash_attention_dropout
    library.reset_launch_counts()
    torch.ops.dmf.flash_forward_dropout(q, q, q, 0.125, 0.1, seed, 8, 0, 1, 4, 0)
    torch.ops.dmf.flash_forward_dropout(q, q, q, 0.125, 0.1, seed, 8, 0, 1, 4, 0)
    torch.ops.dmf.flash_forward_dropout(q, q, q, 0.125, 0.1, seed, 6, 0, 1, 4, 0)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_shared, fn.launches_each) == (3, 2, 1)
    library.reset_launch_counts()
    assert (fn.launches, fn.launches_shared, fn.launches_each) == (0, 0, 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.launch_flash_forward_dropout(q, q, q, 0.125, 0.1, seed, 6, 0, 1, 4, 0, 4)


def test_flash_dropout_route_raises(dev):
    """A CUDA call the fused route takes launches or raises: non-contiguous
    operands, an fp16 or unaligned one, p outside (0, 1), a CPU seed; a call
    that autograd records takes the differentiable route (no raise)."""
    q = torch.randn(2, 2, 128, 64, device=dev)
    seed = torch.tensor([1], device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.launch_flash_forward_dropout(q.transpose(2, 3).contiguous().transpose(2, 3), q, q,
                                        0.125, 0.1, seed, 0, 0, 1, 2, 0, 1)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.launch_flash_forward_dropout(q.half(), q.half(), q.half(), 0.125, 0.1, seed, 0, 0, 1,
                                        2, 0, 1)
    with pytest.raises(ValueError, match="multiple of 64"):
        r = torch.randn(2, 2, 100, 64, device=dev)
        fa.launch_flash_forward_dropout(r, r, r, 0.125, 0.1, seed, 0, 0, 1, 2, 0, 1)
    with pytest.raises(ValueError, match="outside"):
        fa.launch_flash_forward_dropout(q, q, q, 0.125, 1.0, seed, 0, 0, 1, 2, 0, 1)
    with pytest.raises(ValueError, match="seed"):
        fa.launch_flash_forward_dropout(q, q, q, 0.125, 0.1, seed.cpu(), 0, 0, 1, 2, 0, 1)
    leaf = q.clone().requires_grad_()
    out = fa.flash_attention_dropout(leaf, q, q, 0.1, dropout_stream(seed))
    assert "FlashAttentionDropout" in type(out.grad_fn).__name__
    with pytest.raises(ValueError, match="lse"):
        fa.launch_flash_bwd_dq_dropout(q, q, q, q, torch.zeros(2, 2, 64, device=dev),
                                       torch.zeros(2, 2, 128, device=dev), 0.125, 0.1, seed, 0, 0,
                                       1, 2, 0, 1)


def dropout_stream(seed):
    from dmf_tpu_torch.ops.dropout import SeedStream

    return SeedStream(seed)


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


# ------------------------------------------------------- the int8 serving path
# (Cin, Cout, kernel, stride, padding, dilation, side, N): the served shape
# classes (1x1, the strided downsample, 3x3 at strides 1 and 2, dilations 2
# and 4, the 7x7 stems at Cin 14 and 6, resnet50d's deep-stem 3x3, the ViT
# patch conv), each channel tile (Cout up to 64, 128, above), Cout tails of
# each tile (40, 96, 160), C % 16 != 0 off the stems (24, and 3, odd), and
# output pixels that leave a ragged last tile
INT8_CONVS = [
    (64, 256, 1, 1, 0, 1, 17, 3), (256, 512, 1, 2, 0, 1, 18, 2), (64, 64, 3, 1, 1, 1, 15, 2),
    (128, 128, 3, 2, 1, 1, 17, 2), (256, 256, 3, 1, 2, 2, 12, 2), (512, 512, 3, 1, 4, 4, 10, 1),
    (14, 64, 7, 2, 3, 1, 35, 2), (6, 64, 7, 2, 3, 1, 33, 2), (32, 32, 3, 1, 1, 1, 20, 2),
    (14, 768, 16, 16, 0, 1, 48, 2), (512, 2048, 1, 1, 0, 1, 9, 2), (48, 40, 3, 1, 1, 1, 9, 3),
    (64, 96, 3, 1, 1, 1, 11, 2), (128, 160, 1, 1, 0, 1, 13, 3), (24, 48, 3, 2, 1, 1, 19, 2),
    (3, 40, 3, 1, 1, 1, 10, 2),
]


def _int8_inputs(dev, cin, cout, k, side, n, g):
    xq = torch.randint(-127, 128, (n, cin, side, side), device=dev, generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, k, k, cin), device=dev, generator=g, dtype=torch.int8)
    ws = torch.rand(cout, device=dev, generator=g) * 1e-3 + 1e-5
    return _cl(xq), wq, ws


@pytest.mark.parametrize("shape", INT8_CONVS)
def test_int8_conv_kernel(dev, shape):
    """int32 accumulators and the dequantized fp32 / bf16 outputs (with and
    without bias) bit-equal to the plain version, two calls bit-equal; the
    shapes reach every channel tile, each with the cp.async and the byte
    gather."""
    from dmf_tpu_torch.ops import quant, quant_cuda

    cin, cout, k, s, p, d, side, n = shape
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    xq, wq, ws = _int8_inputs(dev, cin, cout, k, side, n, g)
    xs = torch.tensor(0.0137, device=dev)
    bias = torch.randn(cout, device=dev, generator=g)
    geo = ((s, s), (p, p), (d, d))
    ref = quant.int8_conv_ref(xq, wq, ws, xs, None, *geo, torch.int32)
    got = quant_cuda.launch_int8_conv(xq, wq, ws, xs, None, *geo, torch.int32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ref)
    assert torch.equal(quant_cuda.launch_int8_conv(xq, wq, ws, xs, None, *geo, torch.int32), got)
    for dtype, b in ((torch.float32, bias), (torch.bfloat16, None), (torch.bfloat16, bias)):
        ref = quant.int8_conv_ref(xq, wq, ws, xs, b, *geo, dtype)
        with torch.no_grad():
            got = quant.int8_conv(xq, wq, ws, xs, b, *geo, dtype)
        assert got.dtype == dtype and torch.equal(got, ref), dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cl,offset", [((3, 14, 37, 29), True, 0), ((2, 64, 16, 16), False, 0),
                                            ((4099,), False, 1), ((2, 256, 64, 64), True, 0)])
def test_int8_quantize_kernels(dev, dtype, shape, cl, offset):
    """The static (reciprocal) quantize and its division form bit-equal to
    the plain version: ragged sizes, an unaligned start (scalar loads),
    channels_last."""
    from dmf_tpu_torch.ops import quant, quant_cuda

    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.randn(offset + int(torch.tensor(shape).prod()), device=dev, generator=g)
         * 3).to(dtype)[offset:].reshape(shape)
    if cl:
        x = _cl(x)
    scale = quant.dynamic_quantize_ref(x)[1]
    for divide, sc in ((True, scale), (False, scale * 0.7)):  # 0.7: the clamp too
        got = quant_cuda.launch_quantize(x, sc, divide)
        ref = quant.quantize_ref(x, sc, divide)
        assert got.stride() == x.stride() and torch.equal(got, ref), divide
        assert got.abs().max() <= 127


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cl,offset", [
    ((1,), False, 0), ((17,), False, 0), ((4097,), False, 0),  # the tail, one unit
    ((4097,), False, 1), ((2, 64, 16, 16), False, 1),  # unaligned: element by element
    ((3, 14, 37, 29), True, 0), ((2, 64, 16, 16), False, 0),
    ((32, 256, 64, 64), True, 0),  # a tta_mc request's 64^2 conv input
    ((8, 256, 128, 128), True, 0)])  # past the 50 MB L2 (67 MB bf16, 134 MB fp32)
def test_int8_dynamic_quantize_kernel(dev, dtype, shape, cl, offset):
    """The dynamic quantize (abs-max, scale, quantize in one launch) bit-equal
    to its plain version in codes and scale, and across two calls."""
    from dmf_tpu_torch.ops import quant, quant_cuda

    g = torch.Generator(device=dev).manual_seed(6)
    n = int(torch.tensor(shape).prod())
    x = (torch.randn(offset + n, device=dev, generator=g) * 3).to(dtype)[offset:].reshape(shape)
    if cl:
        x = _cl(x)
    got, scale = quant_cuda.launch_dynamic_quantize(x)
    ref, ref_scale = quant.dynamic_quantize_ref(x)
    assert got.stride() == x.stride() and got.dtype == torch.int8
    assert torch.equal(scale, ref_scale) and torch.equal(got, ref)
    again, scale2 = quant_cuda.launch_dynamic_quantize(x)
    assert torch.equal(again, got) and torch.equal(scale2, scale)
    if n > 1:
        assert got.abs().max() == 127


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("at", [0, 4096, 2 * 63 * 33 * 33 - 1])
def test_int8_dynamic_quantize_nan(dev, dtype, at):
    """A NaN anywhere (a vector's first element, a block's span, the tail)
    gives a NaN scale, as the plain version's and JAX's max do; the codes
    as the plain version's."""
    from dmf_tpu_torch.ops import quant, quant_cuda

    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(2, 63, 33, 33, device=dev, generator=g).to(dtype)  # n % 16 == 14
    x.view(-1)[at] = float("nan")
    got, scale = quant_cuda.launch_dynamic_quantize(x)
    ref, ref_scale = quant.dynamic_quantize_ref(x)
    assert torch.isnan(scale) and torch.isnan(ref_scale)
    assert torch.equal(got, ref)


def test_int8_dynamic_quantize_is_one_kernel(dev):
    """One ``_dynamic_quantize`` call runs one CUDA kernel, the dynamic
    quantize, and no memset or scalar kernel."""
    from torch.profiler import ProfilerActivity, profile

    from dmf_tpu_torch.ops import quant

    x = _cl(torch.randn(8, 256, 32, 32, device=dev).to(torch.bfloat16))
    quant._dynamic_quantize(x)
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session at times records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            quant._dynamic_quantize(x)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        if names:
            break
    assert len(names) == 1 and "dynamic_quantize_kernel" in names[0], names


def test_int8_wrappers_raise(dev):
    """A CUDA tensor the kernels cannot take raises; nothing falls back."""
    from dmf_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(1)
    xq, wq, ws = _int8_inputs(dev, 16, 32, 3, 8, 2, g)
    xs = torch.tensor(0.01, device=dev)
    geo = ((1, 1), (1, 1), (1, 1))
    with pytest.raises(ValueError, match="channels_last"):
        quant.int8_conv(xq.contiguous(), wq, ws, xs, None, *geo, torch.float32)
    with pytest.raises(ValueError, match="input channels"):
        quant.int8_conv(xq, wq[..., :8].contiguous(), ws, xs, None, *geo, torch.float32)
    with pytest.raises(ValueError, match="x_scale"):
        quant.int8_conv(xq, wq, ws, None, None, *geo, torch.float32)
    with pytest.raises(ValueError, match="device"):
        quant.int8_conv(xq, wq.cpu(), ws, xs, None, *geo, torch.float32)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        quant.quantize(torch.rand(8, device=dev, dtype=torch.float64), xs)
    with pytest.raises(ValueError, match="scale"):
        quant.quantize(torch.rand(8, device=dev), xs.cpu())
    with pytest.raises(RuntimeError, match="no backward"):
        quant.int8_conv(xq, wq, ws, xs, torch.zeros(32, device=dev, requires_grad=True),
                        *geo, torch.float32)


def test_int8_copy_launches_the_int8_kernels(dev):
    """A quantized toy encoder's prefix on the card: one int8 conv and one
    quantize a quantized conv (static scales), no kernel 2 at the necks, and
    its logits against the same copy on the CPU."""
    import dataclasses

    from dmf_tpu_torch import default_parameters, resolve_backbone_config
    from dmf_tpu_torch.models import Encoder
    from dmf_tpu_torch.models.build import init_weights
    from dmf_tpu_torch.ops import quant

    cfg = default_parameters()
    mc = resolve_backbone_config(dataclasses.replace(
        cfg.dwi_model, input_size=32, channels=(32, 32, 64), proj_dim=8, dropout=0.0))
    enc = Encoder("dwi", mc, 14, 4, backbone_layers=(1, 1, 1, 1))
    init_weights(enc, torch.Generator().manual_seed(0))
    x = torch.rand(2, 14, 32, 32, generator=torch.Generator().manual_seed(1))
    qset = quant.build_quant_set(enc)
    quant.calibrate_act_scales(enc, qset, x)
    cpu = quant.quantized_copy(enc, qset)
    card = quant.quantized_copy(enc, qset).to(dev).to(memory_format=torch.channels_last)
    calls = []
    for m in card.modules():
        if isinstance(m, quant.QuantConv2d):
            assert m.weight_q.is_contiguous()
            m.register_forward_pre_hook(lambda *a: calls.append(1))
    for f in (quant.int8_conv, quant.quantize, quant.dynamic_quantize, k2.conv3x3_bn_gelu):
        f.launches = 0
    with torch.no_grad():
        got = card(_cl(x.to(dev)))[0]
        ref = cpu(x)[0]
    torch.cuda.synchronize()
    assert quant.int8_conv.launches == quant.quantize.launches == len(calls) > 20
    assert quant.dynamic_quantize.launches == 0 and k2.conv3x3_bn_gelu.launches == 0
    assert (got.cpu() - ref).abs().max() <= 1e-2 * max(1.0, ref.abs().max().item())


def _bwd_reference(q, k, v, dout, args):
    """The plain forward on fp32 operands, its lse and delta, and the plain
    backward: ``(lse, delta, (dq, dk, dv))``, fp32."""
    q, k, v, dout = (t.float() for t in (q, k, v, dout))
    lse = fa.attention_lse(q, k, args[0])
    delta = fa.backward_delta(fa.flash_attention_dropout_ref(q, k, v, *args), dout)
    dq = fa.flash_bwd_dq_dropout_ref(q, k, v, dout, lse, delta, *args)
    return lse, delta, (dq, *fa.flash_bwd_dkv_dropout_ref(q, k, v, dout, lse, delta, *args))


def _close_rel(got, ref, dtype):
    """Within TOL of max|plain| (gradients far below 1 in magnitude)."""
    bound = TOL[dtype] * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("heads,local,h0,rows,first,passes,base", [
    (4, 4, 0, 2, 0, 1, 0), (4, 2, 2, 1, 3, 2, 2 ** 33 + 4), (4, 4, 0, 1, 1, 2, 6),
    (2, 2, 0, 2, 0, 1, 8)])
def test_flash_dropout_backward_kernels(dev, dtype, d, heads, local, h0, rows, first, passes,
                                        base):
    """The dQ and dK/dV kernels' dropout instances against their plain
    versions (on fp32 operands, the same lse and delta) at N_q = 192 and N_k
    = 320 (a half-full block or tile on each side), G = 4, a 2-way shard (G =
    2), a base = 2 mod 4 and 2 heads (G = 1, one Philox call a weight in the
    pre-pass); two calls the same bits, and the head-shared pre-pass the
    same bits as the per-weight one."""
    g = torch.Generator(device=dev).manual_seed(17)
    b = rows * passes
    q, dout = (torch.randn(b, local, 192, d, device=dev, generator=g).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(b, local, 320, d, device=dev, generator=g).to(dtype) for _ in range(2))
    seed = torch.tensor([(0x5EED << 32) | 19], device=dev)
    args = (d ** -0.5, 0.1, seed, base, first, passes, heads, h0)
    lse, delta, ref = _bwd_reference(q, k, v, dout, args)
    group = fa.dropout_group(heads, h0, local, base)

    def kernels(grp):
        return (fa.launch_flash_bwd_dq_dropout(q, k, v, dout, lse, delta, *args, grp),
                *fa.launch_flash_bwd_dkv_dropout(q, k, v, dout, lse, delta, *args, grp))

    got = kernels(group)
    for a, r in zip(got, ref):
        _close_rel(a, r, dtype)
    for other in (kernels(group), kernels(1)):
        assert all(torch.equal(a, b_) for a, b_ in zip(got, other))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dropout_backward_slabs(dev, dtype, monkeypatch):
    """The backward's pre-pass over rows b in slabs (its bits' scratch capped
    at two rows: slabs of 2, 2 and 1 of 5) bit-equal to one slab."""
    d, n, passes = 64, 192, 5
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v, dout = (torch.randn(passes, 4, n, d, device=dev, generator=g).to(dtype)
                     for _ in range(4))
    seed = torch.tensor([(0x5EED << 32) | 23], device=dev)
    args = (d ** -0.5, 0.1, seed, 8, 2, passes, 4, 0)
    lse, delta, _ = _bwd_reference(q, k, v, dout, args)

    def kernels():
        return (fa.launch_flash_bwd_dq_dropout(q, k, v, dout, lse, delta, *args, 4),
                *fa.launch_flash_bwd_dkv_dropout(q, k, v, dout, lse, delta, *args, 4))

    whole = kernels()
    monkeypatch.setattr(fa, "DROP_BITS_BYTES", 8 * fa.dropout_bits_words(dtype, d, 4, n, n))
    assert all(torch.equal(a, b) for a, b in zip(whole, kernels()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_dropout_autograd(dev, dtype):
    """``flash_attention_dropout`` under autograd on the card: one forward,
    one dQ and one dK/dV launch of the dropout instances, the gradients
    within tolerance of the plain backward on fp32 operands."""
    from dmf_tpu_torch.ops import library

    g = torch.Generator(device=dev).manual_seed(25)
    q, k, v, dout = (torch.randn(2, 4, 512, 128, device=dev, generator=g).to(dtype)
                     for _ in range(4))
    seed = torch.tensor([(0x5EED << 32) | 27], device=dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    library.reset_launch_counts()
    out = fa.flash_attention_dropout(*leaves, 0.1, dropout_stream(seed))
    grads = torch.autograd.grad(out, leaves, dout)
    fn = fa.flash_attention_dropout
    assert (fn.launches, fn.launches_dq, fn.launches_dkv) == (1, 1, 1)
    _, _, ref = _bwd_reference(q, k, v, dout, (128 ** -0.5, 0.1, seed, 0, 0, 1, 4, 0))
    for a, r in zip(grads, ref):
        _close_rel(a, r, dtype)
