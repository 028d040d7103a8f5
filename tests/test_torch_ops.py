"""Port ops vs the JAX package: resize, attention and the two kernels' plain versions.

The kernels' plain versions are held against the Pallas kernels run as the
JAX tests run them on the CPU (``interpret=True``).  The interpreter stubs
the TPU's random bits to zeros, which the kernel reads as keep-everything, so
with dropout its output is exactly ``undropped / (1 - p)``: the port's plain
version is fed an all-ones ``keep`` mask for that check.  On CPU tensors the
wrappers run the plain versions and never count a launch.  The fp32 conv
kernel's 3xTF32 arithmetic is replayed in plain torch and held against the
JAX kernel at ``neck_f3_conv0``'s K.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch.nn.functional as F
from test_torch_helpers import RTOL, assert_close, nchw, nhwc

from dmf_tpu.ops import attention as jattn
from dmf_tpu.ops import resize as jresize
from dmf_tpu.ops.conv3x3_pallas import conv3x3_bn_gelu as jax_conv3x3
from dmf_tpu.ops.epilogue_pallas import se_epilogue as jax_se_epilogue
from dmf_tpu_torch.ops import attention, resize
from dmf_tpu_torch.ops.conv3x3 import (conv3x3_bn_gelu, conv3x3_bn_gelu_ref, conv_weights,
                                       fold_bn, rna_tf32)
from dmf_tpu_torch.ops.epilogue import se_epilogue, se_epilogue_ref

# fp32 kernel parity, the JAX kernel tests' own tolerance (2e-5)
KERNEL_RTOL = 2e-5


class TestResize:
    @pytest.mark.parametrize("src,dst", [((8, 8), (32, 32)), ((4, 4), (32, 32)),
                                         ((32, 32), (8, 8)), ((12, 10), (7, 9))])
    def test_bilinear(self, src, dst):
        x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
        ref = jresize.resize_bilinear(jnp.asarray(x), dst)
        assert_close(nhwc(resize.resize_bilinear(nchw(x), dst)), ref, rtol=1e-5)

    @pytest.mark.parametrize("src,dst", [((32, 32), (8, 8)),    # divisible
                                         ((32, 32), (64, 64)),  # projector upsample
                                         ((10, 12), (4, 5))])   # general windows
    def test_adaptive_avg_pool(self, src, dst):
        x = np.random.RandomState(1).randn(2, *src, 3).astype(np.float32)
        ref = jresize.adaptive_avg_pool(jnp.asarray(x), dst)
        assert_close(nhwc(resize.adaptive_avg_pool(nchw(x), dst)), ref, rtol=1e-5)

    @pytest.mark.parametrize("src,dst", [((32, 32), (64, 64)), ((16, 16), (64, 64)),
                                         ((8, 6), (16, 18))])
    @pytest.mark.parametrize("channels_last", [False, True])
    def test_adaptive_avg_pool_upsample_is_torch_pool(self, src, dst, channels_last):
        """An integer upsample takes the nearest route: torch's adaptive pool's
        values bit for bit, the memory format kept, and its gradient."""
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        x = torch.randn(2, 5, *src, generator=torch.Generator().manual_seed(4)).contiguous(
            memory_format=fmt).requires_grad_()
        got, ref = resize.adaptive_avg_pool(x, dst), F.adaptive_avg_pool2d(x, dst)
        assert torch.equal(got, ref)
        assert got.is_contiguous(memory_format=fmt)
        cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(5))
        g_got, = torch.autograd.grad(got, x, cot)
        g_ref, = torch.autograd.grad(ref, x, cot)
        torch.testing.assert_close(g_got, g_ref, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("src,dst", [((32, 32), (4, 4)),   # the fusion head's token pool
                                         ((32, 32), (8, 8)), ((12, 10), (4, 5))])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("channels_last", [False, True])
    def test_adaptive_avg_pool_downsample_is_torch_pool(self, src, dst, dtype, channels_last):
        """An integer downsample takes ``avg_pool2d``: torch's adaptive pool's
        values bit for bit, the memory format kept, and its gradient."""
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        x = torch.randn(3, 8, *src, generator=torch.Generator().manual_seed(6)).to(
            dtype).contiguous(memory_format=fmt).requires_grad_()
        got, ref = resize.adaptive_avg_pool(x, dst), F.adaptive_avg_pool2d(x, dst)
        assert torch.equal(got, ref)
        assert got.is_contiguous(memory_format=fmt)
        cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(7)).to(dtype)
        g_got, = torch.autograd.grad(got, x, cot)
        g_ref, = torch.autograd.grad(ref, x, cot)
        assert torch.equal(g_got, g_ref)

    def test_global_avg_pool(self):
        x = np.random.RandomState(2).randn(2, 5, 6, 3).astype(np.float32)
        assert_close(resize.global_avg_pool(nchw(x)),
                     jresize.global_avg_pool(jnp.asarray(x)), rtol=1e-5)


def test_attention_returns_weights():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 4, 16, 8).astype(np.float32) for _ in range(3))
    out, w = attention.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        return_weights=True)
    jout, jw = jattn._xla_attention(q, k, v, 8 ** -0.5)
    assert_close(out, jout, rtol=1e-5)
    assert_close(w, jw, rtol=1e-5)
    assert attention.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).shape == out.shape


@pytest.fixture
def epi():
    rng = np.random.RandomState(0)
    B, H, W, C, mid = 4, 8, 8, 128, 64
    return dict(
        x=rng.randn(B, H, W, C).astype(np.float32),
        idn=rng.randn(B, H, W, C).astype(np.float32),
        w1=(rng.randn(C, mid) * 0.05).astype(np.float32),
        b1=(rng.randn(mid) * 0.01).astype(np.float32),
        w2=(rng.randn(mid, C) * 0.05).astype(np.float32),
        b2=(rng.randn(C) * 0.01).astype(np.float32),
    )


def _port_epi_args(s):
    # port SE weights are the reference 1x1 convs: (out, in)
    return (nchw(s["x"]), nchw(s["idn"]), torch.from_numpy(s["w1"].T.copy()),
            torch.from_numpy(s["b1"]), torch.from_numpy(s["w2"].T.copy()),
            torch.from_numpy(s["b2"]))


class TestEpiloguePlain:
    def test_matches_pallas_interpret(self, epi):
        ref = jax_se_epilogue(*(jnp.asarray(epi[k]) for k in
                                ("x", "idn", "w1", "b1", "w2", "b2")), interpret=True)
        out = se_epilogue_ref(*_port_epi_args(epi))
        assert_close(nhwc(out), ref, rtol=KERNEL_RTOL)

    def test_dropout_all_keep_matches_interpret_stub(self, epi):
        p = 0.4
        ref = jax_se_epilogue(*(jnp.asarray(epi[k]) for k in
                                ("x", "idn", "w1", "b1", "w2", "b2")),
                              drop_rate=p, rng=jax.random.PRNGKey(3), interpret=True)
        args = _port_epi_args(epi)
        keep = torch.ones(args[0].shape, dtype=torch.bool)
        out = se_epilogue_ref(*args, drop_rate=p, keep=keep)
        assert_close(nhwc(out), ref, rtol=KERNEL_RTOL)

    def test_wrapper_on_cpu_is_plain_and_uncounted(self, epi):
        args = _port_epi_args(epi)
        se_epilogue.launches = 0
        assert torch.equal(se_epilogue(*args), se_epilogue_ref(*args))
        g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
        assert torch.equal(se_epilogue(*args, drop_rate=0.3, generator=g1),
                           se_epilogue_ref(*args, drop_rate=0.3, generator=g2))
        assert se_epilogue.launches == 0

    def test_dropout_mask_statistics(self, epi):
        """Kept fraction within 5 binomial sigmas of 1-p; dropped entries are
        exact zeros."""
        p = 0.2
        args = _port_epi_args(epi)
        out = se_epilogue(*args, drop_rate=p, generator=torch.Generator().manual_seed(1))
        n = out.numel()
        kept = float((out != 0).float().mean())
        assert abs(kept - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)

    def test_dropout_needs_generator(self, epi):
        with pytest.raises(ValueError, match="generator"):
            se_epilogue(*_port_epi_args(epi), drop_rate=0.2)


@pytest.fixture
def conv():
    rng = np.random.RandomState(0)
    B, H, W, Cin, Cout = 2, 8, 8, 128, 128
    return dict(
        x=rng.randn(B, H, W, Cin).astype(np.float32) * 0.5,
        k=rng.randn(3, 3, Cin, Cout).astype(np.float32) * 0.05,
        b=rng.randn(Cout).astype(np.float32) * 0.01,
        g=rng.rand(Cout).astype(np.float32) + 0.5,
        beta=rng.randn(Cout).astype(np.float32) * 0.01,
        mu=rng.randn(Cout).astype(np.float32) * 0.01,
        var=rng.rand(Cout).astype(np.float32) + 0.5,
    )


def _port_conv_args(s):
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    return (nchw(s["x"]), t["k"].permute(3, 2, 0, 1).contiguous(), t["b"], t["g"],
            t["beta"], t["mu"], t["var"])


class TestConv3x3Plain:
    # the shapes tests/test_conv3x3_pallas.py runs: B=2 (whole-batch tile),
    # B=8 (the layout-matched variant) and B=3 (odd tail)
    @pytest.mark.parametrize("batch", [2, 8, 3])
    def test_matches_pallas_interpret(self, conv, batch):
        s = dict(conv, x=np.concatenate([conv["x"]] * 4 + [conv["x"] * 0.25])[:batch])
        ref = jax_conv3x3(*(jnp.asarray(s[k]) for k in
                            ("x", "k", "b", "g", "beta", "mu", "var")), interpret=True)
        out = conv3x3_bn_gelu_ref(*_port_conv_args(s))
        assert_close(nhwc(out), ref, rtol=KERNEL_RTOL)

    def test_wrapper_on_cpu_is_plain_and_uncounted(self, conv):
        args = _port_conv_args(conv)
        conv3x3_bn_gelu.launches = 0
        assert torch.equal(conv3x3_bn_gelu(*args), conv3x3_bn_gelu_ref(*args))
        assert conv3x3_bn_gelu.launches == 0


    def test_cpu_route_carries_gradients(self, conv):
        """The other half of the kernel's no-backward contract: on the CPU the
        wrapper is the plain version, and autograd reaches the weights."""
        args = list(_port_conv_args(conv))
        args[1] = args[1].clone().requires_grad_()
        args[3] = args[3].clone().requires_grad_()
        conv3x3_bn_gelu(*args).square().sum().backward()
        ref = [a.detach().clone().requires_grad_() if i in (1, 3) else a
               for i, a in enumerate(args)]
        conv3x3_bn_gelu_ref(*ref).square().sum().backward()
        for i in (1, 3):
            assert args[i].grad is not None and args[i].grad.abs().max() > 0
            assert torch.equal(args[i].grad, ref[i].grad)


def _tf32x3_replay(x, weight, conv_bias, bn_weight, bn_bias, bn_mean, bn_var, eps=1e-5,
                   products=3):
    """The fp32 kernel's arithmetic (``conv3x3_bn_gelu_tf32x3``) in plain torch.

    Both operands split into ``hi = rna_tf32(a)`` and ``lo = rna_tf32(a - hi)``
    (the weights by ``conv_weights``, the pixels in the kernel); each product of
    two 11-bit significands is exact in fp32, so the three products ``hi*hi +
    hi*lo + lo*hi`` are fp32 convolutions of the split operands, summed in
    fp32; then the epilogue ``gelu(acc * s + t)``.  ``products=1`` replays one
    TF32 product (``hi*hi``), what a plain TF32 kernel would compute.
    """
    s, t = fold_bn(conv_bias, bn_weight, bn_bias, bn_mean, bn_var, eps)
    xh, wh = rna_tf32(x), rna_tf32(weight)
    xl, wl = rna_tf32(x - xh), rna_tf32(weight - wh)

    def conv(a, w):
        return F.conv2d(a, w, padding=1)

    acc = conv(xh, wh)
    if products == 3:
        acc = acc + conv(xh, wl) + conv(xl, wh)
    return F.gelu(acc * s[:, None, None] + t[:, None, None])


def test_tf32x3_replay_matches_pallas_interpret():
    """At ``neck_f3_conv0``'s K (Cin 3072 -> Cout 256, K = 27648) on an 8x8
    map, the 3xTF32 replay agrees with the JAX kernel within the port's fp32
    tolerance; one TF32 product does not come near it."""
    rng = np.random.RandomState(4)
    cin, cout = 3072, 256
    s = dict(x=rng.randn(1, 8, 8, cin).astype(np.float32),
             k=(rng.randn(3, 3, cin, cout) * (9 * cin) ** -0.5).astype(np.float32),
             b=rng.randn(cout).astype(np.float32) * 0.1,
             g=rng.rand(cout).astype(np.float32) + 0.5,
             beta=rng.randn(cout).astype(np.float32) * 0.1,
             mu=rng.randn(cout).astype(np.float32) * 0.1,
             var=rng.rand(cout).astype(np.float32) + 0.5)
    ref = np.asarray(jax_conv3x3(*(jnp.asarray(s[k]) for k in
                                   ("x", "k", "b", "g", "beta", "mu", "var")), interpret=True))
    scale = max(1.0, float(np.abs(ref).max()))
    errs = {p: float(np.abs(nhwc(_tf32x3_replay(*_port_conv_args(s), products=p)) - ref).max())
            / scale for p in (3, 1)}
    print(f"K = {9 * cin}: max error / max(1, max|ref|): 3xTF32 {errs[3]:.3e}, one TF32 "
          f"product {errs[1]:.3e} (tolerance {RTOL:.0e})")
    assert_close(nhwc(_tf32x3_replay(*_port_conv_args(s))), ref, rtol=RTOL)
    assert errs[1] > 10 * errs[3]


def test_rna_tf32_and_weight_halves():
    """``rna_tf32`` rounds to 10 mantissa bits, ties away from zero (where
    round-to-even would go down), low 13 bits zero; ``conv_weights`` in fp32
    gives halves on that grid whose sum is within 2^-22 relative of the
    weight matrix."""
    one = 1.0 + 2.0 ** -11  # a tie between 1 and 1 + 2^-10
    got = rna_tf32(torch.tensor([one, -one, one - 2.0 ** -23, 3.0, float("inf")]))
    assert got.tolist() == [1.0 + 2.0 ** -10, -1.0 - 2.0 ** -10, 1.0, 3.0, float("inf")]
    rng = np.random.RandomState(5)
    weight = torch.from_numpy(rng.randn(24, 16, 3, 3).astype(np.float32) * 0.1)
    stats = [torch.from_numpy(rng.rand(24).astype(np.float32) + 0.5) for _ in range(5)]
    hi, lo = conv_weights(weight, *stats, 1e-5, torch.float32)[:2]
    for half in (hi, lo):
        assert half.dtype == torch.float32
        assert not (half.view(torch.int32) & 0x1FFF).any()
    wmat = weight.permute(0, 2, 3, 1).reshape(24, 144).double()
    err = (hi.double() + lo.double() - wmat).abs()
    assert (err <= 2.0 ** -22 * wmat.abs()).all()
    assert (lo != 0).any() and ((hi.double() - wmat).abs() > err).any()


# Random123's known answers for Philox4x32-10 (kat_vectors): counter, key, output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    """The plain Philox4x32-10 that the card's keep bits are held against."""
    from dmf_tpu_torch.ops.epilogue_cuda import philox4x32

    assert philox4x32(ctr, key).tolist() == list(want)
    batch = philox4x32(np.array([ctr, ctr], dtype=np.uint32), key)
    assert batch.shape == (2, 4) and batch.tolist() == [list(want)] * 2


def test_keep_mask_ref_counter_is_64_bit():
    """Element e draws word e % 4 of Philox at counter (e/4 lo, e/4 hi, 0, 0)
    keyed on the seed's two words: bits past 2^31 and 2^32 are their own, a
    window is a slice of a longer one, and the keep rate is 1 - p."""
    from dmf_tpu_torch.ops.epilogue_cuda import draw_seed, keep_mask_ref, philox4x32

    p, seed = 0.2, (7 << 32) | 12345
    for base in (2 ** 31 - 6, 2 ** 32 - 6, 2 ** 40 + 1):
        got = keep_mask_ref(base, 12, p, seed)
        assert np.array_equal(got, keep_mask_ref(base - 4, 16, p, seed)[4:])
        for i in range(12):
            e = base + i
            word = philox4x32([e // 4 % 2 ** 32, e // 4 >> 32, 0, 0], (12345, 7))[e % 4]
            assert got[i] == (np.float32(word >> 8) * np.float32(2.0 ** -24)
                              < np.float32(1 - p))
    words = lambda b, s: philox4x32([b % 2 ** 32, b >> 32, 0, 0], (s % 2 ** 32, s >> 32))
    assert not np.array_equal(words(2 ** 32 + 5, seed), words(5, seed))  # the high word counts
    assert not np.array_equal(words(5, seed), words(5, 12345))           # so does the seed's
    n = 200_000
    frac = keep_mask_ref(2 ** 32 - n // 2, n, p, seed).mean()
    assert abs(frac - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    s = draw_seed(torch.Generator().manual_seed(0), "cpu")
    assert s.dtype == torch.int64 and s.shape == (1,) and 0 <= int(s) < 2 ** 63 - 1


@pytest.mark.parametrize("n,hw,c,esize", [
    (8, 128 * 128, 256, 2), (32, 128 * 128, 128, 2),    # hybrid-nb normal, tta
    (288, 32 * 32, 512, 2), (288, 32 * 32, 128, 4),     # tta_mc lean passes at B=8
    (4608, 32 * 32, 512, 2),                            # ... at B=128: 2.4e9 elements
    (6, 12 * 10, 200, 4), (1, 33 * 17, 200, 2),         # ragged: C=200, HW % P, N=1
    (2, 7 * 5, 1022, 4), (3, 9, 1002, 2)])              # scalar loads, 1024 threads
def test_epilogue_plan_fits_the_kernel(n, hw, c, esize):
    """The launch plan stays inside what ``se_epilogue_launch`` accepts and
    fills the card: a block's row sums fit its 2048-float buffer, at most
    1024 threads, 4 pixel blocks per SM wherever the map has the pixels,
    and an MLP block per SM until the samples outnumber MAX_GROUP x SMs."""
    from dmf_tpu_torch.ops.epilogue_cuda import BLOCKS_PER_SM, MAX_GROUP, plan

    sms = 132
    vec, p_blk, group = plan(n, hw, c, esize, True, sms)
    assert vec == (16 // esize if c % (16 // esize) == 0 else 1)
    assert plan(n, hw, c, esize, False, sms)[0] == 1
    groups = c // vec
    threads = 256 if groups <= 256 else -(-groups // 32) * 32
    rows = threads // groups
    assert threads <= 1024 and rows * c <= 2048
    assert min(rows, hw) <= p_blk <= hw
    blocks = n * -(-hw // p_blk)
    assert blocks < 2 ** 31
    assert blocks >= BLOCKS_PER_SM * sms or p_blk <= rows or p_blk == hw
    assert 1 <= group <= MAX_GROUP and group * sms >= min(n, MAX_GROUP * sms)


def _flat_walk_holds_channels(c, vec, threads, p_blk):
    """A block's flat walk as the kernels take it: element f of a tile goes
    to lane slot f mod (vec * threads); the slots' sums, added by channel
    slot mod C, give each channel's sum over the tile."""
    x = np.random.RandomState(c).rand(p_blk * c)
    slots = np.bincount(np.arange(x.size) % (vec * threads), weights=x,
                        minlength=vec * threads)
    by_channel = np.bincount(np.arange(slots.size) % c, weights=slots, minlength=c)
    np.testing.assert_allclose(by_channel, x.reshape(-1, c).sum(0), rtol=1e-12)


@pytest.mark.parametrize("n,hw,c,esize", [
    (32, 256 * 256, 14, 2), (32, 256 * 256, 6, 2),      # tta_mc B=8: modality attention
    (288, 32 * 32, 128, 2), (32, 32 * 32, 128, 2),      # ... fusion_se, lean and last pass
    (8, 256 * 256, 14, 4), (8, 256 * 256, 6, 4),        # hybrid-nb normal B=8, fp32
    (512, 256 * 256, 14, 2), (4608, 32 * 32, 128, 2),   # tta_mc B=128
    (256, 256 * 256, 13, 4), (4, 33 * 33, 13, 2),       # C=13; HW*C not a multiple of 8
    (3, 9, 200, 2), (2, 7 * 5, 1002, 4)])               # C=200 flat; C=1002 scalar, 1002 threads
def test_se_scale_plan_fits_the_kernel(n, hw, c, esize):
    """The launch plan stays inside what ``se_scale_launch`` accepts: the
    flat walk's ``vec * threads`` is a multiple of C (each lane keeps its
    channel), at most 256 threads where vectors are wider than 1 (1024 at
    most), the lane sums fit phase 1's 2048 floats, a block starts on a
    vector, blocks < 2^31, the MLP's shared memory fits, a block reads at
    most BLOCK_BYTES, BLOCKS_PER_SM blocks per SM wherever the map has the
    pixels; and the vector width falls to 1 on an unaligned map."""
    from math import gcd

    from dmf_tpu_torch.ops.epilogue_cuda import MAX_GROUP
    from dmf_tpu_torch.ops.se_cuda import BLOCK_BYTES, BLOCKS_PER_SM, plan

    sms = 132
    vec, threads, p_blk, group = plan(n, hw, c, esize, True, sms)
    full = 16 // esize
    assert vec == (full if (hw * c) % full == 0 and c // gcd(c, full) <= 256 else 1)
    assert plan(n, hw, c, esize, False, sms)[0] == 1
    assert (vec * threads) % c == 0 and vec * threads <= 2048
    assert threads <= (256 if vec > 1 else 1024)
    rows = vec * threads // c
    assert p_blk % rows == 0 and (p_blk * c) % vec == 0 and (hw * c) % vec == 0
    blocks = n * -(-hw // p_blk)
    assert blocks < 2 ** 31
    assert blocks >= BLOCKS_PER_SM * sms or p_blk == rows
    assert p_blk == rows or p_blk * c * esize <= BLOCK_BYTES
    # epi_mlp: 16-byte vectors where C allows, else 1; its dynamic shared memory
    mvec = vec if c % vec == 0 else 1
    slices = 256 // (c // mvec) if c // mvec < 256 else 1
    assert 1 <= group <= MAX_GROUP and group * ((1 + slices) * c + c // 2) * 4 <= 227 * 1024
    _flat_walk_holds_channels(c, vec, threads, min(p_blk, 4 * rows))


@pytest.mark.parametrize("n,hw,c,esize", [
    (8, 256 * 256, 13, 4), (8, 256 * 256, 13, 2),       # served B=8, fp32 and bf16
    (256, 256 * 256, 13, 4), (256, 256 * 256, 14, 2),   # fold preparation
    (4608, 256 * 256, 13, 2),                           # a large batch: blocks < 2^31
    (3, 37 * 29, 13, 4), (2, 64 * 64, 6, 4),            # ragged HW; C=6
    (2, 16 * 16, 128, 2), (5, 3, 1, 4)])                # C=128; C=1
def test_dwi_norm_plan_fits_the_kernel(n, hw, c, esize):
    """The launch plan stays inside what ``dwi_norm_launch`` accepts: the
    flat walk's ``vec * threads`` is a multiple of C, at most 256 threads, a
    tile is exactly ITEMS vectors a thread (``p_blk * C = ITEMS * vec *
    threads``), the lane sums fit the 2048-float buffer (with the 2 x 128
    statistics, under 48 KB of static shared memory), blocks < 2^31; and the
    vector width falls to 1 on unaligned images or where HW * C is not a
    multiple of it."""
    from dmf_tpu_torch.ops.dwi_norm_cuda import ITEMS, plan

    vec, threads, p_blk = plan(hw, c, esize, True)
    full = 16 // esize
    assert vec == (full if (hw * c) % full == 0 else 1)
    assert plan(hw, c, esize, False)[0] == 1
    assert (vec * threads) % c == 0 and threads <= 256
    assert p_blk * c == ITEMS * vec * threads
    assert (2048 + 2 * 128) * 4 <= 48 * 1024 and vec * threads <= 2048
    assert n * -(-hw // p_blk) < 2 ** 31
    _flat_walk_holds_channels(c, vec, threads, p_blk)


def test_build_digest_covers_shared_headers(tmp_path):
    """A library's build key takes every ``csrc/*.cuh`` beside its own
    sources, so an edit to a shared header rebuilds every library that
    includes it: both wgmma libraries (``hopper.cuh``) and both SE kernels,
    which run one MLP kernel (``se_mlp.cuh``)."""
    import shutil

    from dmf_tpu_torch.ops.cuda_build import CSRC_DIR, source_digest

    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC_DIR, csrc)
    for header_name, libs in (("hopper.cuh", ("flash_attention", "conv3x3_bn_gelu")),
                              ("se_mlp.cuh", ("se_epilogue", "se_scale"))):
        sources = {lib: (f"{lib}.cu",) for lib in libs}
        assert all(f'#include "{header_name}"' in (CSRC_DIR / src[0]).read_text()
                   for src in sources.values())
        before = {lib: source_digest(src, csrc) for lib, src in sources.items()}
        assert before == {lib: source_digest(src, CSRC_DIR) for lib, src in sources.items()}
        header = csrc / header_name
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        after = {lib: source_digest(src, csrc) for lib, src in sources.items()}
        assert all(after[lib] != before[lib] for lib in sources)
        shutil.copy(CSRC_DIR / header_name, header)
    sources = {"flash_attention": ("flash_attention.cu",)}
    key = source_digest(sources["flash_attention"], csrc)
    # a source of another library leaves the key alone; a new header does not
    hist = csrc / "histogram_percentiles.cu"
    hist.write_bytes(hist.read_bytes() + b"\n")
    assert source_digest(sources["flash_attention"], csrc) == key
    (csrc / "extra.cuh").write_text("// new\n")
    assert source_digest(sources["flash_attention"], csrc) != key
