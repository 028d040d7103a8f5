"""The port's DWI z-score, histogram-percentile and standalone-SE kernels'
plain versions vs the JAX package's Pallas kernels, in fp32 on the CPU.

The Pallas kernels run in interpret mode, as ``tests/test_pallas_kernels.py``
and ``tests/test_se_pallas.py`` run them.  On CPU tensors the wrappers take
the plain versions and never count a launch.
"""

import functools

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from test_torch_helpers import assert_close, nchw, nhwc, randomize

from dmf_tpu.data import preprocess as jpre
from dmf_tpu.models import layers as jl
from dmf_tpu.models.ref_ckpt import _Exporter, _to_host
from dmf_tpu.ops import histogram_pallas as jhist
from dmf_tpu.ops import preprocess_pallas as jdwi
from dmf_tpu.ops.se_pallas import se_scale as jax_se_scale
from dmf_tpu_torch.models.layers import SEBlock
from dmf_tpu_torch.models.weights import load_reference_state_dict
from dmf_tpu_torch.ops import dwi_norm, histogram, se

LANDMARKS = tuple(float(p) for p in jpre.DEFAULT_LANDMARKS)


def _interpret(fn, *args, **kw):
    """Run a jitted Pallas entry point in interpret mode (test_pallas_kernels.py:97-111)."""
    with jax.disable_jit():
        orig = jpl.pallas_call
        try:
            jpl.pallas_call = functools.partial(orig, interpret=True)
            return np.asarray(fn.__wrapped__(*args, **kw))
        finally:
            jpl.pallas_call = orig


# ------------------------------------------------------------ DWI z-score

@pytest.mark.parametrize("zero_last", [False, True])
def test_dwi_normalize_ref_matches_pallas_interpret(zero_last):
    imgs = np.random.RandomState(0).rand(3, 16, 16, 5).astype(np.float32) * 7
    ref = _interpret(jdwi.dwi_normalize_pallas, jnp.asarray(imgs), skip_last=True,
                     zero_last=zero_last)
    out = dwi_norm.dwi_normalize_ref(torch.from_numpy(imgs), skip_last=True,
                                     zero_last=zero_last)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_dwi_normalize_ref_large_intensities_match_xla():
    """Raw DWI runs into the thousands: the fp32 statistics still agree."""
    imgs = 1000.0 + 500.0 * np.random.RandomState(1).rand(2, 24, 20, 13).astype(np.float32)
    ref = jpre.dwi_normalize(jnp.asarray(imgs), skip_last=False)
    out = dwi_norm.dwi_normalize_ref(torch.from_numpy(imgs), skip_last=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_dwi_normalize_ref_rounds_once_to_input_dtype():
    imgs = torch.from_numpy(np.random.RandomState(2).rand(2, 8, 8, 4).astype(np.float32) * 50)
    out = dwi_norm.dwi_normalize_ref(imgs.bfloat16(), skip_last=True)
    assert out.dtype == torch.bfloat16
    full = dwi_norm.dwi_normalize_ref(imgs.bfloat16().float(), skip_last=True)
    assert torch.equal(out, full.bfloat16())


def test_dwi_normalize_wrapper_on_cpu_is_plain_and_uncounted():
    imgs = torch.from_numpy(np.random.RandomState(3).rand(2, 8, 8, 6).astype(np.float32))
    dwi_norm.dwi_normalize.launches = 0
    for flags in ((True, True), (True, False), (False, False)):
        assert torch.equal(dwi_norm.dwi_normalize(imgs, skip_last=flags[0], zero_last=flags[1]),
                           dwi_norm.dwi_normalize_ref(imgs, skip_last=flags[0],
                                                      zero_last=flags[1]))
    assert dwi_norm.dwi_normalize.launches == 0


# ------------------------------------------------------ histogram percentiles

def _dce_rows(g, p, seed=0):
    """Rows shaped like max-normalised DCE channels: a dark background mode
    and a bright tail."""
    rng = np.random.RandomState(seed)
    x = rng.rand(g, p).astype(np.float32) ** 3
    x[:, : p // 8] = 0.01 * rng.rand(g, p // 8)
    return x


def test_histogram_percentiles_ref_matches_pallas_interpret():
    flat = _dce_rows(2, 8192)
    ref = _interpret(jhist.histogram_percentiles_pallas, jnp.asarray(flat), LANDMARKS)
    out = histogram.histogram_percentiles_ref(torch.from_numpy(flat), LANDMARKS)
    span = (flat.max(1) - flat.min(1))[:, None]
    assert np.all(np.abs(out.numpy() - ref) <= 1e-6 * span)


@pytest.mark.parametrize("p", [40000, 65539])
def test_histogram_percentiles_ref_within_one_bin_of_exact(p):
    """Any P (the TPU kernel needed a multiple of 8192): on rows dense enough
    that neighbouring order statistics share a bin, within span / 4096 of
    ``np.percentile``."""
    flat = np.random.RandomState(p).rand(3, p).astype(np.float32)
    out = histogram.histogram_percentiles_ref(torch.from_numpy(flat), LANDMARKS).numpy()
    exact = np.percentile(flat.astype(np.float64), LANDMARKS, axis=1).T
    span = (flat.max(1) - flat.min(1))[:, None]
    assert np.all(np.abs(out - exact) <= span / histogram.NBINS + 1e-6)


def test_histogram_percentiles_ref_two_values():
    """P = 2, the smallest row: values stay inside [min, max], increasing."""
    flat = torch.tensor([[3.0, 1.0], [5.0, 5.0]])
    out = histogram.histogram_percentiles_ref(flat, LANDMARKS)
    assert torch.all((out[0] >= 1.0) & (out[0] <= 3.0)) and torch.all(out[1] == 5.0)
    assert torch.all(out[0, 1:] >= out[0, :-1])


def test_nyul_transform_hist_matches_pallas():
    img = _dce_rows(2 * 3, 128 * 64, seed=4).reshape(2, 3, 128, 64).transpose(0, 2, 3, 1)
    scale = np.linspace(0.0, 1.0, len(LANDMARKS)).astype(np.float32)
    with jax.disable_jit():
        orig = jpl.pallas_call
        try:
            jpl.pallas_call = functools.partial(orig, interpret=True)
            ref = np.asarray(jhist.nyul_transform_pallas(
                jnp.asarray(np.ascontiguousarray(img)), LANDMARKS, jnp.asarray(scale)))
        finally:
            jpl.pallas_call = orig
    out = histogram.nyul_transform_hist(torch.from_numpy(np.ascontiguousarray(img)),
                                        LANDMARKS, torch.from_numpy(scale))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    single = histogram.nyul_transform_hist(torch.from_numpy(np.ascontiguousarray(img[1])),
                                           LANDMARKS, scale)
    np.testing.assert_allclose(single.numpy(), ref[1], rtol=0, atol=1e-5)


def test_histogram_wrapper_on_cpu_is_plain_and_uncounted():
    flat = torch.from_numpy(_dce_rows(4, 300))
    histogram.histogram_percentiles.launches = 0
    assert torch.equal(histogram.histogram_percentiles(flat, LANDMARKS),
                       histogram.histogram_percentiles_ref(flat, LANDMARKS))
    assert histogram.histogram_percentiles.launches == 0


# The CUDA kernel (csrc/histogram_percentiles.cu) splits a row over a cluster
# of 8 blocks: block r bins the values [r S, r S + S), S = ceil(P / 8), owns
# bins [512 r, 512 r + 512), sums them over the 8 histograms, takes the count
# below them from the blocks' range sums, and reads out the percents whose bin
# it owns.  The replay below takes the same steps in plain torch on the CPU.
CLUSTER = 8
OWN = histogram.NBINS // CLUSTER
EDGE = 2.0 ** -9  # the kernel's kEdge


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _cluster_replay(flat, percents):
    G, P = flat.shape
    S = -(-P // CLUSTER)
    tgts = histogram._fractions(percents, "cpu") * (P - 1) + 1.0
    out = torch.empty((G, len(percents)), dtype=torch.float32)
    for g in range(G):
        slices = [flat[g, min(r * S, P):min(r * S + S, P)] for r in range(CLUSTER)]
        mn = torch.stack([s.min() if s.numel() else _f32(float("inf")) for s in slices]).min()
        mx = torch.stack([s.max() if s.numel() else _f32(float("-inf")) for s in slices]).max()
        span = (mx - mn).clamp(min=1e-12)
        hists = [torch.bincount(((s - mn) / span * histogram.NBINS).clamp(
            0, histogram.NBINS - 1).floor().long(), minlength=histogram.NBINS)
            for s in slices]
        range_sums = [h.view(CLUSTER, OWN).sum(1) for h in hists]
        for l, tgt in enumerate(tgts):
            owners = []
            for r in range(CLUSTER):
                own = sum(h[r * OWN:(r + 1) * OWN] for h in hists)  # rank order
                prefix = int(sum(rs[:r].sum() for rs in range_sums))
                cdf = prefix + own.cumsum(0)
                below, upto = _f32(float(prefix)), _f32(float(cdf[-1]))
                if not ((r == 0 or below < tgt) and (r == CLUSTER - 1 or not upto < tgt)):
                    continue
                owners.append(r)
                i = min(int((cdf.float() < tgt).sum()), OWN - 1)
                c_hi = cdf[i].float()
                c_lo = cdf[i - 1].float() if i > 0 else below
                frac = ((tgt - c_lo) / (c_hi - c_lo).clamp(min=1.0)).clamp(0.0, 1.0)
                out[g, l] = mn + (_f32(float(r * OWN + i)) + frac) / histogram.NBINS * span
            assert len(owners) == 1, (g, l, owners)  # one block writes each output
    return out


def _boundary_rows():
    """P = 101 on [0, 1]: 50 values below bin 400 and one in bin 511, so
    cdf[511] == 51 == tgt for p = 50 (the last bin of slice 0); one value in
    bin 512, so p = 51's bin opens slice 1 and its c_lo is slice 0's total;
    nothing in bins 513-2099 (slices 2 and 3 empty)."""
    rng = np.random.RandomState(11)
    row = np.concatenate([rng.uniform(0.0, 400.0 / 4096, 49), [511.5 / 4096, 512.5 / 4096],
                          rng.uniform(2100.0 / 4096, 1.0, 48), [1.0, 0.0]])
    return np.stack([rng.permutation(row), rng.permutation(row)]).astype(np.float32)


def _crowded_rows(g, p, seed=12):
    """60 % of each row at the background value 0: bin 0 holds them all."""
    x = _dce_rows(g, p, seed)
    x[np.random.RandomState(seed + 1).rand(g, p) < 0.6] = 0.0
    return x


CLUSTER_ROWS = {
    "boundary": (_boundary_rows, (0, 25, 50, 51, 52, 99, 100)),
    "crowded": (lambda: _crowded_rows(3, 4099), LANDMARKS),
    "two_values": (lambda: np.array([[3.0, 1.0], [5.0, 5.0]], np.float32), LANDMARKS),
    "five_values": (lambda: np.array([[2.0, 2.0, 2.0, 7.0, -1.0]], np.float32), LANDMARKS),
    "ragged": (lambda: _dce_rows(2, 8 * 517 + 3, seed=13), LANDMARKS),
    "constant": (lambda: np.full((2, 37), 0.25, np.float32), LANDMARKS),
}


@pytest.mark.parametrize("kind", sorted(CLUSTER_ROWS))
def test_cluster_replay_matches_ref(kind):
    """The kernel's slices, reduce-scatter, prefixes and owned readout give
    the plain version's bits: at targets on a slice's last bin, across a
    slice boundary, with empty bin slices (boundary), blocks without values
    (P = 2, 5), a crowded bin 0 and a span clamped to 1e-12 (constant)."""
    make, percents = CLUSTER_ROWS[kind]
    x = torch.from_numpy(make())
    ref = histogram.histogram_percentiles_ref(x, percents)
    if kind == "boundary":  # p = 50 reads bin 511 with frac 1: 512 / 4096
        assert ref[0, 2].item() == 0.125 and ref[0, 3].item() > 0.125
    if kind == "crowded":
        assert (x == 0).float().mean(1).min() > 0.55
    assert torch.equal(_cluster_replay(x, percents), ref)


def _bin_fast(x, mn, span):
    """The kernel's binning in numpy fp32 (``t_fast``, ``t_exact``,
    ``floor_bin``): (x - mn) times 4096 times the rounded reciprocal, the
    IEEE quotient where that lies within EDGE of an integer k >= 1."""
    d = (x - mn).astype(np.float32)
    t = d * ((np.float32(1.0) / span) * np.float32(4096))
    k = (t + np.float32(2 ** 23)) - np.float32(2 ** 23)  # the nearest integer
    near = (np.abs(t - k) < EDGE) & (k >= 1)
    t = np.where(near, (d / span) * np.float32(4096), t)
    return np.minimum(np.floor(t), 4095).astype(np.int64), d


@pytest.mark.parametrize("mn,mx,misses", [
    (0.0, 1.0, False), (0.013, 0.977, True), (-3.7, 1234.5, True),
    (1e-3, 1e-3 + 3e-9, False),  # a dozen floats in the range, none near an edge
    (10.0, 10.0 + 7.0 / 3.0, True)])
def test_reciprocal_binning_matches_division_at_bin_edges(mn, mx, misses):
    """Values at every bin edge mn + k span / 4096 and one ulp either side
    bin as floor((x - mn) / span * 4096) does; so do random values.  Where
    the reciprocal alone would bin some edge values otherwise (``misses``),
    the IEEE quotient takes them."""
    mn, mx = np.float32(mn), np.float32(mx)
    span = np.maximum(mx - mn, np.float32(1e-12))
    edges = (mn + np.arange(4097, dtype=np.float32) / np.float32(4096) * span).astype(np.float32)
    x = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                        np.nextafter(edges, np.float32(-np.inf)),
                        mn + np.random.RandomState(14).rand(100000).astype(np.float32) * span])
    x = np.clip(x, mn, mx).astype(np.float32)
    got, d = _bin_fast(x, mn, span)
    exact = np.floor(np.clip(d / span * np.float32(4096), 0, 4095)).astype(np.int64)
    np.testing.assert_array_equal(got, exact)
    naive = np.minimum(np.floor(d * ((np.float32(1.0) / span) * np.float32(4096))), 4095)
    assert (naive != exact).any() == misses


# ------------------------------------------------------------- standalone SE

def _se_inputs(c, seed=0):
    rng = np.random.RandomState(seed)
    mid = max(c // 2, 1)
    return (rng.randn(3, 9, 7, c).astype(np.float32),
            (rng.randn(c, mid) * 0.3).astype(np.float32), (rng.randn(mid) * 0.1).astype(np.float32),
            (rng.randn(mid, c) * 0.3).astype(np.float32), (rng.randn(c) * 0.1).astype(np.float32))


def _port_se_args(x, w1, b1, w2, b2):
    # the port's weights are the reference 1x1 convs: (out, in)
    return (nchw(x), torch.from_numpy(w1.T.copy()), torch.from_numpy(b1),
            torch.from_numpy(w2.T.copy()), torch.from_numpy(b2))


@pytest.mark.parametrize("c", [6, 14, 128])
def test_se_scale_ref_matches_pallas_interpret(c):
    args = _se_inputs(c)
    ref_out, ref_s = jax_se_scale(*(jnp.asarray(a) for a in args), interpret=True)
    out, s = se.se_scale_ref(*_port_se_args(*args))
    assert s.shape == (3, c, 1, 1)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nhwc(s), np.asarray(ref_s), rtol=0, atol=1e-5)


def test_se_scale_wrapper_on_cpu_is_plain_and_uncounted():
    args = _port_se_args(*_se_inputs(14, seed=1))
    se.se_scale.launches = 0
    got, ref = se.se_scale(*args), se.se_scale_ref(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert se.se_scale.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_se_mlp_weights_prepared_once_per_parameter_set(dtype):
    """The SE kernels' weights: (W1, b1, W2^T, b2) in the map dtype, reused
    while the parameters are unchanged, made anew after an in-place update."""
    from dmf_tpu_torch.ops import prepared

    block = SEBlock(14)
    w1, b1, w2, b2 = block.fc[1].weight, block.fc[1].bias, block.fc[3].weight, block.fc[3].bias
    first = prepared.mlp_weights(w1, b1, w2, b2, 14, 7, dtype)
    assert [t.shape for t in first] == [(7, 14), (7,), (7, 14), (14,)]
    assert all(t.dtype == dtype and t.is_contiguous() for t in first)
    assert torch.equal(first[0], w1.reshape(7, 14).to(dtype))
    assert torch.equal(first[2], w2.reshape(14, 7).t().to(dtype))
    again = prepared.mlp_weights(w1, b1, w2, b2, 14, 7, dtype)
    assert all(a is b for a, b in zip(first, again))
    with torch.no_grad():
        w2.mul_(2.0)
    changed = prepared.mlp_weights(w1, b1, w2, b2, 14, 7, dtype)
    assert changed[2] is not first[2]
    assert torch.equal(changed[2], w2.reshape(14, 7).t().to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_weights_prepared_once_per_parameter_set(dtype):
    """Kernel 2's operands: the K-major (Cout, 9*Cin) weight matrix (in bf16,
    or as its two 3xTF32 halves in fp32) and the folded fp32 (s, t), equal to
    a fresh preparation, reused while the parameters are unchanged and made
    anew after an in-place update of the weight or of a BN statistic."""
    from dmf_tpu_torch.ops import conv3x3

    torch.manual_seed(0)
    conv, bn = nn.Conv2d(16, 24, 3, padding=1), nn.BatchNorm2d(24)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.normal_(0.0, 0.1)
        bn.running_var.uniform_(0.5, 1.5)
    params = (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    tf32x3 = dtype == torch.float32

    def halves(m):
        if not tf32x3:
            return m, None
        hi = conv3x3.rna_tf32(m)
        return hi, conv3x3.rna_tf32(m - hi)

    def fresh():
        w = conv.weight.detach().permute(0, 2, 3, 1).reshape(24, 9 * 16).to(dtype)
        return (*halves(w), *conv3x3.fold_bn(*(p.detach() for p in params[1:]), bn.eps))

    def same(a, b):
        return all(x is y if x is None else torch.equal(x, y) for x, y in zip(a, b))

    first = conv3x3.conv_weights(*params, bn.eps, dtype)
    tensors = [t for t in first if t is not None]
    assert (first[1] is None) == (not tf32x3)
    assert [t.shape for t in tensors] == [(24, 144)] * (1 + tf32x3) + [(24,), (24,)]
    assert [t.dtype for t in tensors] == [dtype] * (1 + tf32x3) + [torch.float32] * 2
    assert all(t.is_contiguous() and not t.requires_grad for t in tensors)
    assert same(first, fresh())
    # column k = tap * Cin + c, taps in (ky, kx) row-major order
    assert torch.equal(first[0][5, 4 * 16 + 3],
                       halves(conv.weight[5, 3, 1, 1].detach().to(dtype))[0])
    again = conv3x3.conv_weights(*params, bn.eps, dtype)
    assert all(a is b for a, b in zip(first, again))
    with torch.no_grad():
        conv.weight.mul_(2.0)
    changed = conv3x3.conv_weights(*params, bn.eps, dtype)
    assert changed[0] is not first[0]
    assert same(changed, fresh())
    bn.running_var.add_(1.0)  # a buffer, updated in place as BN's training step does
    restat = conv3x3.conv_weights(*params, bn.eps, dtype)
    assert not torch.equal(restat[2], changed[2])
    assert same(restat, fresh())
    no_bias = conv3x3.conv_weights(conv.weight, None, *params[2:], bn.eps, dtype)
    assert torch.equal(no_bias[0], restat[0]) and not torch.equal(no_bias[3], restat[3])


def test_se_kernels_refuse_autograd():
    """The SE kernels have no backward: a call autograd would record raises."""
    from dmf_tpu_torch.ops import prepared

    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        prepared.check_no_grad("se_scale", torch.zeros(3), w)
    with torch.no_grad():
        prepared.check_no_grad("se_scale", torch.zeros(3), w)
    prepared.check_no_grad("se_scale", torch.zeros(3), w.detach())


@pytest.mark.parametrize("c", [14, 6])
def test_seblock_loaded_from_jax_export_matches(c):
    """The modality-attention SE: a JAX SEBlock's variables, exported in the
    reference layout, load strictly into the port's SEBlock, whose forward
    is now ``se_scale``."""
    x = np.random.RandomState(5).rand(2, 12, 12, c).astype(np.float32)
    jm = jl.SEBlock(c)
    v = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    ref_out, ref_w = jm.apply(v, jnp.asarray(x))
    exp = _Exporter()
    exp.se(_to_host(v["params"]), "m")
    holder = nn.Module()
    holder.add_module("m", SEBlock(c))
    load_reference_state_dict(holder, exp.out)
    out, w = holder.m(nchw(x))
    assert_close(nhwc(out), ref_out)
    assert_close(nhwc(w), ref_w)
