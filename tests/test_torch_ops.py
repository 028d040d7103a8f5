"""Port ops vs the JAX package: resize, attention and the two kernels' plain versions.

The kernels' plain versions are held against the Pallas kernels run as the
JAX tests run them on the CPU (``interpret=True``).  The interpreter stubs
the TPU's random bits to zeros, which the kernel reads as keep-everything, so
with dropout its output is exactly ``undropped / (1 - p)``: the port's plain
version is fed an all-ones ``keep`` mask for that check.  On CPU tensors the
wrappers run the plain versions and never count a launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import assert_close, nchw, nhwc

from dmf_tpu.ops import attention as jattn
from dmf_tpu.ops import resize as jresize
from dmf_tpu.ops.conv3x3_pallas import conv3x3_bn_gelu as jax_conv3x3
from dmf_tpu.ops.epilogue_pallas import se_epilogue as jax_se_epilogue
from dmf_tpu_torch.ops import attention, resize
from dmf_tpu_torch.ops.conv3x3 import conv3x3_bn_gelu, conv3x3_bn_gelu_ref
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


def test_build_digest_covers_shared_headers(tmp_path):
    """A library's build key takes every ``csrc/*.cuh`` beside its own
    sources, so an edit to a shared header rebuilds both wgmma libraries."""
    import shutil

    from dmf_tpu_torch.ops.cuda_build import CSRC_DIR, source_digest

    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC_DIR, csrc)
    sources = {lib: (f"{lib}.cu",) for lib in ("flash_attention", "conv3x3_bn_gelu")}
    before = {lib: source_digest(src, csrc) for lib, src in sources.items()}
    assert before == {lib: source_digest(src, CSRC_DIR) for lib, src in sources.items()}
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {lib: source_digest(src, csrc) for lib, src in sources.items()}
    assert all(after[lib] != before[lib] for lib in sources)
    # a source of another library leaves the key alone; a new header does not
    hist = csrc / "histogram_percentiles.cu"
    hist.write_bytes(hist.read_bytes() + b"\n")
    assert source_digest(sources["flash_attention"], csrc) == after["flash_attention"]
    (csrc / "extra.cuh").write_text("// new\n")
    assert source_digest(sources["flash_attention"], csrc) != after["flash_attention"]
