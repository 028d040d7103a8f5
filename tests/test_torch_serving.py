"""The port's serving artifact (``dmf_tpu_torch/serving.py``) against the JAX
package's (``dmf_tpu/serving.py``), and the pieces under it, on the CPU.

Toy geometry as ``tests/test_serving.py`` (32^2, channels (8, 16, 32), no
backbone, dropout 0.3, 3 MC passes), the weights transplanted from the JAX
variables (``test_torch_helpers.fusion_stack``).  Tolerances:

* deterministic modes against JAX's serving function: ``RTOL`` (relative
  1e-4 against the tensor's scale), the TTA std 1e-5 absolute;
* the saved and reloaded artifact against the unexported function: rtol
  1e-6 / atol 1e-7, as ``tests/test_serving.py:60-73`` (in practice the same
  bits);
* the seed route's masks against the numpy Philox: bit for bit.

The operators' fake implementations are held against their CPU
implementations in shape, dtype and strides; the exported graph's operator
nodes against the operator calls of the eager function.
"""

import copy
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_helpers import assert_close, fusion_stack, port_config, tiny_cfg, volumes

from dmf_tpu.serving import make_serving_fn as jax_serving_fn
from dmf_tpu_torch import cli
from dmf_tpu_torch.models import build_fusion_models
from dmf_tpu_torch.models.layers import ResLiteBlock
from dmf_tpu_torch.ops import dropout, library
from dmf_tpu_torch.ops.epilogue_cuda import keep_mask_ref
from dmf_tpu_torch.serving import (checkpoint_variables, export_program, export_serving,
                                   load_serving, make_serving_fn, operator_nodes,
                                   serving_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7


@pytest.fixture(scope="module")
def stack():
    """Both packages' encoders and fusion head on the same weights, the
    port's config, and one batch of NHWC inputs."""
    cfg = tiny_cfg(dropout=0.3, use_backbone=False, mc_passes=3)
    xd, xc = volumes(0)
    jmods, jvars, pmods = fusion_stack(cfg, xd, xc)
    jvariables = dict(zip(("dwi", "dce", "fusion"), jvars))
    return cfg, port_config(cfg), jmods, jvariables, pmods, xd, xc


def _args(pmods, xd, xc, seed=SEED):
    return (serving_variables(*pmods), torch.from_numpy(xd), torch.from_numpy(xc),
            torch.tensor(seed, dtype=torch.int64))


@pytest.mark.parametrize("mode", ["normal", "tta"])
def test_deterministic_modes_match_jax(stack, mode):
    cfg, pcfg, jmods, jvariables, pmods, xd, xc = stack
    jmean, jstd = jax.jit(jax_serving_fn(cfg, *jmods, mode=mode))(
        jvariables, jnp.asarray(xd), jnp.asarray(xc), jnp.uint32(SEED))
    mean, std = make_serving_fn(pcfg, *pmods, mode=mode)(*_args(pmods, xd, xc))
    assert_close(mean, jmean, what="mean")
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=0, atol=1e-5)
    if mode == "normal":
        assert torch.equal(std, torch.zeros_like(std))


@pytest.mark.parametrize("mode", ["normal", "tta", "mc", "tta_mc"])
def test_artifact_roundtrip(stack, mode):
    """Export, save, load: the same numbers as the unexported function, no
    parameter, buffer or constant in the program."""
    _, pcfg, _, _, pmods, xd, xc = stack
    fn = make_serving_fn(pcfg, *pmods, mode=mode)
    args = _args(pmods, xd, xc)
    mean0, std0 = fn(*args)
    data = export_serving(fn, args)
    assert isinstance(data, bytes) and len(data) > 0
    mean1, std1 = load_serving(data)(*args)
    for got, ref in ((mean1, mean0), (std1, std0)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mean1.sum(-1).numpy(), 1.0, atol=1e-5)


def test_tta_mc_seed_route(stack):
    """Through the artifact: one seed gives the same bits twice, another
    seed other numbers, the MC variance survives; with dropout 0 the
    ensemble is the TTA ensemble (to the artifact's tolerance: a mean over
    the 3 x 4 equal probabilities and one over the 4 views differ in the
    last bit)."""
    cfg, pcfg, _, _, pmods, xd, xc = stack
    fn = make_serving_fn(pcfg, *pmods, mode="tta_mc")
    served = load_serving(export_serving(fn, _args(pmods, xd, xc)))
    mean_a, std_a = served(*_args(pmods, xd, xc, seed=21))
    mean_b, std_b = served(*_args(pmods, xd, xc, seed=21))
    mean_c, _ = served(*_args(pmods, xd, xc, seed=22))
    assert torch.equal(mean_a, mean_b) and torch.equal(std_a, std_b)
    assert not torch.equal(mean_a, mean_c)
    assert float(std_a.mean()) > 1e-6
    still = [copy.deepcopy(m) for m in pmods]
    for block in (b for m in still for b in m.modules() if isinstance(b, ResLiteBlock)):
        block.dropout = 0.0
    off = load_serving(export_serving(make_serving_fn(pcfg, *still, mode="tta_mc"),
                                      _args(still, xd, xc)))(*_args(still, xd, xc))
    tta = make_serving_fn(pcfg, *still, mode="tta")(*_args(still, xd, xc))
    np.testing.assert_allclose(off[0].numpy(), tta[0].numpy(), rtol=1e-6, atol=1e-7)


def test_artifact_file_and_fresh_weights(stack, tmp_path):
    """Weights ride as arguments: the artifact written to disk serves
    another checkpoint of the same geometry without a new export."""
    _, pcfg, _, _, pmods, xd, xc = stack
    fn = make_serving_fn(pcfg, *pmods, mode="normal")
    path = str(tmp_path / "serving.pt2")
    export_serving(fn, _args(pmods, xd, xc), path=path)
    served = load_serving(path)
    variables, dx, cx, seed = _args(pmods, xd, xc)
    fresh = {m: {k: v + 0.01 if v.is_floating_point() else v for k, v in sd.items()}
             for m, sd in variables.items()}
    direct, _ = fn(fresh, dx, cx, seed)
    got, _ = served(fresh, dx, cx, seed)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-6, atol=1e-7)
    orig, _ = served(variables, dx, cx, seed)
    assert not np.allclose(orig.numpy(), got.numpy(), atol=1e-6)


def test_load_in_a_process_without_the_model_code(stack, tmp_path):
    """A fresh process that imports torch and ``dmf_tpu_torch.ops.library``
    alone loads the artifact and the weights and serves the same numbers."""
    _, pcfg, _, _, pmods, xd, xc = stack
    fn = make_serving_fn(pcfg, *pmods, mode="tta_mc")
    args = _args(pmods, xd, xc)
    export_serving(fn, args, path=str(tmp_path / "serving.pt2"))
    torch.save(args, tmp_path / "inputs.pt")
    script = textwrap.dedent(f"""
        import sys
        import torch
        import dmf_tpu_torch.ops.library
        program = torch.export.load({str(tmp_path / "serving.pt2")!r}).module()
        args = torch.load({str(tmp_path / "inputs.pt")!r}, weights_only=True)
        torch.save(program(*args), {str(tmp_path / "out.pt")!r})
        assert "dmf_tpu_torch.models" not in sys.modules
        loaded = sorted(m for m in sys.modules if m.startswith("dmf_tpu_torch"))
        print(" ".join(loaded))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert loaded and all(m.split(".")[1] in ("config", "ops") for m in loaded[1:])
    got = torch.load(tmp_path / "out.pt", weights_only=True)
    # the same program on another torch thread pool: sums in other orders
    for g, r in zip(got, fn(*args)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6, atol=1e-7)


class _OperatorCalls(TorchDispatchMode):
    """Counts the calls of the kernels' operators under the mode."""

    def __init__(self):
        super().__init__()
        self.calls = dict.fromkeys(library.OPERATORS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith(f"{library.NAMESPACE}::"):
            self.calls[name.split("::")[1].split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode,expect", [
    ("normal", {"se_epilogue": 6, "conv3x3_bn_gelu": 12, "se_scale": 3}),
    # two suffixes (the lean chunk, the last pass); a bottleneck dropout
    # beside each epilogue
    ("tta_mc", {"se_epilogue": 12, "keep_mask": 12, "conv3x3_bn_gelu": 12, "se_scale": 4})])
def test_operator_nodes_equal_eager_calls(mode, expect):
    """With a (1, 1, 1, 1) ResNet-50 backbone (so the necks run): the
    exported graph holds one node per operator call of the eager function."""
    pcfg = port_config(tiny_cfg(dropout=0.3, use_backbone=True, mc_passes=3))
    pmods = build_fusion_models(pcfg, "cpu", torch.float32, torch.Generator().manual_seed(0),
                                backbone_layers=(1, 1, 1, 1))
    fn = make_serving_fn(pcfg, *pmods, mode=mode)
    args = _args(pmods, *volumes(1))
    with torch.no_grad(), _OperatorCalls() as mode_calls:
        fn(*args)
    nodes = operator_nodes(export_program(fn, args))
    assert nodes == mode_calls.calls == dict.fromkeys(library.OPERATORS, 0) | expect


@pytest.mark.parametrize("fmt", ["nchw", "channels_last", "tokens"])
@pytest.mark.parametrize("base", [0, 2 ** 31 - 40, 2 ** 40 + 4])
def test_seed_route_mask_is_the_kernels_philox(fmt, base):
    """The torch Philox of the seed route (the ``keep_mask`` operator's CPU
    implementation) against ``keep_mask_ref`` in the seed order: NHWC for a
    map whatever its memory format, row-major for tokens."""
    shape = (2, 6, 5, 3) if fmt != "tokens" else (2, 7, 12)
    x = torch.zeros(shape)
    if fmt == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    for seed in (12345, (0x5EED << 32) | 77):
        keep = dropout.keep_mask(x, 0.3, torch.tensor(seed), base)
        assert keep.shape == x.shape and keep.dtype == torch.bool
        order = keep.permute(0, 2, 3, 1) if fmt != "tokens" else keep
        np.testing.assert_array_equal(order.reshape(-1).numpy(),
                                      keep_mask_ref(base, x.numel(), 0.3, seed))


def test_seed_stream_counters():
    """Each site takes its own counters, rounded up to a multiple of 4."""
    stream = dropout.SeedStream(torch.tensor(3))
    assert [stream.take(n) for n in (10, 8, 1, 3)] == [0, 12, 20, 24]
    assert stream.counter == 28


def _operator_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    cl = torch.channels_last
    x, idn = r(2, 8, 5, 5), r(2, 8, 5, 5)
    se_w = (r(4, 8, 1, 1), r(4), r(8, 4, 1, 1), r(8))
    conv = (r(16, 8, 3, 3), r(16), r(16) + 1, r(16), r(16), r(16).abs() + 0.5)
    return {
        "se_epilogue": (x, idn, *se_w, 0.3, torch.tensor(9), 8),
        "se_epilogue_cl": (x.contiguous(memory_format=cl), idn.contiguous(memory_format=cl),
                           *se_w, 0.0, None, 0),
        "keep_mask": (x, 0.3, torch.tensor(9), 4),
        "keep_mask_tokens": (r(2, 7, 12), 0.1, torch.tensor(9), 0),
        "conv3x3_bn_gelu": (x, *conv, 1e-5, 0),
        "conv3x3_bn_gelu_cl": (x.contiguous(memory_format=cl), conv[0], None, *conv[2:],
                               1e-5, 0),
        "se_scale": (x, *se_w),
        "se_scale_cl": (x.contiguous(memory_format=cl), *se_w),
        "flash_forward": (r(3, 64, 16), r(3, 128, 16), r(3, 128, 16), 0.25),
    }


@pytest.mark.parametrize("case", sorted(_operator_cases()))
def test_operator_fake_matches_cpu(case):
    """Each operator's fake implementation (what a trace sees) gives its
    CPU implementation's shapes, dtypes and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _operator_cases()[case]
    op = getattr(torch.ops.dmf, case.split("_cl")[0].split("_tokens")[0])
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r_, f_ in zip(real, fake):
        assert (r_.shape, r_.dtype, r_.stride()) == (f_.shape, f_.dtype, f_.stride())


def test_fwd_override_raises(stack):
    _, pcfg, _, _, pmods, _, _ = stack
    with pytest.raises(NotImplementedError, match="ROADMAP 1.11"):
        make_serving_fn(pcfg, *pmods, fwd_override=lambda *a: None)


def test_cli_export_serving(tmp_path):
    """``export-serving --tiny --device cpu --batch 2 --mode normal`` writes
    an artifact whose 4-D inputs have batch 2 (``tests/test_serving.py:115-130``)."""
    out = str(tmp_path / "serving.pt2")
    assert cli.main(["export-serving", "--tiny", "--device", "cpu", "--out", out,
                     "--mode", "normal", "--batch", "2"]) == 0
    program = torch.export.load(out)
    shapes = [tuple(n.meta["val"].shape) for n in program.graph.nodes
              if n.op == "placeholder" and n.meta["val"].dim() == 4
              and n.name in program.graph_signature.user_inputs]
    assert (2, 32, 32, 14) in shapes  # the DWI serving input
    assert (2, 32, 32, 6) in shapes  # the DCE serving input


def test_cli_export_serving_needs_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["export-serving", "--tiny", "--out", str(tmp_path / "x.pt2")])


def test_checkpoint_variables(tmp_path):
    """A fusion run's checkpoint read with torch alone into the serving
    function's variables, the models' state dicts."""
    from dmf_tpu_torch.pipeline import build_fusion_state, build_single_model
    from dmf_tpu_torch.train.state import TrainState
    from dmf_tpu_torch.utils.checkpoint import save_state

    cfg = cli.load_config(cli.build_parser().parse_args(["export-serving", "--tiny",
                                                         "--out", "x"]))
    models = [build_single_model(cfg, m, device="cpu")[0] for m in ("dwi", "dce")]
    state = build_fusion_state(cfg, *map(TrainState.create, models))
    save_state(str(tmp_path / "best.pt"), state)
    got = checkpoint_variables(str(tmp_path / "best.pt"), "cpu", torch.bfloat16)
    net = state.model
    want = serving_variables(net.dwi, net.dce, net.fusion)
    assert got.keys() == want.keys()
    for m in want:
        assert got[m].keys() == want[m].keys()
        for k, t in want[m].items():
            expect = t.to(torch.bfloat16) if t.is_floating_point() else t
            assert torch.equal(got[m][k], expect), (m, k)


def test_prepared_weights_under_a_trace_are_not_cached():
    """Under a fake-tensor trace ``prepared`` computes its value inline (fake
    tensors have no stable address or version) and caches nothing; on real
    tensors it caches as before."""
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

    from dmf_tpu_torch.ops import prepared

    w = [torch.randn(4, 8), torch.randn(4), torch.randn(8, 4), torch.randn(8)]
    before = len(prepared._CACHE)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in w]
        out = prepared.mlp_weights(*fake, 8, 4, torch.float32)
        assert all(is_fake(t) for t in out)
        again = prepared.mlp_weights(*fake, 8, 4, torch.float32)
        assert again[0] is not out[0]
    assert len(prepared._CACHE) == before
    real = prepared.mlp_weights(*w, 8, 4, torch.float32)
    assert prepared.mlp_weights(*w, 8, 4, torch.float32)[0] is real[0]
