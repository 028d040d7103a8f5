"""The port's bench (``dmf_tpu_torch/bench.py``) and the CLI's ``bench`` on
the CPU, beside the JAX package's ``bench.py``, which is never run here (its
XLA compiles are slow); the JAX side is composed from ``dmf_tpu`` functions
as ``bench.py`` composes them, on the same weights (the exporters):

* the ``--quick`` and full-width configs equal ``bench.py``'s, and the metric
  names follow its rule (bench.py:717-725, executed from its source);
* the FLOP formulas of the kernels' operators equal their closed forms;
* the serving inference in fp32 equals JAX's preprocessing + apply /
  predictor (bench.py:616-689) at rel 1e-4 in ``normal`` and ``tta``; a
  chunked ``tta_mc`` ensemble equals the unchunked one, with dropout off
  and on;
* (``test_torch_bench_train.py``: the bf16-compute train steps against
  JAX's, apart so that the two files' XLA compiles run on two workers);
* each mode prints one JSON line whose metric and keys are those of the JAX
  bench's own output for the same flags (the repo's ``BENCH_r0*.json``),
  without the TPU ratios and without ``mfu``, which only a card of the
  peak table prints; without a card and ``--device cpu`` the bench fails.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import assert_close, fusion_stack

from dmf_tpu import config as jconfig
from dmf_tpu.data import preprocess as jpre
from dmf_tpu.evals.predict import make_fusion_predictor as j_predictor

from dmf_tpu_torch import bench, cli

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# the JAX bench's keys that the port does not print: ratios to TPU v5e
# figures, and mfu, which needs a card of bench.PEAK_TFLOPS
TPU_ONLY = {"vs_baseline", "vs_conv_roofline", "mfu"}


def args_of(*argv):
    return bench.parse_args(["--device", "cpu", *argv])


# ------------------------------------------------------------ config, names
def jax_bench_config(quick, encoder, batch):
    """bench.py:502-535 with the JAX package's config."""
    cfg = jconfig.default_parameters(batch_size=batch)
    base = cfg.dwi_model
    if encoder == "vit":
        base = dataclasses.replace(base, backbone_str="vit_base_patch16_224")
    elif encoder == "hybrid":
        base = dataclasses.replace(base, use_hybrid_transformer=True)
    elif encoder == "hybrid-nb":
        base = dataclasses.replace(base, use_backbone=False, use_hybrid_transformer=True)
    mc = dataclasses.replace(jconfig.resolve_backbone_config(base),
                             input_size=64 if quick else 256)
    fs = cfg.fusion_model.fusion_specific
    if quick:
        mc = dataclasses.replace(mc, channels=(32, 64, 128), use_backbone=False, proj_dim=16)
        fs = dataclasses.replace(fs, dwi_out_channels=128, dce_out_channels=128)
    elif encoder == "vit":
        fs = dataclasses.replace(fs, dwi_out_channels=768, dce_out_channels=768)
    return cfg.replace(dwi_model=mc, dce_model=mc,
                       fusion_model=dataclasses.replace(mc, fusion_specific=fs))


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("encoder", ["resnet", "vit", "hybrid", "hybrid-nb"])
def test_config_matches_bench_py(quick, encoder):
    args = args_of(*(["--quick"] if quick else []), "--encoder", encoder)
    assert bench.bench_config(args).to_dict() == jax_bench_config(
        quick, encoder, args.batch).to_dict()


def jax_metric(args):
    """The metric name bench.py gives ``args``: its own statements
    (bench.py:717-725), read from its source and executed."""
    src = (ROOT / "bench.py").read_text()
    start = src.index('    metric = ("fusion_inference_throughput"')
    end = src.index("    result = {", start)
    ns = {"args": args}
    exec(textwrap.dedent(src[start:end]), ns)
    return ns["metric"]


@pytest.mark.parametrize("flags", [
    [], ["--mode", "tta"], ["--mode", "mc"], ["--mode", "tta_mc"], ["--int8"],
    ["--mode", "tta_mc", "--int8"], ["--mode", "tta_mc", "--int8-prefix"],
    ["--mode", "mc", "--int8-prefix", "--encoder", "vit"], ["--encoder", "hybrid"],
    ["--mode", "tta_mc", "--encoder", "hybrid"], ["--mode", "tta_mc", "--encoder", "hybrid-nb"],
    ["--int8", "--encoder", "hybrid-nb"]])
def test_serving_metric_follows_bench_py(flags):
    args = args_of(*flags)
    assert bench.serving_metric(args) == jax_metric(args)


# -------------------------------------------------------------- FLOP formulas
def _conv_case():
    x = torch.randn(2, 8, 6, 5)
    w, bn = torch.randn(16, 8, 3, 3), torch.ones(16)
    return (lambda: torch.ops.dmf.conv3x3_bn_gelu(x, w, None, bn, bn * 0, bn * 0, bn, 1e-5, 0),
            2 * 2 * 6 * 5 * 16 * 9 * 8)


def _flash_case():
    q = torch.randn(6, 64, 16)
    return lambda: torch.ops.dmf.flash_forward(q, q, q, 0.25), 4 * 6 * 64 * 64 * 16


def _int8_conv_case():
    x = torch.randint(-127, 128, (2, 8, 9, 7), dtype=torch.int8)
    w = torch.randint(-127, 128, (16, 3, 3, 8), dtype=torch.int8)
    scale = torch.ones(16)
    # stride 2, padding 1: a 5 x 4 output
    return (lambda: torch.ops.dmf.int8_conv(x, w, scale, torch.tensor(0.5), None, [2, 2],
                                            [1, 1], [1, 1], torch.float32),
            2 * 2 * 5 * 4 * 16 * 9 * 8)


@pytest.mark.parametrize("case", [_conv_case, _flash_case, _int8_conv_case])
def test_flop_formulas_match_closed_forms(case):
    fn, closed = case()
    assert bench.count_flops(fn) == closed


# --------------------------------------------------------- serving inference
B = 2


@pytest.fixture(scope="module")
def serving_stack():
    """Both packages' fp32 models on the same weights at ``--quick``
    geometry, and a request of raw volumes."""
    jcfg = jax_bench_config(True, "resnet", B)
    arr = bench.volumes(B, 64, jcfg.dwi_base_channel_num, jcfg.dce_channel_num,
                        jcfg.class_num, seed=0)
    xd = np.zeros((1, 64, 64, jcfg.dwi_channel_num), np.float32)
    xc = np.zeros((1, 64, 64, jcfg.dce_channel_num), np.float32)
    jmods, jvars, pmods = fusion_stack(jcfg, xd, xc)
    return jcfg, arr, jmods, jvars, pmods


def jax_infer(jcfg, mode, jmods, jvars, dwi_raw, dce_raw):
    """bench.py:594-689 in fp32 on the CPU (percentile stride 1)."""
    from dmf_tpu.train.fusion import make_fusion_apply

    C_dce, S = jcfg.dce_channel_num, 64
    landmarks = jnp.asarray(jpre.DEFAULT_LANDMARKS, jnp.float32)
    chan = jnp.tile(jnp.linspace(0.0, 1.0, len(jpre.DEFAULT_LANDMARKS))[None, :], (C_dce, 1))
    std_scale = jnp.linspace(0.0, 1.0, len(jpre.DEFAULT_LANDMARKS))
    adc_map = jnp.zeros((S, S, 1), jnp.float32) + 0.5
    variables = {"dwi": jvars[0], "dce": jvars[1], "fusion": jvars[2]}

    def preprocess(d, c):
        dx = jpre.append_adc(jpre.dwi_normalize(d, skip_last=True, zero_last=True), adc_map)
        return dx, jpre.nyul_transform_fast(c, chan, landmarks, std_scale, percentile_stride=1)

    if mode == "normal":
        apply_fn = make_fusion_apply(*jmods)

        def infer(v, d, c):
            logits = apply_fn(v, *preprocess(d, c), train=False)[0]
            return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    else:
        predictor = j_predictor(jcfg, *jmods, mode=mode)

        def infer(v, d, c):
            mean, std, _ = predictor(v["dwi"], v["dce"], v["fusion"], *preprocess(d, c),
                                     jax.random.PRNGKey(0))
            return mean, std

    return jax.jit(infer)(variables, jnp.asarray(dwi_raw), jnp.asarray(dce_raw))


@pytest.mark.parametrize("mode", ["normal", "tta"])
def test_inference_matches_jax(serving_stack, mode):
    jcfg, arr, jmods, jvars, pmods = serving_stack
    args = args_of("--quick", "--mode", mode, "--batch", str(B))
    pcfg = bench.bench_config(args)
    assert pcfg.to_dict() == jcfg.to_dict()
    infer = bench.make_infer(pcfg, args, pmods, bench.make_preprocess(args, CPU))
    got = infer(torch.from_numpy(arr["dwi"]), torch.from_numpy(arr["dce"]))
    ref = jax_infer(jcfg, mode, jmods, jvars, arr["dwi"], arr["dce"])
    if mode == "normal":
        assert_close(got, ref, what="probs")
        return
    assert_close(got[0], ref[0], what="mean")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-5)


def test_mc_chunked_ensemble_matches_unchunked(serving_stack):
    """``--mc-chunk``: without dropout every pass is the same, so chunks of
    1 and 2 give the unchunked ensemble (pass bookkeeping, views, order);
    with dropout on, each pass draws its masks from its own pass word of the
    request seed whatever chunk it runs in, so the chunked ensembles are
    the unchunked one to the same tolerance (only the convs' batch sizes
    differ)."""
    _, arr, _, _, pmods = serving_stack
    request = (torch.from_numpy(arr["dwi"]), torch.from_numpy(arr["dce"]))

    def ensembles(models, cfg_of):
        out = []
        for chunk in ([], ["--mc-chunk", "1"], ["--mc-chunk", "2"]):
            args = args_of("--quick", "--mode", "tta_mc", "--batch", str(B), *chunk)
            out.append(bench.make_infer(cfg_of(args), args, models,
                                        bench.make_preprocess(args, CPU))(*request))
        return out

    def no_dropout(args):
        cfg = bench.bench_config(args)
        return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), dropout=0.0)
                              for k in ("dwi_model", "dce_model", "fusion_model")})

    still = bench.build_models(no_dropout(args_of("--quick", "--mode", "tta_mc")), CPU)
    (m0, s0), *rest = ensembles(still, no_dropout)
    for m, s in rest:
        torch.testing.assert_close(m, m0, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(s, s0, rtol=1e-5, atol=1e-6)
    (m0, s0), *rest = ensembles(pmods, bench.bench_config)
    for m, s in rest:
        assert (s > 0).all() and (s0 > 0).all()
        torch.testing.assert_close(m, m0, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(s, s0, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- the modes
SMALL = ["--quick", "--device", "cpu", "--warmup", "0", "--batch", "2", "--steps", "1"]


def jax_output(name):
    """The keys of a line the JAX bench printed (the repo's record)."""
    d = json.loads((ROOT / name).read_text())
    return d.get("parsed", d)


@pytest.mark.parametrize("flags,record", [
    (["--nyul-stride", "4"], "BENCH_r05.json"),
    (["--mode", "tta_mc", "--mc-chunk", "2"], "BENCH_r05_tta_mc.json"),
    (["--int8"], "BENCH_r05_int8.json"),
    (["--int8-prefix", "--mode", "tta_mc"], "BENCH_r05_tta_mc_hybrid.json"),
    (["--train"], "BENCH_r04_train.json"),
    (["--train", "--parallel-folds", "2"], "BENCH_r04_folds.json"),
    (["--train-e2e", "single", "--train-e2e-epochs", "2"], "BENCH_r05_train_e2e_single.json"),
    (["--numerics", "--numerics-train-steps", "2", "--numerics-test-n", "16"],
     "BENCH_r05_numerics.json")])
def test_mode_prints_one_line_as_jax(flags, record, capsys, tmp_path):
    out = tmp_path / "line.json"
    result = bench.main([*SMALL, *flags, "--out", str(out)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert out.read_text() == lines[0] + "\n"
    ref = jax_output(record)
    assert result["metric"] == ref["metric"]
    assert set(result) == set(ref) - TPU_ONLY
    value = result["value"]
    assert math.isfinite(value) and (value > 0 or result["metric"] == "bf16_vs_fp32_numerics")
    for key in ("int8_agreement", "hybrid_agreement", "nyul_stride_agreement",
                "argmax_agreement"):
        if key in result:
            assert 0.0 <= result[key] <= 1.0
    if "final_train_loss" in result:
        assert math.isfinite(result["final_train_loss"])


def test_cli_bench_quick_on_the_cpu(capfd):
    """``cli bench --quick --device cpu`` runs ``python -m
    dmf_tpu_torch.bench`` in a subprocess: one line, bench.py's default
    metric."""
    assert cli.main(["bench", "--quick", "--device", "cpu"]) == 0
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    assert json.loads(lines[0])["metric"] == "fusion_inference_throughput"


def test_bench_refuses_without_a_card(monkeypatch):
    """Without ``--device cpu`` and no card: ``main`` raises before any
    work, the module's process and the CLI exit non-zero with no line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--quick"])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                                          if p))
    run = subprocess.run([sys.executable, "-m", "dmf_tpu_torch", "bench", "--quick"],
                         env=env, capture_output=True, text=True, cwd=ROOT)
    assert run.returncode != 0 and "{" not in run.stdout
    assert "no CUDA device" in run.stderr


def test_parser_refuses_bench_py_conflicts():
    err = io.StringIO()
    for argv in (["--int8", "--int8-prefix", "--mode", "tta_mc"], ["--int8-prefix"]):
        with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
            bench.main(["--quick", "--device", "cpu", *argv])
    assert "mutually exclusive" in err.getvalue() and "mc/tta_mc only" in err.getvalue()
