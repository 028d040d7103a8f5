"""The port's command line against the JAX package's, on the CPU at ``--tiny``
geometry (32^2, channels (8, 16, 32), no backbone, batch 8).

* ``run --tiny --folds 0 --fusion --epochs 2`` in both packages with the same
  arguments on the same synthetic store: the same summary keys, the same
  ``metrics.json`` key sets and ``parameters`` blocks.  Values differ:
  dropout and augmentation draw from each framework's own random stream.
  The config file sets the ``normal`` test mode to keep the JAX side's XLA
  compiles short (the port's ``tta_mc`` test runs in the other tests).
* ``debug-suite --tiny --device cpu --fusion`` passes.
* ``export-ckpt`` on the port's fusion and DWI checkpoints writes files that
  load strictly back into fresh port models, and that
  ``dmf_tpu.models.ref_ckpt``'s importers read back to the port's weights.
* ``run --parallel-folds --folds 0 1`` gives the sequential run's summary,
  ``metrics.json`` (wall times aside) and best checkpoints, bit for bit.
* ``--device`` defaults to ``cuda`` and does not fall back to the CPU;
  ``bench`` is not registered, ``export-serving`` needs its ``--out`` (its
  runs are in ``test_torch_serving.py``); ``--mesh`` runs in
  ``test_torch_mesh_run.py`` and ``test_torch_tp_fit.py``.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_helpers import fusion_stack, volumes

from dmf_tpu import cli as jcli
from dmf_tpu.config import Config as JConfig
from dmf_tpu.models import ref_ckpt
from dmf_tpu.utils import visualize
from dmf_tpu_torch import cli, default_parameters
from dmf_tpu_torch.models import (export_reference_encoder, load_lightning_ckpt,
                                  load_reference_state_dict)
from dmf_tpu_torch.pipeline import build_fusion_state, build_single_model
from dmf_tpu_torch.train.state import TrainState

EPOCHS = 2


def summary_of(text):
    """The JSON summary ``run`` prints last."""
    return json.loads(text[text.rindex("\n{\n") + 1:])


def run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``run`` of fold 0 with the fusion stage, one after the
    other on one base path (each run's processed splits and Nyul landmarks
    removed before the next).  The JAX loops' mask triptychs are not drawn:
    matplotlib's first layout takes tens of seconds (the port's triptychs
    are held against JAX's panels in ``test_torch_utils.py``)."""
    tmp = tmp_path_factory.mktemp("cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(visualize, "visualize_mask_triplet", lambda *a, **k: None)
        return _runs(tmp)


def _runs(tmp):
    config = str(tmp / "cfg.json")
    default_parameters(test_mode="normal").save(config)
    base = tmp / "data"
    args = ["run", "--config", config, "--tiny", "--folds", "0", "--fusion",
            "--epochs", str(EPOCHS), "--min-epochs", str(EPOCHS), "--base-path", str(base)]
    out = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        shutil.rmtree(base, ignore_errors=True)
        text = run_cli(main, args + extra + ["--results-dir", str(tmp / name)])
        out[name] = {"summary": summary_of(text), "results": tmp / name, "text": text}
    out["argv"] = args + ["--device", "cpu"]
    return out


def test_run_summary_matches_jax(runs):
    ours, theirs = runs["port"]["summary"], runs["jax"]["summary"]
    assert list(ours) == list(theirs) == ["fold0_fusion", "fold0_dwi", "fold0_dce"]
    for key, metrics in ours.items():
        assert set(metrics) == set(theirs[key]), key
        assert all(np.isfinite(v) for v in metrics.values()), key


def _keys(tree):
    """Nested key sets of a JSON object (lists by their first element)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], (dict, list)):
        return [_keys(tree[0])]
    return None


@pytest.mark.parametrize("stage", ["dwi", "dce", "fusion"])
def test_run_metrics_json_matches_jax(runs, stage):
    files = {name: runs[name]["results"] / stage / "fold_0" / "metrics.json"
             for name in ("port", "jax")}
    ours, theirs = (json.loads(files[n].read_text()) for n in ("port", "jax"))
    assert _keys(ours) == _keys(theirs)
    assert ours["parameters"] == theirs["parameters"]
    assert ours["parameters"]["dwi_model_parameters"]["channels"] == [8, 16, 32]
    ckpt = runs["port"]["results"] / stage / "fold_0" / "checkpoints"
    assert (ckpt / "best.pt").exists() and (ckpt / "last.pt").exists()


def test_debug_suite_passes():
    out = run_cli(cli.main, ["debug-suite", "--tiny", "--device", "cpu", "--fusion"])
    assert out.count("ALL PASS") == 3 and "[FAIL]" not in out


def _trained(runs, stage, prefix=""):
    ckpt = runs["port"]["results"] / stage / "fold_0" / "checkpoints" / "best.pt"
    model = torch.load(ckpt, weights_only=True)["model"]
    return str(ckpt), {k[len(prefix):]: v for k, v in model.items() if k.startswith(prefix)}


def _port_config(runs):
    return cli.load_config(cli.build_parser().parse_args(runs["argv"]))


def _fresh_fusion(cfg):
    dwi, _ = build_single_model(cfg, "dwi", device="cpu")
    dce, _ = build_single_model(cfg, "dce", device="cpu")
    return build_fusion_state(cfg, TrainState.create(dwi), TrainState.create(dce)).model


# the alpha-blend scalars and norms that only the port's backbone-less encoder
# holds (tests/test_torch_train.py::port_only_params): JAX's importer reads none
PORT_ONLY = ("f2_weight", "f3_weight", "norm_f2.", "norm_f3.")


def test_export_ckpt_fusion(runs, tmp_path):
    cfg = _port_config(runs)
    best, _ = _trained(runs, "fusion")
    stem = str(tmp_path / "fold0.ckpt")
    out = run_cli(cli.main, ["export-ckpt", "--tiny", "--device", "cpu", "--config",
                             runs["argv"][2], "--method", "fusion", "--checkpoint", best,
                             "--out", stem])
    assert out.count("wrote") == 3
    fresh = _fresh_fusion(cfg)
    jcfg = JConfig.from_dict(cfg.to_dict())
    xd, xc = volumes(0, size=32)
    _, (vd, vc, vf), _ = fusion_stack(jcfg, xd, xc)
    importers = {"dwi": (ref_ckpt.import_reference_encoder, ref_ckpt.export_reference_encoder,
                         vd),
                 "dce": (ref_ckpt.import_reference_encoder, ref_ckpt.export_reference_encoder,
                         vc),
                 "fusion": (ref_ckpt.import_reference_fusion, ref_ckpt.export_reference_fusion,
                            vf)}
    for name, (jimport, jexport, template) in importers.items():
        path = str(tmp_path / f"fold0_{name}.ckpt")
        assert os.path.exists(path)
        _, trained = _trained(runs, "fusion", name + ".")
        # strictly into a fresh port model: every tensor the trained one
        part = getattr(fresh, name)
        load_reference_state_dict(part, load_lightning_ckpt(path))
        for k, v in part.state_dict().items():
            assert torch.equal(v, trained[k]), (name, k)
        # JAX's importer reads the port's weights back: its re-export loads
        # into the port as the trained tensors (the port-only blend excepted)
        jvars = jimport(load_lightning_ckpt(path), jax_zeros(template))
        again = getattr(_fresh_fusion(cfg), name)
        load_reference_state_dict(again, jexport(jvars))
        for k, v in again.state_dict().items():
            if not k.startswith(PORT_ONLY):
                assert torch.equal(v, trained[k]), (name, k)


def jax_zeros(variables):
    import jax

    return jax.tree.map(lambda a: np.zeros(np.shape(a), np.asarray(a).dtype), variables)


def test_export_ckpt_single(runs, tmp_path):
    cfg = _port_config(runs)
    best, trained = _trained(runs, "dwi")
    out = str(tmp_path / "dwi.ckpt")
    run_cli(cli.main, ["export-ckpt", "--tiny", "--device", "cpu", "--config", runs["argv"][2],
                       "--method", "dwi", "--checkpoint", best, "--out", out])
    model, _ = build_single_model(cfg, "dwi", device="cpu")
    report = load_reference_state_dict(model, load_lightning_ckpt(out))
    assert report["dropped"] and all(k.startswith(("mask_head.down_", "f1_to_f2.", "f2_to_f3."))
                                     for k in report["dropped"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    assert export_reference_encoder(model).keys() == load_lightning_ckpt(out).keys()


def test_device_defaults_to_cuda_without_fallback(monkeypatch):
    args = cli.build_parser().parse_args(["run", "--tiny"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--tiny", "--folds", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["debug-suite", "--tiny"])


def test_parallel_folds_equal_sequential_folds(tmp_path):
    """``run --parallel-folds --folds 0 1`` (each modality's folds in one
    call) against ``run --folds 0 1``, each on its own store: the same
    summary, and per fold and modality the same ``metrics.json`` (wall
    times and the store's path aside) and best checkpoint, bit for bit."""
    out, texts = {}, {}
    for name, extra in (("par", ["--parallel-folds"]), ("seq", [])):
        texts[name] = run_cli(cli.main, [
            "run", "--tiny", "--device", "cpu", "--folds", "0", "1", "--epochs", "2",
            "--base-path", str(tmp_path / name / "data"),
            "--results-dir", str(tmp_path / name / "results")] + extra)
        out[name] = summary_of(texts[name])
    assert texts["par"].count("fold-parallel training") == 2
    assert "fold-parallel" not in texts["seq"]
    assert out["par"] == out["seq"]
    assert sorted(out["par"]) == ["fold0_dce", "fold0_dwi", "fold1_dce", "fold1_dwi"]

    def comparable(tree):
        """Without the wall times and the store's path."""
        if isinstance(tree, dict):
            return {k: comparable(v) for k, v in tree.items()
                    if not k.endswith("_time") and k != "base_path"}
        return tree

    for method in ("dwi", "dce"):
        for fold in (0, 1):
            run = {name: tmp_path / name / "results" / method / f"fold_{fold}"
                   for name in ("par", "seq")}
            par, seq = (json.loads((run[n] / "metrics.json").read_text()) for n in ("par", "seq"))
            assert "train_time" in par["train_metrics"]
            assert comparable(par) == comparable(seq), (method, fold)
            best = {n: torch.load(run[n] / "checkpoints" / "best.pt", weights_only=True)
                    for n in ("par", "seq")}
            for k in ("model", "mu", "nu"):
                assert best["par"][k].keys() == best["seq"][k].keys()
                for key, t in best["par"][k].items():
                    assert torch.equal(t, best["seq"][k][key]), (method, fold, k, key)
            assert torch.equal(best["par"]["count"], best["seq"]["count"])
            assert best["par"]["step"] == best["seq"]["step"] > 0


def test_parallel_folds_over_one_fold_runs(tmp_path):
    """``run --parallel-folds --folds 0`` takes the per-fold loop, as the JAX
    CLI does for one fold (cli.py:157); it raised before."""
    text = run_cli(cli.main, ["run", "--tiny", "--device", "cpu", "--parallel-folds",
                              "--folds", "0", "--methods", "dwi", "--epochs", "1",
                              "--base-path", str(tmp_path / "data"),
                              "--results-dir", str(tmp_path / "results")])
    summary = summary_of(text)
    assert list(summary) == ["fold0_dwi"]
    assert all(np.isfinite(v) for v in summary["fold0_dwi"].values())


@pytest.mark.parametrize("command", ["bench", "export-serving"])
def test_unported_commands_are_not_registered(command):
    """Both commands once unported are registered now: ``bench`` takes the
    JAX CLI's ``--quick`` and the port's ``--device`` (its runs are in
    ``test_torch_bench.py``); ``export-serving`` exits without its required
    ``--out``."""
    if command == "bench":
        args = cli.build_parser().parse_args(["bench", "--quick", "--device", "cpu"])
        assert (args.command, args.quick, args.device) == ("bench", True, "cpu")
        assert cli.build_parser().parse_args(["bench"]).device == "cuda"
        return
    err = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
        cli.main([command])
    assert "the following arguments are required: --out" in err.getvalue()


def test_ref_params_json_and_pth(tmp_path):
    """``--ref-params`` reads the reference's parameters dict from JSON or a
    torch file, overrides applied after it."""
    from dmf_tpu_torch.config import from_reference_dict, to_reference_dict

    d = to_reference_dict(default_parameters(batch_size=12))
    d["precision"] = "16-mixed"
    (tmp_path / "p.json").write_text(json.dumps(d))
    torch.save(d, tmp_path / "p.pth")
    for name in ("p.json", "p.pth"):
        args = cli.build_parser().parse_args(
            ["run", "--ref-params", str(tmp_path / name), "--batch-size", "4", "--no-compat"])
        cfg = cli.load_config(args)
        assert cfg == from_reference_dict(d, batch_size=4, reference_compat=False)
        assert cfg.precision == "bf16-mixed"
