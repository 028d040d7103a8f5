"""The port's ``fit_single`` and command line over a data mesh of 2 gloo
ranks on the CPU, fp32 at toy geometry (32^2, channels (8, 16, 32), no
backbone, B=8):

* ``fit_single(mesh=)`` beside JAX's ``fit_single(mesh=make_mesh(2, 1))`` on
  the 8 virtual devices of ``tests/conftest.py`` (18 train volumes: a tail
  of 2, one row a rank; the train transforms the identity on both sides: the
  two packages' augmentations draw from different random streams), at the
  bounds of ``test_torch_mesh_fit.py``;
* ``run --tiny --device cpu --mesh 2 --fusion`` under
  ``python -m torch.distributed.run --nproc-per-node 2`` beside the
  single-process run of the same arguments: the same ``metrics.json`` keys,
  its train metrics within the fit bounds, one line an epoch in each log,
  the summary printed once; ``run --parallel-folds --folds 0 1 --mesh 2``
  (a fold a rank) bit-equal per fold to the single-process fold-parallel
  run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import torch_mesh_workers as W
from test_torch_helpers import jax_encoder, port_config, port_encoder, resnet_layers, tiny_cfg
from test_torch_mesh_fit import FIT_RTOL, KEYS, assert_fit_close, assert_params_close

from dmf_tpu import parallel as jparallel
from dmf_tpu import train as jtrain
from dmf_tpu.models.ref_ckpt import export_reference_encoder
from dmf_tpu_torch import default_parameters
from dmf_tpu_torch.models.weights import DROPPED_KEY_PATTERNS, canonical_key

ROOT = Path(__file__).resolve().parents[1]
B = 8


class JaxIdentityProcessor:
    def train_batch(self, key, imgs, adc=None):
        return jnp.asarray(imgs)

    def eval_split(self, imgs, adc=None):
        return np.asarray(imgs)


def single_data(n_train=18, n_val=6, seed=3):
    r = np.random.RandomState(seed)

    def split(n):
        return {"imgs": r.rand(n, 32, 32, 14).astype(np.float32),
                "masks": (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32),
                "labels": (np.arange(n) % 4).astype(np.int64)}

    return split(n_train), split(n_val)


def test_fit_single_over_the_mesh_matches_jax_mesh(tmp_path):
    cfg = tiny_cfg(dropout=0.0, use_backbone=False).replace(batch_size=B)
    train, val = single_data()
    jm, v = jax_encoder(cfg.dwi_model, 14, train["imgs"][:2], seed=61)
    theirs = jtrain.fit_single(cfg, "dwi", jm, jtrain.TrainState.create(v), train, val,
                               JaxIdentityProcessor(), jtrain.SingleModelOptController(cfg, "dwi"),
                               str(tmp_path / "jax"), num_epochs=2, min_epochs=1, viz_every=0,
                               mesh=jparallel.make_mesh(2, 1))
    with resnet_layers((1, 1, 1, 1)):
        final = {canonical_key(k): t for k, t in export_reference_encoder(
            jax.device_get(theirs.state.variables)).items()
            if not DROPPED_KEY_PATTERNS[0].search(k)}
    ranks = W.spawn(tmp_path / "spawn", 2, "fit", kind="single", cfg=port_config(cfg),
                    model=port_encoder(cfg.dwi_model, 14, v)[0], train=train, val=val,
                    workdir=str(tmp_path / "port"))
    for r in ranks:
        assert_fit_close(r["history"], theirs.history, keys=KEYS[:4] + ("train_mask_loss",))
        assert_params_close(r["state"], final)


# ---------------------------------------------------------------- the command line
def run_cli(argv, tmp, nproc=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(nproc)] if nproc else [sys.executable])
    proc = subprocess.run(launch + ["-m", "dmf_tpu_torch.cli"] + argv, cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_cli_run_over_a_two_rank_mesh(tmp_path):
    config = str(tmp_path / "cfg.json")
    default_parameters(test_mode="normal").save(config)
    outs, texts = {}, {}
    for name, extra, nproc in (("mesh", ["--mesh", "2"], 2), ("single", [], None)):
        base = tmp_path / name
        texts[name] = run_cli(["run", "--config", config, "--tiny", "--device", "cpu",
                               "--folds", "0", "--fusion", "--epochs", "2",
                               "--base-path", str(base / "data"),
                               "--results-dir", str(base / "results")] + extra, tmp_path, nproc)
        outs[name] = {m: json.load(open(base / "results" / m / "fold_0" / "metrics.json"))
                      for m in ("dwi", "dce", "fusion")}
        for m in ("dwi", "dce", "fusion"):
            lines = open(base / "results" / m / "fold_0" / "logs" / "metrics.jsonl").readlines()
            assert len(lines) == 2, (name, m)
    # rank 0 alone printed the summary
    assert texts["mesh"].count('"fold0_fusion"') == 1
    for m in ("dwi", "dce", "fusion"):
        got, ref = outs["mesh"][m], outs["single"][m]
        assert got.keys() == ref.keys()
        assert got["train_metrics"].keys() == ref["train_metrics"].keys()
        assert got["test_metrics"].keys() == ref["test_metrics"].keys()
        for k, v in ref["train_metrics"].items():
            if isinstance(v, float) and not k.endswith("_time"):
                np.testing.assert_allclose(got["train_metrics"][k], v, rtol=FIT_RTOL,
                                           atol=1e-6, err_msg=(m, k))


def test_cli_parallel_folds_over_a_two_rank_mesh(tmp_path):
    """``run --parallel-folds --folds 0 1 --mesh 2``: each fold trains on
    its own rank (``fit_single_multifold(mesh=)``), then every fold is
    tested over the mesh; per fold the train metrics (wall times aside) and
    the best checkpoint bit-equal to the single-process fold-parallel run's,
    the same test metric keys."""
    import torch

    config = str(tmp_path / "cfg.json")
    default_parameters(test_mode="normal").save(config)
    for name, extra, nproc in (("mesh", ["--mesh", "2"], 2), ("single", [], None)):
        base = tmp_path / name
        run_cli(["run", "--config", config, "--tiny", "--device", "cpu", "--folds", "0", "1",
                 "--methods", "dwi", "--parallel-folds", "--epochs", "2",
                 "--base-path", str(base / "data"), "--results-dir", str(base / "results")]
                + extra, tmp_path, nproc)
    for fold in (0, 1):
        root = {n: tmp_path / n / "results" / "dwi" / f"fold_{fold}" for n in ("mesh", "single")}
        got, ref = (json.load(open(root[n] / "metrics.json")) for n in ("mesh", "single"))
        assert got["test_metrics"].keys() == ref["test_metrics"].keys()
        assert ({k: v for k, v in got["train_metrics"].items() if not k.endswith("_time")}
                == {k: v for k, v in ref["train_metrics"].items() if not k.endswith("_time")})
        a, b = (torch.load(root[n] / "checkpoints" / "best.pt", weights_only=True)
                for n in ("mesh", "single"))
        for k, t in b["model"].items():
            assert torch.equal(a["model"][k], t), (fold, k)
