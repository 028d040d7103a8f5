"""The port's ``fit_fusion`` and command line over a mesh with a model axis
(tensor parallelism), gloo ranks on the CPU, fp32 at toy geometry (32^2,
channels (8, 16, 32), no backbone, B=8: the cross-attention's 4 heads split
2 a rank):

* ``fit_fusion`` over 2x2 (``torch_mesh_workers``) beside JAX's
  ``fit_fusion(mesh=make_mesh(4, 2))`` on the 8 virtual devices of
  ``tests/conftest.py`` (``TestFitFusionSPMD``, ``tests/test_spmd_loop.py:
  85-120``) and the port's single process, on the same weights and data
  (16 train, 8 validation volumes, 2 epochs, dropout 0): the history to rel
  2e-3, the parameters to rel 5e-3 / abs 5e-4; one writer (global rank 0);
  the best checkpoint holds the whole (gathered) state, which reloads into
  the sharded state and into a fresh one;
* ``run --tiny --device cpu --mesh 1x2 --fusion`` under
  ``python -m torch.distributed.run --nproc-per-node 2`` beside the
  single-process run of the same arguments.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from test_torch_fusion_train import export_all
from test_torch_helpers import fusion_stack, port_config, tiny_cfg
from test_torch_mesh_fit import FIT_RTOL, assert_fit_close, assert_params_close, fusion_data
from test_torch_mesh_run import run_cli

from dmf_tpu import parallel as jparallel
from dmf_tpu import train as jtrain
from dmf_tpu_torch import default_parameters
from dmf_tpu_torch.train import TrainState
from dmf_tpu_torch.train.fusion import FusionNetwork
from dmf_tpu_torch.utils.checkpoint import load_checkpoint

B = 8


@pytest.fixture(scope="module")
def tp_fits(tmp_path_factory):
    cfg = tiny_cfg(dropout=0.0, use_backbone=False).replace(batch_size=B, unfreeze_timer=1)
    train, val = fusion_data(seed=4)
    jmods, jvars, pmods = fusion_stack(cfg, train["dwi"][:2], train["dce"][:2],
                                       seeds=(61, 62, 63))
    params = {m: v["params"] for m, v in zip(("dwi", "dce", "fusion"), jvars)}
    stats = {m: v["batch_stats"] for m, v in zip(("dwi", "dce", "fusion"), jvars)}
    jstate = jtrain.TrainState(params=params, batch_stats=stats,
                               opt_state=jtrain.adamw_init(params),
                               step=jnp.zeros((), jnp.int32))
    tmp = tmp_path_factory.mktemp("tp_fits")
    theirs = jtrain.fit_fusion(cfg, *jmods, jstate, train_data=train, val_data=val,
                               workdir=str(tmp / "jax"), num_epochs=2, min_epochs=1,
                               mesh=jparallel.make_mesh(4, 2), viz_every=0)
    final = export_all(jax.device_get(theirs.state.params),
                       jax.device_get(theirs.state.batch_stats))
    kw = dict(kind="fusion", cfg=port_config(cfg), train=train, val=val,
              workdir=str(tmp / "port"))
    net = FusionNetwork(*pmods)
    single = W.fit(None, model=copy.deepcopy(net), **kw)
    ranks = W.spawn(tmp / "spawn", 4, "fit", n_model=2, model=copy.deepcopy(net), reload=True,
                    **kw)
    return theirs, final, single, ranks, tmp / "port" / "mesh", net


def test_fit_fusion_over_2x2_matches_jax_4x2(tp_fits):
    theirs, final, single, ranks, *_ = tp_fits
    for r in ranks:
        assert_fit_close(r["history"], theirs.history)
        assert_params_close(r["state"], final)
    assert_fit_close(single["history"], theirs.history)


def test_fit_fusion_over_2x2_equals_single_process(tp_fits):
    _, _, single, ranks, *_ = tp_fits
    for r in ranks:
        assert r["history"][-1]["group_trainable"] == single["history"][-1]["group_trainable"]
        assert_fit_close(r["history"], single["history"],
                         keys=[k for k, v in single["history"][0].items()
                               if isinstance(v, float)])
        assert_params_close(r["state"], single["state"])
        assert (r["best"] is None) == (single["best"] is None)
        assert r["files"] == single["files"]
        assert r["log_lines"] == single["log_lines"] == 2
        assert "batch_size=3 must divide over the 2-way data axis" in r["error"]


def test_checkpoint_under_tp_is_the_gathered_state_and_reloads(tp_fits):
    *_, ranks, workdir, net = tp_fits
    sd = torch.load(workdir / "checkpoints" / "best.pt", weights_only=True)
    best = ranks[0]["best"]
    assert sd["model"].keys() == best.keys()
    for k, t in best.items():
        assert torch.equal(sd["model"][k], t), k
    names = [n for n, _ in net.named_parameters()]
    assert sorted(sd["mu"]) == sorted(names)
    for n, p in net.named_parameters():  # the moments whole, as the parameters
        assert sd["mu"][n].shape == sd["nu"][n].shape == p.shape, n
    # into the sharded state on every rank, and into a fresh one
    for r in ranks:
        for k, t in best.items():
            assert torch.equal(r["reloaded"][k], t), k
    fresh = TrainState.create(copy.deepcopy(net), num_groups=4)
    load_checkpoint(str(workdir / "checkpoints" / "best.pt"), fresh)
    for k, t in fresh.model.state_dict().items():
        assert torch.equal(t, best[k]), k


def test_cli_run_over_a_model_axis(tmp_path):
    """``run --tiny --mesh 1x2 --fusion`` on 2 gloo ranks: the summary
    printed once, one writer, the metrics of the single-process run."""
    config = str(tmp_path / "cfg.json")
    default_parameters(test_mode="normal").save(config)
    outs, texts = {}, {}
    for name, extra, nproc in (("tp", ["--mesh", "1x2"], 2), ("single", [], None)):
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
    assert texts["tp"].count('"fold0_fusion"') == 1
    store = torch.load(tmp_path / "tp" / "results" / "fusion" / "fold_0" / "checkpoints" /
                       "fusion_fold0.pt", weights_only=True)
    # the whole cross-attention (16 channels), not a rank's shard
    assert store["fusion.cross_attn_block.cross_attn.in_proj_weight"].shape == (48, 16)
    for m in ("dwi", "dce", "fusion"):
        got, ref = outs["tp"][m], outs["single"][m]
        assert got.keys() == ref.keys()
        assert got["test_metrics"].keys() == ref["test_metrics"].keys()
        for k, v in ref["train_metrics"].items():
            if isinstance(v, float) and not k.endswith("_time"):
                np.testing.assert_allclose(got["train_metrics"][k], v, rtol=FIT_RTOL,
                                           atol=1e-6, err_msg=(m, k))
