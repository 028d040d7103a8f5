"""The port's ``fit_fusion`` over a data mesh of 4 gloo ranks on the CPU
(``torch_mesh_workers``), fp32 at toy geometry (32^2, channels (8, 16, 32),
no backbone, B=8), beside JAX's ``fit_fusion(mesh=make_mesh(4, 1))`` on the 8
virtual devices of ``tests/conftest.py`` and the port's single-process run,
on the same weights and data (16 train, 8 validation volumes, 2 epochs,
dropout 0), at JAX's own mesh bounds (``tests/test_spmd_loop.py:101-120``):
losses, accuracy and gradient norm to rel 2e-3, parameters to rel 5e-3 /
abs 5e-4; one writer (rank 0); a batch size that does not divide over the
mesh raises.  ``test_torch_mesh_run.py`` holds ``fit_single`` and the
command line.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as W
from test_torch_fusion_train import export_all
from test_torch_helpers import fusion_stack, port_config, tiny_cfg

from dmf_tpu import parallel as jparallel
from dmf_tpu import train as jtrain
from dmf_tpu_torch.train.fusion import FusionNetwork

B = 8
FIT_RTOL = 2e-3  # tests/test_spmd_loop.py:101-109
PARAM_RTOL, PARAM_ATOL = 5e-3, 5e-4  # :110-120
KEYS = ("train_loss", "train_clf_loss", "val_loss", "val_acc", "train_grad_norm")


def assert_fit_close(got, ref, keys=KEYS):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        for k in keys:
            assert np.isfinite(a[k]), k
            np.testing.assert_allclose(a[k], b[k], rtol=FIT_RTOL, err_msg=k)


def assert_params_close(got, ref):
    shared = [k for k in got if k in ref and not k.endswith("num_batches_tracked")]
    assert len(shared) > 20
    for k in shared:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


# ---------------------------------------------------------------- fit_fusion
def fusion_data(n=24, seed=0):
    r = np.random.RandomState(seed)
    data = {"dwi": r.rand(n, 32, 32, 14).astype(np.float32),
            "dce": r.rand(n, 32, 32, 6).astype(np.float32),
            "masks": (r.rand(n, 32, 32, 1) > 0.8).astype(np.float32),
            "labels": r.randint(0, 4, n).astype(np.int64)}
    return {k: v[:16] for k, v in data.items()}, {k: v[16:] for k, v in data.items()}


@pytest.fixture(scope="module")
def fusion_fits(tmp_path_factory):
    cfg = tiny_cfg(dropout=0.0, use_backbone=False).replace(batch_size=B, unfreeze_timer=1)
    train, val = fusion_data()
    jmods, jvars, pmods = fusion_stack(cfg, train["dwi"][:2], train["dce"][:2],
                                       seeds=(51, 52, 53))
    params = {m: v["params"] for m, v in zip(("dwi", "dce", "fusion"), jvars)}
    stats = {m: v["batch_stats"] for m, v in zip(("dwi", "dce", "fusion"), jvars)}
    jstate = jtrain.TrainState(params=params, batch_stats=stats,
                               opt_state=jtrain.adamw_init(params),
                               step=jnp.zeros((), jnp.int32))
    tmp = tmp_path_factory.mktemp("fusion_fits")
    theirs = jtrain.fit_fusion(cfg, *jmods, jstate, train_data=train, val_data=val,
                               workdir=str(tmp / "jax"), num_epochs=2, min_epochs=1,
                               mesh=jparallel.make_mesh(4, 1), viz_every=0)
    final = export_all(jax.device_get(theirs.state.params),
                       jax.device_get(theirs.state.batch_stats))
    kw = dict(kind="fusion", cfg=port_config(cfg), train=train, val=val,
              workdir=str(tmp / "port"))
    net = FusionNetwork(*pmods)
    single = W.fit(None, model=copy.deepcopy(net), **kw)
    ranks = W.spawn(tmp / "spawn", 4, "fit", model=net, **kw)
    return theirs, final, single, ranks


def test_fit_fusion_over_the_mesh_matches_jax_mesh(fusion_fits):
    theirs, final, single, ranks = fusion_fits
    for r in ranks:
        assert_fit_close(r["history"], theirs.history)
        assert_params_close(r["state"], final)
    assert_fit_close(single["history"], theirs.history)


def test_fit_fusion_over_the_mesh_equals_single_process(fusion_fits):
    _, _, single, ranks = fusion_fits
    for r in ranks:
        assert r["history"][-1].keys() == single["history"][-1].keys()
        assert r["history"][-1]["group_trainable"] == single["history"][-1]["group_trainable"]
        assert_fit_close(r["history"], single["history"],
                         keys=[k for k, v in single["history"][0].items()
                               if isinstance(v, float)])
        assert_params_close(r["state"], single["state"])
        assert (r["best"] is None) == (single["best"] is None)


def test_fit_over_the_mesh_writes_once_and_checks_the_batch(fusion_fits):
    _, _, single, ranks = fusion_fits
    for r in ranks:
        assert r["files"] == single["files"]
        assert r["log_lines"] == single["log_lines"] == 2
        assert "batch_size=5 must divide over the 4-way data axis" in r["error"]
