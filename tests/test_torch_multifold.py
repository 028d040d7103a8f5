"""Fold-parallel training in the port (``parallel/multifold.py``,
``train/multifold_loop.py``, ``pipeline/run_single.py::
run_single_model_multifold``), fp32 on the CPU at toy geometry (32^2,
channels (8, 16, 32), no backbone, B=4), as ``tests/test_multifold_loop.py``
holds the JAX loop.

* ``fit_single_multifold`` with K=2 folds against ``fit_single`` run once per
  fold: histories (wall times aside), best and final states bit-equal, with
  ragged folds (3 and 4 train batches an epoch, short tails), per-fold
  ``wfl`` weights, ResLite dropout 0.2, a processor that draws from its
  generator, and an aggressive plateau with early stopping;
* the same loop against JAX's ``fit_single_multifold`` on the same weights
  and splits (dropout 0 and an identity train transform on both sides: the
  two packages' random streams differ): per-fold histories to rel 1e-3 and
  the same stop epochs;
* ``make_multifold_step`` with ``with_active`` and ``per_fold_hp`` and
  ``make_multifold_predictor``, the cases of ``tests/test_multifold.py``;
* ``run_single_model_multifold`` for K=2 against ``run_single_model`` per
  fold, and its copied weights against K builds.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_encoder, port_config, port_encoder

from dmf_tpu.config import EarlyStoppingConfig, SchedulerConfig, default_parameters
from dmf_tpu.train import SingleModelOptController as JController, TrainState as JState
from dmf_tpu.train.multifold_loop import fit_single_multifold as j_multifold
from dmf_tpu_torch.data.synthetic import make_synthetic_arrays
from dmf_tpu_torch.evals.predict import make_single_predictor
from dmf_tpu_torch.losses import get_classification_loss_fn, get_mask_loss_fn
from dmf_tpu_torch.parallel import (index_fold_state, make_multifold_predictor,
                                    make_multifold_step, stack_fold_batches,
                                    stack_fold_states)
from dmf_tpu_torch.pipeline import build_single_model, run_single_model
from dmf_tpu_torch.pipeline import run_single as run_single_mod
from dmf_tpu_torch.train import SingleModelOptController, TrainState, fit_single
from dmf_tpu_torch.train.multifold_loop import fit_single_multifold
from dmf_tpu_torch.train.optim import build_group_spec
from dmf_tpu_torch.train.single import make_single_train_step

B, S, C = 4, 32, 14
MAX_EPOCHS = 5


def jax_cfg(dropout):
    """``tests/test_multifold_loop.py``'s toy config: a plateau that fires
    from the second epoch on, and early stopping on the validation loss.
    Its ``min_delta`` is 0.002 here: fold 0's validation loss falls by about
    1e-3 an epoch and fold 1's by 2.4e-3 to 3.5e-3, so fold 0 stops after two
    epochs and fold 1 runs all five."""
    cfg = default_parameters(batch_size=B)
    mc = dataclasses.replace(
        cfg.dwi_model, channels=(8, 16, 32), input_size=S, use_backbone=False, proj_dim=4,
        dropout=dropout, use_se=True,
        scheduler=SchedulerConfig(name="reduce_lr_on_plateau", factor=0.5, patience=0,
                                  min_lr=1e-8, threshold=0.05, monitor="val_loss"))
    return cfg.replace(dwi_model=mc, dce_model=mc, debug_training=False,
                       early_stopping=EarlyStoppingConfig(metric="val_loss", mode="min",
                                                          patience=1, min_delta=0.002))


class NoisyProcessor:
    """A processor whose train transform draws from its generator (uniform
    noise of +-0.05) and whose eval transform is the identity."""

    def train_batch(self, generator, imgs, adc=None):
        x = torch.as_tensor(imgs)
        return x + (torch.rand(x.shape, generator=generator) - 0.5) * 0.1

    def eval_split(self, imgs, adc=None):
        return np.asarray(imgs)


class IdentityProcessor:
    """Both packages' processor for the comparison with JAX."""

    def train_batch(self, rng, imgs, adc=None):
        return imgs if isinstance(imgs, torch.Tensor) else jnp.asarray(imgs)

    def eval_split(self, imgs, adc=None):
        return np.asarray(imgs)


def fold_data(n_train, n_val, seed, class_num=4):
    r = np.random.RandomState(seed)

    def split(n):
        labels = np.arange(n) % class_num
        r.shuffle(labels)
        return {"imgs": r.rand(n, S, S, C).astype(np.float32),
                "masks": (r.rand(n, S, S, 1) > 0.7).astype(np.float32),
                "labels": labels.astype(np.int64)}

    return split(n_train), split(n_val)


# ragged folds: 10 and 14 train volumes (3 and 4 batches of 4, short tails),
# 6 and 10 validation volumes; class counts differ, so do the wfl weights
FOLDS = [fold_data(10, 6, 60), fold_data(14, 10, 61)]


def built_encoder(cfg):
    return build_single_model(cfg, "dwi", device="cpu")[0]


def untimed(history):
    return [{k: v for k, v in h.items() if not k.endswith("_time")} for h in history]


def assert_states_equal(a, b, what):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), f"{what}: {k}"
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), f"{what}: mu {k}"
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k]), f"{what}: nu {k}"
    assert a.opt_state.count.tolist() == b.opt_state.count.tolist() and a.step == b.step


def test_multifold_loop_equals_sequential_fits(tmp_path):
    cfg = port_config(jax_cfg(dropout=0.2))
    model = built_encoder(cfg)
    seq = [fit_single(cfg, "dwi", TrainState.create(copy.deepcopy(model)), tr, va,
                      NoisyProcessor(), SingleModelOptController(cfg, "dwi"),
                      str(tmp_path / f"seq{i}"), num_epochs=MAX_EPOCHS, min_epochs=1, seed=0)
           for i, (tr, va) in enumerate(FOLDS)]
    par = fit_single_multifold(
        cfg, "dwi", [TrainState.create(copy.deepcopy(model)) for _ in FOLDS],
        [tr for tr, _ in FOLDS], [va for _, va in FOLDS], [NoisyProcessor() for _ in FOLDS],
        [SingleModelOptController(cfg, "dwi") for _ in FOLDS],
        [str(tmp_path / f"par{i}") for i in range(len(FOLDS))], num_epochs=MAX_EPOCHS,
        min_epochs=1, seed=0)
    for i, (s, p) in enumerate(zip(seq, par)):
        assert untimed(p.history) == untimed(s.history), f"fold {i}"
        assert_states_equal(p.state, s.state, f"fold {i} final")
        assert_states_equal(p.best_state, s.best_state, f"fold {i} best")
        assert p.step_ms == s.step_ms == []
        for rel in ("checkpoints/best.pt", "checkpoints/last.pt", "logs/metrics.jsonl"):
            assert (tmp_path / f"par{i}" / rel).exists(), rel
    # the case is a race: the folds stop at different epochs, the plateau
    # fires, and the folds' epochs have different numbers of steps
    assert [len(p.history) for p in par] == [2, MAX_EPOCHS]
    assert [p.state.step for p in par] == [2 * 3, MAX_EPOCHS * 4]
    assert par[1].history[-1]["group_lrs"][1] < par[1].history[0]["group_lrs"][1]


def test_multifold_loop_matches_jax(tmp_path):
    jcfg = jax_cfg(dropout=0.0)
    cfg = port_config(jcfg)
    # on these weights, too, fold 0 stops after two epochs and fold 1 runs five
    jm, v = jax_encoder(jcfg.dwi_model, C, FOLDS[0][0]["imgs"][:2], seed=2)
    theirs = j_multifold(
        jcfg, "dwi", jm, [JState.create(jax.tree.map(jnp.array, v)) for _ in FOLDS],
        [tr for tr, _ in FOLDS], [va for _, va in FOLDS], [IdentityProcessor() for _ in FOLDS],
        [JController(jcfg, "dwi") for _ in FOLDS],
        [str(tmp_path / f"jax{i}") for i in range(len(FOLDS))], num_epochs=MAX_EPOCHS,
        min_epochs=1, seed=0)
    ours = fit_single_multifold(
        cfg, "dwi", [TrainState.create(port_encoder(jcfg.dwi_model, C, v)[0]) for _ in FOLDS],
        [tr for tr, _ in FOLDS], [va for _, va in FOLDS], [IdentityProcessor() for _ in FOLDS],
        [SingleModelOptController(cfg, "dwi") for _ in FOLDS],
        [str(tmp_path / f"port{i}") for i in range(len(FOLDS))], num_epochs=MAX_EPOCHS,
        min_epochs=1, seed=0)
    for i, (t, o) in enumerate(zip(theirs, ours)):
        assert len(o.history) == len(t.history), f"fold {i}: stop epochs differ"
        for e, (a, b) in enumerate(zip(o.history, t.history)):
            for key in ("train_loss", "val_loss", "val_acc", "lr_scale", "group_lrs"):
                np.testing.assert_allclose(a[key], b[key], rtol=1e-3,
                                           err_msg=f"fold {i} epoch {e} {key}")
    assert [len(o.history) for o in ours] == [2, MAX_EPOCHS]


# ---------------------------------------------------------------- the step and predictor
def fold_states(cfg, seeds):
    states = []
    for seed in seeds:
        model, _ = build_single_model(cfg, "dwi", device="cpu",
                                      generator=torch.Generator().manual_seed(seed))
        states.append(TrainState.create(model))
    return states


def step_batch(seed):
    r = np.random.RandomState(seed)
    return {"imgs": torch.from_numpy(r.rand(B, S, S, C).astype(np.float32)),
            "masks": torch.from_numpy((r.rand(B, S, S, 1) > 0.7).astype(np.float32)),
            "labels": torch.from_numpy(r.permutation(B) % 4), "aux_w": 1.0}


def raw_step(cfg, state):
    spec = build_group_spec([n for n, _ in state.model.named_parameters()], False)
    return make_single_train_step(cfg, "dwi", get_classification_loss_fn(
        cfg, np.arange(8) % 4, "dwi"), get_mask_loss_fn(cfg, "dwi"), spec)


def gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def test_multifold_step_active_and_per_fold_hp():
    """An inactive fold's state and generator stay bit-identical and its
    metrics are NaN; an active fold equals its own step; ``per_fold_hp``
    gives each fold its own hyperparameters (fold 0 as with the shared
    ones, fold 1 at 10x the lr diverges)."""
    cfg = port_config(jax_cfg(dropout=0.2))
    hp = SingleModelOptController(cfg, "dwi").hyperparams()
    states = fold_states(cfg, (1, 2))
    alone = [s.copy() for s in states]
    raw = raw_step(cfg, states[0])
    stacked = stack_fold_states(states)
    batches = stack_fold_batches([step_batch(0), step_batch(1)])
    before = copy.deepcopy(index_fold_state(stacked, 1))
    g = gens((5, 6))
    g1 = g[1].get_state()
    metrics = make_multifold_step(raw, with_active=True)(stacked, batches, g, hp, [1.0, 0.0])
    assert metrics["loss"].shape == (2,) and torch.isnan(metrics["loss"][1])
    assert_states_equal(index_fold_state(stacked, 1), before, "inactive fold")
    assert torch.equal(g[1].get_state(), g1)
    own = raw(alone[0], step_batch(0), gens((5,))[0], hp)
    assert_states_equal(stacked[0], alone[0], "active fold")
    assert torch.equal(metrics["loss"][0], own["loss"])

    shared, per = (fold_states(cfg, (3, 3)) for _ in range(2))
    same = stack_fold_batches([step_batch(2)] * 2)
    make_multifold_step(raw)(shared, same, gens((7, 7)), hp)
    hp10 = hp._replace(lr=hp.lr * 10.0)
    m = make_multifold_step(raw, per_fold_hp=True)(per, same, gens((7, 7)), [hp, hp10])
    assert m["loss"].shape == (2,) and torch.equal(m["loss"][0], m["loss"][1])
    assert_states_equal(per[0], shared[0], "per-fold hp, fold 0")
    assert_states_equal(shared[1], shared[0], "shared hp, same inputs")
    p0, p1 = dict(per[0].model.named_parameters()), dict(per[1].model.named_parameters())
    assert any(not torch.equal(p0[k], p1[k]) for k in p0)
    # the fold axis over a data mesh runs in test_torch_mesh.py; a mesh of
    # another kind is refused
    with pytest.raises(TypeError, match="Mesh"):
        make_multifold_step(raw, mesh=object())


def test_multifold_predictor_equals_per_fold():
    cfg = port_config(jax_cfg(dropout=0.2)).replace(mc_passes=3)
    models = [s.model for s in fold_states(cfg, (1, 2))]
    preds = [make_single_predictor(cfg, m, mode="tta_mc") for m in models]
    imgs = torch.rand(2, 3, S, S, C, generator=torch.Generator().manual_seed(0))
    seq = [preds[i](imgs[i], gens((10 + i,))[0]) for i in range(2)]
    mean, std, aux = make_multifold_predictor(preds)(imgs, gens((10, 11)))
    assert mean.shape == (2, 3, 4)
    for i in range(2):
        assert torch.equal(mean[i], seq[i][0]) and torch.equal(std[i], seq[i][1])
        assert torch.equal(aux["mod_attn_map"][i], seq[i][2]["mod_attn_map"])
    assert not torch.equal(mean[0], mean[1])


# ---------------------------------------------------------------- the pipeline
def test_run_single_model_multifold_equals_per_fold_runs(tmp_path, monkeypatch):
    """Each fold's result has ``run_single_model``'s keys and values (wall
    times aside), each on its own store; the K copies of the one build equal
    K builds and are K models."""
    raw = make_synthetic_arrays(n_train=36, n_test=8, image_size=S, mask_size=S, seed=4)
    cfg = port_config(jax_cfg(dropout=0.2)).replace(segnum=3, mc_passes=2)

    def store(name):
        base = tmp_path / name / "data"
        base.mkdir(parents=True)
        np.savez(base / "dwi_tensordata.npz", imgs=raw["dwi"], test_imgs=raw["dwi_test"],
                 labels=raw["labels"], test_labels=raw["labels_test"], masks=raw["masks"])
        return cfg.replace(base_path=str(base))

    starts = []
    real = run_single_mod.fit_single_multifold

    def spy(cfg, method, states, *a, **kw):
        starts.extend((s.model, copy.deepcopy(s.model.state_dict())) for s in states)
        return real(cfg, method, states, *a, **kw)

    monkeypatch.setattr(run_single_mod, "fit_single_multifold", spy)
    pcfg = store("par")
    par = run_single_mod.run_single_model_multifold(
        pcfg, "dwi", [0, 2], num_epochs=3, min_epochs=1, base_dir=str(tmp_path / "par" / "r"),
        device="cpu")
    scfg = store("seq")
    built = build_single_model(scfg, "dwi", device="cpu")[0].state_dict()
    assert len(starts) == 2 and starts[0][0] is not starts[1][0]
    for _, sd in starts:
        assert sd.keys() == built.keys()
        assert all(torch.equal(sd[k], built[k]) for k in sd)
    assert list(par) == [0, 2]
    for fold in (0, 2):
        seq = run_single_model(scfg, "dwi", fold, num_epochs=3, min_epochs=1,
                               base_dir=str(tmp_path / "seq" / "r"), device="cpu")
        ours = par[fold]
        assert ours.keys() == seq.keys()
        assert untimed(ours["history"]) == untimed(seq["history"])
        assert untimed([ours["train_metrics"]]) == untimed([seq["train_metrics"]])
        assert ours["test_metrics"] == seq["test_metrics"]
        for k in ("test_probs", "test_std", "modality_attention"):
            np.testing.assert_array_equal(ours[k], seq[k], err_msg=k)
        assert_states_equal(ours["state"], seq["state"], f"fold {fold} best")
        assert_states_equal(ours["final_state"], seq["final_state"], f"fold {fold} final")
        assert ours["step_ms"] == seq["step_ms"] == []
        assert ours["best_checkpoint"].endswith(f"dwi/fold_{fold}/checkpoints/best.pt")
    assert par[0]["final_state"].model is not par[2]["final_state"].model
