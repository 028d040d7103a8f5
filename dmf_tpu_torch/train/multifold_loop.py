"""Fold-parallel training loop: K folds of one encoder in one call.

Counterpart of ``dmf_tpu/train/multifold_loop.py`` (:77-315).  The JAX loop
vmaps one step over the stacked folds; the port keeps one model and one
:class:`~.state.TrainState` per fold and steps the folds one after another
on one stream (``parallel/multifold.py`` says why).  Each fold is the
:class:`~.loop.FitRun` that ``fit_single`` builds, with its own streams
(augmentation from ``seed``, dropout from ``seed + 1``, the shuffle from
``np.random.RandomState(seed)``), its own ``wfl`` class weights from its
train labels and its own control plane (plateau or warmup-cosine lr, early
stopping with ``min_epochs``, the aux-loss weight, the best and rolling
checkpoints, the logs under its workdir).  :func:`~.loop.drive_lockstep`
runs them epoch by epoch: a fold whose epoch has fewer batches draws
nothing once they are used up, its tail batch runs at its short size, and
a fold that has stopped is skipped in train and validation (the JAX loop
computes and discards those steps).  So each fold's result equals its
``fit_single`` run, bit for bit on the CPU.

Two things differ from the JAX loop, which the port does not follow: it
steps ``WarmupCosine`` once an epoch (:289-290) where its ``fit_single``
steps it once a step, and it writes no rolling checkpoint (ROADMAP 3.6).

``mesh=`` puts the folds on the data ranks (``parallel/multifold.py``): each
data rank drives its own folds alone (on model rank 0, writing their files),
then every fold's result (final and best states, history) is broadcast from
its owner over the data axis and from model rank 0 over the model axis, so
that every rank returns all K, whole (a fold is not sharded over the model
axis, as JAX's ``shard_map`` over ``P('data')`` replicates it there).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..data.modality import ModalityProcessor
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ..parallel.sharding import replicate_state
from .loop import FitResult, drive_lockstep, single_fit_run
from .optim import SingleModelOptController
from .state import TrainState


def fit_single_multifold(cfg: Config, method: str, states: Sequence[TrainState],
                         fold_train: Sequence[Dict[str, Optional[np.ndarray]]],
                         fold_val: Sequence[Dict[str, Optional[np.ndarray]]],
                         processors: Sequence[ModalityProcessor],
                         controllers: Sequence[SingleModelOptController],
                         workdirs: Sequence[str], num_epochs: Optional[int] = None,
                         min_epochs: Optional[int] = None, seed: int = 0,
                         mesh: Optional[Mesh] = None) -> List[FitResult]:
    """Train K folds of one encoder in lockstep; returns one
    :class:`~.loop.FitResult` per fold, equal to K sequential
    :func:`~.loop.fit_single` runs with the same arguments.  ``states``
    carry their models (one per fold, not shared); the other sequences hold
    each fold's own data, processor, controller and workdir.  ``mesh``: the
    folds over its data ranks (K a multiple of its size; the module's
    docstring)."""
    k = len(states)
    if not k == len(fold_train) == len(fold_val) == len(processors) == len(controllers) \
            == len(workdirs):
        raise ValueError("fit_single_multifold: one state, split pair, processor, "
                         "controller and workdir per fold")
    if len({id(s.model) for s in states}) != k:
        raise ValueError("fit_single_multifold: each fold needs its own model")
    # model rank 0 of each data rank drives its folds
    lead = mesh is None or mesh.model_rank == 0
    owned = mesh.folds(k) if mesh is not None else range(k)
    mine = drive_lockstep([
        single_fit_run(cfg, method, states[i], fold_train[i], fold_val[i], processors[i],
                       controllers[i], workdirs[i], num_epochs=num_epochs,
                       min_epochs=min_epochs, seed=seed)
        for i in (owned if lead else ())])
    if mesh is None:
        return mine

    def spread(i, fit, src, axis, bcast_object):
        """Fold ``i``'s result from rank ``src`` of ``axis`` (``fit`` there,
        ``None`` elsewhere)."""
        history, step_ms, has_best = bcast_object(
            (fit.history, fit.step_ms, fit.best_state is not None) if fit else None, src)
        if fit is None:
            best = states[i].copy() if has_best else None
            fit = FitResult(state=states[i], best_state=best, history=history,
                            train_metrics=history[-1] if history else {}, step_ms=step_ms)
        replicate_state(fit.state, mesh, src, axis)
        if has_best:
            replicate_state(fit.best_state, mesh, src, axis)
        return fit

    results = []
    for i in range(k):
        fit = mine[owned.index(i)] if lead and i in owned else None
        if lead:
            fit = spread(i, fit, mesh.fold_owner(i, k), DATA_AXIS, mesh.broadcast_object)
        if mesh.n_model > 1:
            fit = spread(i, fit if lead else None, 0, MODEL_AXIS, mesh.model_broadcast_object)
        results.append(fit)
    return results
