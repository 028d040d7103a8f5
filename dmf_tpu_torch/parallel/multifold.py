"""Fold-parallel training steps: K folds of one model, counterparts of
``dmf_tpu/parallel/multifold.py``.

The JAX module stacks K train states leaf-wise and vmaps one step over the
fold axis.  The port keeps one module and one
:class:`~dmf_tpu_torch.train.state.TrainState` per fold and runs each
fold's step on its own batch with its own generator, one fold after
another, on one stream.  It does not stack the parameters and vmap the
step, for two reasons:

* the train route's BatchNorm updates its running statistics in place
  (``models/layers.py::BatchNorm2d``), which ``torch.func.vmap`` refuses;
* the JAX module measured no gain from the fold axis on one chip (a v5e:
  the fusion step is already conv-bound at batch 8, and K stacked folds
  only grow the working set, :11-24).

So a "stacked" state or batch is the list of the per-fold ones, and
indexing it is indexing the list.  Metrics come back stacked on a leading
``(K,)`` axis, as the vmapped step returns them.

``mesh=`` (``parallel/mesh.py``) puts the fold axis over the data ranks, as
JAX's ``shard_map`` over the data axis (:27-33): data rank ``r`` steps (or
serves) folds ``r*K/n .. (r+1)*K/n - 1`` of the K it is given
(``Mesh.folds``; K must be a multiple of the data axis's size) and no
others, with no collective: folds never communicate.  Over a model axis the
model ranks of a data rank step its folds alike, whole (``P('data')``
replicates them over the model axis).  A fold's state,
metrics and outputs are those of its owner rank (``Mesh.fold_owner``); the
other ranks' entries for it are NaN, as an inactive fold's metrics.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .mesh import Mesh


def stack_fold_states(states: Sequence) -> List:
    """The per-fold train states as one fold-indexed list (each keeps its
    own model)."""
    return list(states)


def index_fold_state(stacked: Sequence, i: int):
    """Fold ``i``'s train state of a :func:`stack_fold_states` list."""
    return stacked[i]


def stack_fold_batches(batches: Sequence[dict]) -> List[dict]:
    """The per-fold batches as one fold-indexed list.  Unlike the JAX
    module's stacked arrays, the folds' batches may differ in size (a ragged
    tail runs at its short size)."""
    return list(batches)


def _stack_tree(trees: Sequence[Any]) -> Any:
    """Stack per-fold outputs leaf-wise on a new leading axis: tensors by
    ``torch.stack``; dicts, lists and tuples by position; ``None`` stays
    ``None``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_tree(list(leaves)) for leaves in zip(*trees))
    return torch.stack(list(trees))


def _nan_like(tree: Any) -> Any:
    """``tree`` with every floating tensor NaN and every other one 0."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _nan_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_nan_like(v) for v in tree)
    return (torch.full_like(tree, float("nan")) if tree.is_floating_point()
            else torch.zeros_like(tree))


def make_multifold_step(raw_step: Callable, per_fold_hp: bool = False,
                        with_active: bool = False, mesh=None) -> Callable:
    """A train step over K folds from the port's one-fold step.

    ``raw_step(state, batch, generator, hp) -> metrics`` is
    ``make_single_train_step(...)`` or ``make_fusion_train_step(...)``; it
    updates ``state`` in place.  The returned
    ``step(states, batches, generators, hp[, active]) -> metrics`` steps
    fold ``i`` with ``states[i]``, ``batches[i]``, ``generators[i]`` and
    ``hp`` (shared, the reference's one schedule for every fold), or
    ``hp[i]`` with ``per_fold_hp=True`` (each fold's own controller: its own
    plateau or unfreeze).  Metrics are stacked on a leading ``(K,)`` axis.

    ``with_active=True`` adds a trailing sequence of K flags: a fold with
    ``active[i] == 0`` is not stepped, so its state (parameters, BatchNorm
    statistics, AdamW moments, step) and its generator stay bit-identical,
    as the JAX step's select of the pre-step state leaves them.  No step
    computed its metrics: they are NaN (counts 0).  With ``mesh`` each rank
    steps its own folds alone (the module's docstring).
    """
    _check_mesh(mesh)

    def step(states: Sequence, batches: Sequence[dict], generators: Sequence,
             hp, active: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        if with_active != (active is not None):
            raise TypeError("make_multifold_step: pass `active` exactly when "
                            "with_active=True")
        k = len(states)
        if not k == len(batches) == len(generators) or (active is not None and
                                                         len(active) != k):
            raise ValueError("make_multifold_step: one batch, generator (and active flag) "
                             "per fold state")
        hps = list(hp) if per_fold_hp else [hp] * k
        owned = mesh.folds(k) if mesh is not None else range(k)
        out: List[Optional[Dict[str, torch.Tensor]]] = [
            raw_step(states[i], batches[i], generators[i], hps[i])
            if i in owned and (active is None or float(active[i])) else None
            for i in range(k)]
        stepped = [m for m in out if m is not None]
        if not stepped:
            return {}
        unstepped = _nan_like(stepped[0])
        filled = [m if m is not None else unstepped for m in out]
        return _stack_tree(filled)

    return step


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")


def make_multifold_predictor(predictors: Sequence[Callable], mesh=None) -> Callable:
    """The K-fold test phase from per-fold predictors.

    ``predictors[i]`` is fold ``i``'s ``make_single_predictor`` or
    ``make_fusion_predictor`` (each closes over its fold's models, where the
    JAX predictor takes stacked variables).  The returned
    ``predict(inputs, generators) -> (mean, std, aux)`` calls fold ``i``'s
    predictor on ``inputs[i]`` (a sequence of K batches, or one tensor with
    a leading fold axis; a tuple of such per batch input for the fusion
    predictor) with ``generators[i]``, and stacks the outputs on a leading
    ``(K,)`` axis.  With ``mesh`` each rank serves its own folds alone (the
    module's docstring; every fold's outputs must have one shape, as the JAX
    function's stacked ones).
    """
    _check_mesh(mesh)
    predictors = list(predictors)

    def predict(inputs, generators: Sequence):
        k = len(predictors)
        if len(inputs) != k or len(generators) != k:
            raise ValueError("make_multifold_predictor: one input and one generator per "
                             "fold predictor")
        owned = mesh.folds(k) if mesh is not None else range(k)
        outs = [predictors[i](*(inputs[i] if isinstance(inputs[i], tuple) else (inputs[i],)),
                              generators[i]) if i in owned else None
                for i in range(k)]
        mine = outs[owned[0]]
        return _stack_tree([o if o is not None else _nan_like(mine) for o in outs])

    return predict
