"""Train state placement and the data-parallel train step, the data axis of
``dmf_tpu/parallel/sharding.py``.

JAX annotates shardings at the jit boundary and lets GSPMD insert the
gradient all-reduce.  The port replicates the train state on every data
rank (:func:`shard_state`, broadcast from rank 0) and runs the
single-process step on each rank's rows under a
:class:`~.mesh.RowShard` (:func:`make_spmd_step`): the step's BatchNorm,
dropout, losses and gradient sum then give the global batch's step
(``parallel/mesh.py``).  The model axis (``param_spec``,
``state_shardings``: tensor parallelism) is not ported (ROADMAP 1.13b).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from .mesh import Mesh, broadcast_exact, shard_rows


def shard_state(state, mesh: Mesh, src: int = 0):
    """Replicate a :class:`~..train.state.TrainState` on every data rank, in
    place: its parameters, BatchNorm statistics, AdamW moments, per-group
    counts and step, from data rank ``src``."""
    mesh.broadcast_module(state.model, src)
    with torch.no_grad():
        for name in state.opt_state.mu:
            broadcast_exact(mesh, state.opt_state.mu[name], src)
            broadcast_exact(mesh, state.opt_state.nu[name], src)
    count, step = mesh.broadcast_object((state.opt_state.count, state.step), src)
    state.opt_state.count = np.asarray(count, np.int64).copy()
    state.step = int(step)
    return state


def reduce_gradients(grads: List[Optional[torch.Tensor]], mesh: Mesh) -> None:
    """Sum the gradients over the data group, in place, in one all-reduce
    (each rank's loss already carries its share of the global mean)."""
    present = [g for g in grads if g is not None]
    if not present:
        return
    flat = torch.cat([g.reshape(-1).float() for g in present])
    mesh.all_reduce(flat)
    offset = 0
    for g in present:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view(g.shape))
        offset += n


def make_spmd_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """The data-parallel step of a single-process train step.

    ``step_fn(state, batch, generator, hp) -> metrics`` is
    ``make_single_train_step(...)`` or ``make_fusion_train_step(...)``.  The
    returned ``step(state, batch, generator, hp)`` takes the *global* batch
    (every rank the same one, as JAX's ``place_batch`` takes it) and the
    same generator state on every rank, runs ``step_fn`` on this rank's rows
    (:meth:`~.mesh.Mesh.rows`) under a :class:`~.mesh.RowShard`, and
    returns the global batch's metrics, equal on every rank.  ``state`` must
    be replicated (:func:`shard_state`).
    """
    def step(state, batch, generator, hp):
        total = len(batch["labels"])
        rows = mesh.rows(total)
        local = {k: v[rows] if k != "aux_w" else v for k, v in batch.items()}
        with shard_rows(mesh, total):
            return step_fn(state, local, generator, hp)

    return step
