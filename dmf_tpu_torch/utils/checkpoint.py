"""Checkpoints as ``torch.save`` files of a :class:`~..train.state.TrainState`'s
state dict (weights, BatchNorm statistics, AdamW moments, per-group counts,
step); counterpart of ``dmf_tpu/utils/checkpoint.py``.

``BestCheckpointer`` is the reference's ``ModelCheckpoint(monitor='val_acc',
mode='max')`` with its best reload (run_training.py:93-99, 123-131);
``RollingSaver`` the rolling resume file; ``load_checkpoint`` restores either,
or the weights of a reference PyTorch/Lightning checkpoint (whose optimizer
state stays fresh, prepare_single_model.py:208-218).  Over a mesh
(``mesh=``) only global rank 0 writes, and every rank waits for the file at
a barrier.  A file holds the whole state: a state sharded over a model axis
is gathered first (every rank takes part), and is cut to its shards again
when it is loaded.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Optional

import torch

from ..models.weights import load_reference_state_dict
from ..parallel.sharding import full_state_dict, shard_state_dict

if TYPE_CHECKING:  # the train package imports this module
    from ..train.state import TrainState


def save_state(path: str, state: TrainState, write: bool = True) -> None:
    """Write the whole state (``parallel/sharding.py::full_state_dict``:
    a collective for a sharded state, so every rank calls it) where
    ``write``."""
    sd = full_state_dict(state)
    if write:
        torch.save(sd, path)


def _writes(mesh) -> bool:
    """Whether this process writes: always alone, global rank 0 over a mesh."""
    return mesh is None or mesh.writer


def _wait(mesh) -> None:
    if mesh is not None:
        mesh.barrier()


class BestCheckpointer:
    """Keep the single best checkpoint (``best.pt``) by a monitored metric."""

    def __init__(self, directory: str, monitor: str = "val_acc", mode: str = "max",
                 mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        if _writes(mesh):
            os.makedirs(self.directory, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best: Optional[float] = None
        self.best_path = os.path.join(self.directory, "best.pt")

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        return value > self.best if self.mode == "max" else value < self.best

    def maybe_save(self, state: TrainState, metrics: dict, epoch: int) -> bool:
        value = metrics.get(self.monitor)
        if value is None or not self._improved(float(value)):
            return False
        self.best = float(value)
        save_state(self.best_path, state, _writes(self.mesh))
        if _writes(self.mesh):
            with open(os.path.join(self.directory, "best.json"), "w") as f:
                json.dump({"epoch": epoch, self.monitor: self.best}, f)
        _wait(self.mesh)
        return True


class RollingSaver:
    """The rolling resume checkpoint ``last.pt``, written synchronously."""

    def __init__(self, directory: str, name: str = "last", mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        if _writes(mesh):
            os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory, f"{name}.pt")

    def save(self, state: TrainState) -> None:
        save_state(self.path, state, _writes(self.mesh))
        _wait(self.mesh)


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore ``state`` in place from a file of :func:`save_state`, or its
    weights from a reference checkpoint (``.ckpt``/``.pth``: a Lightning
    ``state_dict`` or a bare one, in the reference key layout)."""
    device = next(state.model.parameters()).device
    obj = torch.load(path, map_location=device, weights_only=True)
    if path.endswith((".ckpt", ".pth")):
        load_reference_state_dict(state.model, obj.get("state_dict", obj))
    else:
        state.load_state_dict(shard_state_dict(obj, state.model))
    return state
