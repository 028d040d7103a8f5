"""Train state placement and the SPMD train step, counterpart of
``dmf_tpu/parallel/sharding.py``.

JAX annotates shardings at the jit boundary and lets GSPMD insert the
collectives.  The port replicates the train state over the data axis
(broadcast from rank 0), shards it over the model axis by
:func:`param_spec` (the layers of ``parallel/tensor.py`` swapped in, the
AdamW moments sliced alike), and runs the single-process step on each
rank's rows under a :class:`~.mesh.RowShard` (:func:`make_spmd_step`): the
step's BatchNorm, dropout, losses and gradient sum then give the global
batch's step (``parallel/mesh.py``), and the sharded layers' collectives
the whole model's.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, shard_rows
from .tensor import (ShardSpec, gather_full, parameter_shards, sharding_mesh, slice_full,
                     tensor_parallel)

# The port's names of the JAX package's Megatron pairs (sharding.py:21-22).
# Column-parallel: ``attn/qkv`` (the hybrid stage's and the ViT's packed
# ``attn.qkv``), ``mlp/Dense_0`` (the hybrid stage's ``mlp.fc1``; the ViT's
# is ``mlp_fc1`` in JAX and matches nothing) and ``q_proj``/``k_proj``/
# ``v_proj`` (the cross-attention's packed ``in_proj``); both packed ones
# split head-aligned, q, k and v alone.
_COL_PACKED = re.compile(r"(^|\.)(attn\.qkv\.(weight|bias)|cross_attn\.in_proj_(weight|bias))$")
_COL = re.compile(r"(^|\.)transformer\.layers\.\d+\.mlp\.fc1\.(weight|bias)$")
# row-parallel: ``attn/proj``, ``mlp/Dense_1``, ``out_proj`` (weights only)
_ROW = re.compile(r"(^|\.)(attn\.proj|transformer\.layers\.\d+\.mlp\.fc2|cross_attn\.out_proj)"
                  r"\.weight$")
# the SE MLPs are Dense layers in JAX (layers.py:187-189), 1x1 convs here
_SE_MLP = re.compile(r"(^|\.)(se|modality_attention|fusion_se)\.fc\.[13]\.weight$")


def param_spec(name: str, param: torch.Tensor, model_size: int) -> Optional[ShardSpec]:
    """The shard of parameter ``name`` over a ``model_size``-way model axis,
    ``None`` for a replicated one: the rules of JAX's ``param_spec`` on the
    port's names and torch layouts (a ``Linear`` weight is JAX's kernel
    transposed, a conv weight is ``(Cout, Cin, kh, kw)``).

    * column-parallel weights and biases: dim 0 (JAX's ``P(None, 'model')``
      on an ``(in, out)`` kernel, ``P('model')`` on a bias) where the
      outputs divide; the packed q/k/v ones head-aligned (``packs=3``);
    * row-parallel weights: dim 1 (``P('model', None)``) where the inputs
      divide;
    * conv weights with Cout >= 128 dividing over the axis: dim 0;
    * everything else replicated: conv biases, norms, BatchNorm, the rest.
    """
    if model_size <= 1:
        return None
    if _COL_PACKED.search(name):
        # JAX's test is on the packed leaf (attn/qkv) or on each of q/k/v
        block = param.shape[0] // 3
        ok = (param.shape[0] if ".attn.qkv." in f".{name}" else block) % model_size == 0
        if not ok:
            return None
        if block % model_size:
            raise ValueError(f"{name}: {param.shape[0]} rows do not split head-aligned over "
                             f"the {model_size}-way {MODEL_AXIS} axis")
        return ShardSpec(0, 3)
    if _COL.search(name) and param.shape[0] % model_size == 0:
        return ShardSpec(0)
    if param.dim() == 2 and _ROW.search(name) and param.shape[1] % model_size == 0:
        return ShardSpec(1)
    if (param.dim() == 4 and name.endswith("weight") and not _SE_MLP.search(name)
            and param.shape[0] >= 128 and param.shape[0] % model_size == 0):
        return ShardSpec(0)
    return None


def state_shardings(state, mesh: Mesh) -> Dict[str, Optional[ShardSpec]]:
    """Each parameter's shard (:func:`param_spec`) by name; the AdamW
    moments are sharded as their parameters, BatchNorm statistics, counts
    and step replicated."""
    n = mesh.shape[MODEL_AXIS]
    return {name: param_spec(name, p, n) for name, p in state.model.named_parameters()}


def replicate_state(state, mesh: Mesh, src: int = 0, axis: str = DATA_AXIS):
    """Replicate a :class:`~..train.state.TrainState` over the data axis (or
    over the model axis, a state that is not sharded), in place: its
    parameters (or this model index's shards of them), BatchNorm statistics,
    AdamW moments, per-group counts and step, from rank ``src`` of the
    axis."""
    data = axis == DATA_AXIS
    bcast = mesh.broadcast if data else mesh.model_broadcast
    with torch.no_grad():
        for t in (list(state.model.parameters()) + list(state.model.buffers())
                  + list(state.opt_state.mu.values()) + list(state.opt_state.nu.values())):
            bcast(t, src)
    count, step = (mesh.broadcast_object if data else mesh.model_broadcast_object)(
        (state.opt_state.count, state.step), src)
    state.opt_state.count = np.asarray(count, np.int64).copy()
    state.step = int(step)
    return state


def shard_state(state, mesh: Mesh, src: int = 0):
    """Place a :class:`~..train.state.TrainState` on the mesh, in place:
    replicated over the data axis from data rank ``src``
    (:func:`replicate_state`) and, over a model axis, the whole state of
    model rank 0 sharded by :func:`param_spec` (``parallel/tensor.py``'s
    layers swapped into the model, the AdamW moments sliced alike).  Layers
    already sharded (a fusion network over sharded encoders) stay."""
    replicate_state(state, mesh, src)
    if mesh.n_model == 1:
        return state
    had = parameter_shards(state.model)
    with torch.no_grad():
        for name, t in list(state.model.named_parameters()) + list(
                state.model.named_buffers()):
            if name not in had:
                mesh.model_broadcast(t)
        for name in state.opt_state.mu:
            if name not in had:
                mesh.model_broadcast(state.opt_state.mu[name])
                mesh.model_broadcast(state.opt_state.nu[name])
    shards = tensor_parallel(state.model, mesh)
    params = dict(state.model.named_parameters())
    for name, shard in shards.items():
        if name in had:
            continue
        for moments in (state.opt_state.mu, state.opt_state.nu):
            # in the parameter's memory format, as adamw_init makes them
            moments[name] = torch.empty_like(params[name]).copy_(
                slice_full(moments[name], shard, mesh))
    return state


def full_state_dict(state) -> Dict:
    """``state.state_dict()`` with every sharded parameter and moment
    gathered whole (a collective over the model group: every rank calls
    it); the state dict itself for a state that is not sharded."""
    sd = state.state_dict()
    mesh = sharding_mesh(state.model)
    if mesh is None:
        return sd
    model = dict(sd["model"])
    mu, nu = dict(sd["mu"]), dict(sd["nu"])
    for name, shard in parameter_shards(state.model).items():
        model[name] = gather_full(model[name], shard, mesh)
        mu[name] = gather_full(mu[name], shard, mesh)
        nu[name] = gather_full(nu[name], shard, mesh)
    return dict(sd, model=model, mu=mu, nu=nu)


def full_parameters(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` whole (sharded ones gathered, a
    collective over the model group), detached."""
    shards, mesh = parameter_shards(model), sharding_mesh(model)
    return {n: gather_full(p, shards[n], mesh) if n in shards else p.detach()
            for n, p in model.named_parameters()}


def shard_state_dict(sd: Dict, model: torch.nn.Module) -> Dict:
    """A whole state dict (of :func:`full_state_dict`'s layout) cut to the
    shards of a sharded ``model``."""
    shards, mesh = parameter_shards(model), sharding_mesh(model)
    if not shards:
        return sd
    out = dict(sd)
    for key in ("model", "mu", "nu"):
        if key in sd:
            out[key] = {n: slice_full(t, shards[n], mesh) if n in shards else t
                        for n, t in sd[key].items()}
    return out


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
    """The SPMD step of a single-process train step.

    ``step_fn(state, batch, generator, hp) -> metrics`` is
    ``make_single_train_step(...)`` or ``make_fusion_train_step(...)``.  The
    returned ``step(state, batch, generator, hp)`` takes the *global* batch
    (every rank the same one, as JAX's ``place_batch`` takes it) and the
    same generator state on every rank, runs ``step_fn`` on this rank's rows
    (:meth:`~.mesh.Mesh.rows`) under a :class:`~.mesh.RowShard`, and
    returns the global batch's metrics, equal on every rank.  ``state`` must
    be placed (:func:`shard_state`).
    """
    def step(state, batch, generator, hp):
        total = len(batch["labels"])
        rows = mesh.rows(total)
        local = {k: v[rows] if k != "aux_w" else v for k, v in batch.items()}
        with shard_rows(mesh, total):
            return step_fn(state, local, generator, hp)

    return step
