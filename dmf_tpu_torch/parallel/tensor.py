"""Tensor parallelism over the mesh's model axis: the layers that GSPMD
writes for the JAX package.

JAX annotates each parameter with ``param_spec`` (``dmf_tpu/parallel/
sharding.py:23-56``) and lets GSPMD insert the collectives.  The port runs
one process a rank, so the sharded layers hold their shard of the weight
and run the collectives themselves, over the rank's model group
(``parallel/mesh.py``):

* a wide conv (:class:`ShardedConv2d`) holds its output-channel shard,
  convolves the whole (replicated) input and gathers the channels, so every
  map between layers stays replicated within the model group (BatchNorm,
  GELU, dropout, the SE kernels and the residual adds run on whole maps);
* a column-parallel ``Linear`` (:class:`ColumnParallelLinear`: ``qkv``,
  the hybrid stage's ``fc1``) holds its output rows, a row-parallel one
  (:class:`RowParallelLinear`: ``proj``, ``fc2``, ``out_proj``) its input
  columns and sums the partial products over the model group (Megatron's
  pairs: attention runs on this rank's heads, ``fc1``'s output stays
  sharded into ``fc2``); the cross-attention's packed ``in_proj`` is
  sliced in place.

A packed q/k/v projection is sharded head-aligned: each rank holds the q,
k and v rows of its own heads (:class:`ShardSpec` ``packs=3``), which is
JAX's contiguous split of each of ``q_proj``/``k_proj``/``v_proj``; JAX's
contiguous split of a packed ``qkv`` leaf does not give a rank whole heads
(GSPMD reshards behind it), so the port's shard of ``attn.qkv`` holds other
rows than JAX's, on the same axis.

The gradients follow Megatron: a column-parallel or conv layer's input
gradient is this rank's part of the sum, so its entry is "f" (identity
forward, model-group all-reduce backward); a row-parallel exit is "g"
(all-reduce forward, identity backward); a channel gather's backward keeps
this rank's slice.  Replicated parameters then get the same gradient on
every model rank.  The collectives are those of
:meth:`~.mesh.Mesh.model_all_reduce` and :meth:`~.mesh.Mesh.model_gather`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mesh import memory_format_of


class ShardSpec(NamedTuple):
    """A parameter's shard: the torch ``dim`` split over the model axis, in
    ``packs`` row blocks each split alone (3: the q, k and v blocks of a
    packed projection, so that a rank holds whole heads of each)."""

    dim: int
    packs: int = 1


def shard_index(spec: ShardSpec, size: int, n_model: int, rank: int) -> torch.Tensor:
    """The indices along ``spec.dim`` (of ``size``) that model rank ``rank``
    holds: the ``rank``-th of ``n_model`` contiguous shares of each pack."""
    block = size // spec.packs
    share = block // n_model
    return torch.cat([torch.arange(p * block + rank * share, p * block + (rank + 1) * share)
                      for p in range(spec.packs)])


# ---------------------------------------------------------------- autograd
class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, the model-group sum of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.model_all_reduce(grad.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the model-group sum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The model group's slices along ``dim`` gathered; the backward keeps
    this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.model_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.narrow(ctx.dim, ctx.mesh.model_rank * ctx.n, ctx.n)
        return part.contiguous(memory_format=memory_format_of(grad)), None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh, dim)


# ---------------------------------------------------------------- layers
def _shard_param(p: nn.Parameter, spec: ShardSpec, mesh) -> nn.Parameter:
    idx = shard_index(spec, p.shape[spec.dim], mesh.n_model, mesh.model_rank)
    local = p.detach().index_select(spec.dim, idx.to(p.device))
    if p.dim() == 4:
        # a conv weight keeps its strides, those of its size-1 dims too: a
        # 1x1 weight's are ambiguous, and cuDNN picks the output's memory
        # format (the order of the next dropout's draws) from them
        local = torch.empty_like(p.detach().narrow(spec.dim, 0, len(idx))).copy_(local)
    return nn.Parameter(local, requires_grad=p.requires_grad)


class ShardedConv2d(nn.Module):
    """An ``nn.Conv2d`` whose weight holds this rank's output channels: the
    conv of the whole input on them, the channels gathered over the model
    group, then the (replicated) bias.  :meth:`channels` and :meth:`gather`
    let a fused eval route (the neck's kernel 2) run on the shard."""

    def __init__(self, conv: nn.Conv2d, mesh, spec: ShardSpec):
        super().__init__()
        if conv.groups != 1 or spec != ShardSpec(0):
            raise ValueError(f"a sharded conv splits the output channels of an ungrouped "
                             f"conv, got groups={conv.groups}, {spec}")
        self.mesh = mesh
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation = conv.dilation
        self.out_channels = conv.out_channels
        self.weight = _shard_param(conv.weight, spec, mesh)
        self.bias = conv.bias
        self.tp_shards = {"weight": (spec, conv.out_channels)}
        n = self.weight.shape[0]
        self.lo, self.hi = mesh.model_rank * n, (mesh.model_rank + 1) * n

    def channels(self, *tensors: Optional[torch.Tensor]) -> Tuple[Optional[torch.Tensor], ...]:
        """This rank's channels of per-channel tensors (a bias, BatchNorm's)."""
        return tuple(None if t is None else t[self.lo:self.hi] for t in tensors)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The whole map from this rank's channels of it."""
        return gather_from_model(y, self.mesh, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(copy_to_model(x, self.mesh), self.weight, None, self.stride,
                     self.padding, self.dilation)
        y = self.gather(y)
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1).to(y.dtype)


class ColumnParallelLinear(nn.Module):
    """A ``Linear`` holding this rank's output rows (and their bias); its
    output is this rank's slice of the features (``mesh.model_rank``-th
    share of each pack)."""

    def __init__(self, linear: nn.Linear, mesh, spec: ShardSpec):
        super().__init__()
        self.mesh = mesh
        self.weight = _shard_param(linear.weight, spec, mesh)
        self.bias = (None if linear.bias is None else _shard_param(linear.bias, spec, mesh))
        self.tp_shards = {"weight": (spec, linear.out_features)}
        if self.bias is not None:
            self.tp_shards["bias"] = (spec, linear.out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(copy_to_model(x, self.mesh), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """A ``Linear`` holding this rank's input columns: the partial product
    summed over the model group, then the (replicated) bias."""

    def __init__(self, linear: nn.Linear, mesh, spec: ShardSpec):
        super().__init__()
        self.mesh = mesh
        self.weight = _shard_param(linear.weight, spec, mesh)
        self.bias = linear.bias
        self.tp_shards = {"weight": (spec, linear.in_features)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_model(F.linear(x, self.weight), self.mesh)
        return y if self.bias is None else y + self.bias


def model_mesh(module: nn.Module):
    """The mesh of a sharded layer, ``None`` for a whole one."""
    return module.mesh if isinstance(module, (ShardedConv2d, ColumnParallelLinear,
                                              RowParallelLinear)) else None


def local_heads(module: nn.Module, heads: int) -> int:
    """This rank's heads (the ``model_rank``-th share of ``heads``) of an
    attention whose q/k/v projection is ``module``; all on a whole layer."""
    mesh = model_mesh(module)
    return heads if mesh is None else heads // mesh.n_model


# ---------------------------------------------------------------- the swap
_LINEAR = {0: ColumnParallelLinear, 1: RowParallelLinear}


def _check_heads(name: str, heads: int, mesh) -> None:
    if heads % mesh.n_model:
        raise ValueError(f"{name}: {heads} heads do not split head-aligned over the "
                         f"{mesh.n_model}-way model axis")


def tensor_parallel(model: nn.Module, mesh) -> Dict[str, Tuple[ShardSpec, int]]:
    """Swap the sharded layers into ``model`` in place, as
    ``sharding.param_spec`` shards its parameters over ``mesh``'s model axis;
    returns :func:`parameter_shards`.  The model must hold the same whole
    weights on every model rank; layers already sharded (a model that holds
    sharded encoders beside a new head) are left as they are.  Parameter
    names do not change."""
    from .sharding import param_spec

    if mesh.n_model == 1:
        return {}
    swaps = []
    for name, module in model.named_modules():
        if getattr(module, "tp_shards", None):
            continue
        specs = {p: param_spec(f"{name}.{p}" if name else p, t, mesh.n_model)
                 for p, t in module.named_parameters(recurse=False)}
        specs = {p: s for p, s in specs.items() if s is not None}
        if not specs:
            continue
        w = specs.get("weight") or specs.get("in_proj_weight")
        if isinstance(module, nn.Conv2d) and set(specs) == {"weight"}:
            swaps.append((name, ShardedConv2d(module, mesh, w)))
        elif isinstance(module, nn.Linear) and w is not None and w.dim in _LINEAR:
            if w.packs > 1:
                owner = model.get_submodule(name.rpartition(".")[0])
                _check_heads(name, owner.num_heads, mesh)
            want = w if w.dim == 0 and module.bias is not None else None
            if specs.get("bias") != want:
                raise ValueError(f"{name}: its bias is not sharded as its weight")
            swaps.append((name, _LINEAR[w.dim](module, mesh, w)))
        elif isinstance(module, nn.MultiheadAttention) and set(specs) == {
                "in_proj_weight", "in_proj_bias"}:
            _check_heads(name, module.num_heads, mesh)
            module.mesh = mesh
            module.in_proj_weight = _shard_param(module.in_proj_weight, w, mesh)
            module.in_proj_bias = _shard_param(module.in_proj_bias, w, mesh)
            module.tp_shards = {k: (w, 3 * module.embed_dim)
                                for k in ("in_proj_weight", "in_proj_bias")}
        else:
            raise ValueError(f"{name} ({type(module).__name__}): no sharded layer for the "
                             f"specs {specs}")
    for name, new in swaps:
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, child, new)
    return parameter_shards(model)


def parameter_shards(model: nn.Module) -> Dict[str, Tuple[ShardSpec, int]]:
    """``{parameter name: (its ShardSpec, the whole size along the dim)}``
    of the sharded parameters of ``model`` (empty for a whole model)."""
    out = {}
    for name, module in model.named_modules():
        for p, shard in getattr(module, "tp_shards", {}).items():
            out[f"{name}.{p}" if name else p] = shard
    return out


def sharding_mesh(model: nn.Module):
    """The mesh over whose model axis ``model`` is sharded, or ``None``."""
    for module in model.modules():
        if getattr(module, "tp_shards", None):
            return module.mesh
    return None


def gather_full(t: torch.Tensor, shard: Tuple[ShardSpec, int], mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's shard, on every rank."""
    spec, size = shard
    parts = mesh.model_gather(t.detach().contiguous(), spec.dim)
    if spec.packs == 1:
        return parts
    order = torch.cat([shard_index(spec, size, mesh.n_model, r) for r in range(mesh.n_model)])
    full = torch.empty_like(parts)
    full.index_copy_(spec.dim, order.to(t.device), parts)
    return full


def slice_full(t: torch.Tensor, shard: Tuple[ShardSpec, int], mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t``."""
    spec, size = shard
    return t.index_select(spec.dim, shard_index(spec, size, mesh.n_model,
                                                mesh.model_rank).to(t.device))
