"""Core building blocks (NCHW), counterparts of ``dmf_tpu/models/layers.py``.

Module and parameter names follow the reference torch layout that
``dmf_tpu.models.ref_ckpt`` exports (ref_ckpt.py:23-32): ResLite blocks as
``bottlenecks.{i}.{0,1,4,5,7,8}``, ``skip.{0,1}``, ``se.fc.{1,3}`` (1x1
convs), ``reconstruct.conv.{0,1,3}``; mask heads as ``pre``/``out``.

Modes are explicit arguments, as in the JAX modules, and nothing depends
on ``module.train()``: ``train=True`` normalises BatchNorm with the batch's
statistics (updating the running ones) and turns dropout on; ``mc=True``
turns dropout on with BatchNorm on its running statistics.  Dropout masks
come from an explicit ``torch.Generator``, or, on the seed route that every
MC predictor and the exported serving program take, from a
:class:`~..ops.dropout.SeedStream` passed in its place (the same masks on
the CPU and the card, whatever the passes' chunking).  Under ``train=True`` no kernel
wrapper is called: the SE and the residual epilogue take the unfused route,
the JAX modules' own training route (layers.py:388-401).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dropout import SeedStream, seeded_dropout, stream_mask
from ..parallel.mesh import RowShard, active_shard
from ..ops.epilogue import se_epilogue
from ..ops.se import se_scale
from ..ops.resize import global_avg_pool, resize_bilinear


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose mode is the ``train`` argument, not
    ``module.training``; counterpart of ``TorchBatchNorm`` (layers.py:64-131).

    Same parameters and buffers (so reference state dicts load unchanged).
    ``train=False`` normalises with the running statistics; ``train=True``
    with the batch's biased variance, and updates the running mean and the
    Bessel-corrected running variance with momentum 0.1 (torch's semantics,
    which ``TorchBatchNorm`` reproduces).  A map in another dtype than fp32
    parameters (``build.py::forward_in``) is normalised in fp32 and returned
    in its own dtype, as ``TorchBatchNorm`` does.  Under a data mesh's
    :class:`~..parallel.mesh.RowShard` the batch is the global one: see
    :func:`batch_norm_over_group`.
    """

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.weight.dtype == torch.float32 and x.dtype != torch.float32:
            # the compute route on fp32 parameters (build.py::forward_in):
            # fp32 normalisation and statistics, the map back in its dtype
            return self.forward(x.float(), train).to(x.dtype)
        shard = active_shard() if train else None
        if shard is not None:
            return batch_norm_over_group(self, x, shard)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, train, self.momentum if train else 0.0, self.eps)


def batch_norm_over_group(bn: BatchNorm2d, x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """Train-mode BatchNorm over the global batch of which ``x`` holds this
    rank's rows, as GSPMD runs JAX's ``TorchBatchNorm`` (layers.py:115-126,
    its means over the sharded batch axis): two passes, the mean and then the
    mean of the squared deviations from it, each summed over the data group
    by a differentiable all-reduce; the global element count normalises both
    and Bessel-corrects the running variance.  A rank may hold no rows."""
    count = shard.total * x.shape[2] * x.shape[3]
    xf = x.float()
    mean = shard.all_reduce(xf.sum(dim=(0, 2, 3))) / count
    d = xf - mean[None, :, None, None]
    var = shard.all_reduce((d * d).sum(dim=(0, 2, 3))) / count
    y = d * torch.rsqrt(var + bn.eps)[None, :, None, None]
    y = y * bn.weight[None, :, None, None] + bn.bias[None, :, None, None]
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach().to(bn.running_mean.dtype), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(
            (var.detach() * (count / max(count - 1, 1))).to(bn.running_var.dtype), alpha=m)
    return y.to(x.dtype)


def run(seq: Iterable[nn.Module], x: torch.Tensor, train: bool) -> torch.Tensor:
    """Apply the modules of ``seq`` in order, passing ``train`` to the
    BatchNorm layers."""
    for m in seq:
        x = m(x, train) if isinstance(m, BatchNorm2d) else m(x)
    return x


def _uniform(like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Uniform [0, 1) fp32 draws in ``like``'s shape and memory format (so
    the select stays one vectorized pass); under a data mesh's step this
    rank's rows of the global batch's draw."""
    shard = active_shard()
    if shard is not None:
        return shard.uniform_rows(like, generator)
    return torch.empty_like(like, dtype=torch.float32).uniform_(generator=generator)


def dropout(x: torch.Tensor, p: float,
            generator: Union[torch.Generator, SeedStream, None],
            mesh=None, dim: int = -1) -> torch.Tensor:
    """Dropout with an explicit generator: keep with probability ``1-p``,
    scale kept values by ``1/(1-p)`` (flax ``nn.Dropout`` semantics).  A
    :class:`~..ops.dropout.SeedStream` draws the mask of its next site
    (:func:`~..ops.dropout.seeded_dropout`).  ``mesh``: ``x`` is this model
    rank's slice along ``dim`` of a tensor sharded over the mesh's model
    axis; its mask is that slice of the whole tensor's mask, the one process
    draws (every model rank draws the same).  On the seed route no site's
    slice is a contiguous block of the seed order (``dim`` is never the
    first dimension), so the whole mask is drawn and narrowed."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("MC dropout needs a generator")
    if mesh is not None and mesh.n_model > 1:
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * mesh.n_model
        if isinstance(generator, SeedStream):
            # the operator reads the whole tensor's shape and device, no values
            whole = x.new_empty(()).expand(shape)
            keep = stream_mask(whole, p, generator)
        else:
            if not x.is_contiguous():
                raise ValueError("a sharded dropout draws from a torch.Generator on a "
                                 "contiguous slice")
            whole = torch.empty(shape, dtype=torch.float32, device=x.device)
            keep = _uniform(whole, generator) < (1.0 - p)
        keep = keep.narrow(dim, mesh.model_rank * n, n)
        return torch.where(keep, x / (1.0 - p), 0.0)
    if isinstance(generator, SeedStream):
        return seeded_dropout(x, p, generator)
    keep = _uniform(x, generator) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), 0.0)


def conv1x1(cin: int, cout: int, stride: int = 1, bias: bool = False,
            **kw) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=bias, **kw)


def conv3x3(cin: int, cout: int, stride: int = 1, bias: bool = False,
            **kw) -> nn.Conv2d:
    # explicit pad 1: flax SAME differs from torch only for strided convs on
    # even inputs, and the JAX modules pad those explicitly too
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias, **kw)


class SEBlock(nn.Module):
    """Squeeze-excitation returning ``(x * w, w)`` (reference model_module.py:25-47).

    ``fc`` holds the reference's parameters (``fc.1``/``fc.3`` 1x1 convs).
    The eval forward is one call to :func:`~dmf_tpu_torch.ops.se.se_scale`,
    the hand-written kernel on the card and its plain version on the CPU;
    ``train=True`` runs ``fc`` itself, as the JAX module's unfused route.
    """

    def __init__(self, channels: int, reduction: int = 2, **kw):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(channels, mid, 1, **kw),
            nn.GELU(), nn.Conv2d(mid, channels, 1, **kw), nn.Sigmoid())

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if train:
            w = self.fc(x)
            return x * w, w
        if x.is_cuda:  # the kernel takes NHWC maps
            x = x.contiguous(memory_format=torch.channels_last)
        fc = self.fc
        return se_scale(x, fc[1].weight, fc[1].bias, fc[3].weight, fc[3].bias)


class MaskGuidedSpatialAttention(nn.Module):
    """``out = x * (1 + gamma * A)``, A from the predicted mask
    (reference model_module.py:49-97)."""

    def __init__(self, mask_ch: int = 1, hidden_channels: int = 16, **kw):
        super().__init__()
        self.gamma = nn.Parameter(torch.tensor(0.1, **kw))
        self.mask_processor = nn.Sequential(
            conv1x1(mask_ch, hidden_channels, **kw),
            nn.GroupNorm(1, hidden_channels, eps=1e-5, **kw), nn.GELU(),
            conv1x1(hidden_channels, 1, bias=True, **kw), nn.Sigmoid())

    def forward(self, img_features, mask_features):
        mask_up = resize_bilinear(mask_features, img_features.shape[-2:])
        a = self.mask_processor(mask_up).clamp(1e-4, 1.0 - 1e-4)
        return img_features * (1.0 + self.gamma * a), a


class ReconHead(nn.Module):
    """3x3 conv -> BN -> GELU -> 3x3 conv (reference model_module.py:100-125)."""

    def __init__(self, in_ch: int, recon_ch: int = 1, **kw):
        super().__init__()
        self.conv = nn.Sequential(
            conv3x3(in_ch, in_ch, **kw), BatchNorm2d(in_ch, **kw), nn.GELU(),
            conv3x3(in_ch, recon_ch, bias=True, **kw))

    def forward(self, x, train: bool = False):
        return run(self.conv, x, train)


class MaskHeadResize(nn.Module):
    """1x1 proj -> strided-conv chain down to ``out_size`` -> 1x1 out.

    Reference model_module.py:131-215 registers chains for inputs of
    64/128/256/512; like the JAX module, the port builds only the chain its
    input size ``in_size`` uses (a bilinear resize covers other sizes).
    """

    def __init__(self, in_ch: int, in_size: int, mid_ch: int = 64,
                 out_ch: int = 1, out_size: int = 32, **kw):
        super().__init__()
        self.out_size = out_size
        self.pre = conv1x1(in_ch, mid_ch, bias=True, **kw)
        self.chain_name = None
        if in_size in (64, 128, 256, 512) and in_size > out_size:
            layers = []
            s = in_size
            while s > out_size:
                s //= 2
                layers += [conv3x3(mid_ch, mid_ch, stride=2, bias=True, **kw),
                           nn.GELU()]
            self.chain_name = f"down_{in_size}_to_{out_size}"
            self.add_module(self.chain_name, nn.Sequential(*layers))
        self.out = conv1x1(mid_ch, out_ch, bias=True, **kw)

    def forward(self, x):
        x = self.pre(x)
        if self.chain_name is not None:
            x = getattr(self, self.chain_name)(x)
        else:
            x = resize_bilinear(x, (self.out_size, self.out_size))
        return self.out(x)


class ResLiteBlock(nn.Module):
    """Residual bottleneck stack with optional SE and reconstruction head.

    Reference ``ResNetLiteBlock_withRecon`` (model_module.py:220-316).
    ``forward(x, train, mc, generator, recon)`` returns
    ``(features, recon_or_None)``; ``recon=False`` skips the reconstruction
    head (lean MC passes).  With SE the eval epilogue
    ``SE(dropout(gelu(out + identity)))`` is one call to
    :func:`~dmf_tpu_torch.ops.epilogue.se_epilogue`; ``train=True`` runs it
    unfused (layers.py:396-401).
    """

    def __init__(self, in_ch: int, out_ch: int, downsample: bool = False,
                 recon_ch: int = 1, use_se: bool = False, se_reduction: int = 2,
                 dropout: float = 0.4, num_repeats: int = 1,
                 downsample_each_repeat: bool = False, mid_squeeze: int = 2,
                 **kw):
        super().__init__()
        stride = 2 if downsample else 1
        mid = max(out_ch // mid_squeeze, 1)
        self.dropout = dropout
        if stride > 1 or in_ch != out_ch:
            self.skip = nn.Sequential(conv1x1(in_ch, out_ch, stride, **kw),
                                      BatchNorm2d(out_ch, **kw))
        else:
            self.skip = None
        blocks = []
        for i in range(num_repeats):
            b_stride = stride if (downsample_each_repeat or i == 0) else 1
            blocks.append(nn.ModuleDict({
                "0": conv1x1(in_ch if i == 0 else out_ch, mid, b_stride, **kw),
                "1": BatchNorm2d(mid, **kw),
                "4": conv3x3(mid, mid, **kw),
                "5": BatchNorm2d(mid, **kw),
                "7": conv1x1(mid, out_ch, **kw),
                "8": BatchNorm2d(out_ch, **kw),
            }))
        self.bottlenecks = nn.ModuleList(blocks)
        self.se = SEBlock(out_ch, se_reduction, **kw) if use_se else None
        self.reconstruct = ReconHead(out_ch, recon_ch, **kw) if recon_ch > 0 else None

    def forward(self, x, train: bool = False, mc: bool = False,
                generator: Optional[torch.Generator] = None,
                recon: bool = True):
        p = self.dropout if (train or mc) else 0.0
        identity = run(self.skip, x, train) if self.skip is not None else x
        out = x
        for b in self.bottlenecks:
            out = dropout(F.gelu(b["1"](b["0"](out), train)), p, generator)
            out = F.gelu(b["5"](b["4"](out), train))
            out = b["8"](b["7"](out), train)
        if self.se is not None and not train:
            if out.is_cuda:  # the kernel takes NHWC maps
                out = out.contiguous(memory_format=torch.channels_last)
                identity = identity.contiguous(memory_format=torch.channels_last)
            fc = self.se.fc
            out = se_epilogue(out, identity, fc[1].weight, fc[1].bias,
                              fc[3].weight, fc[3].bias, drop_rate=p,
                              generator=generator)
        else:
            out = dropout(F.gelu(out + identity), p, generator)
            if self.se is not None:
                out, _ = self.se(out, train=True)
        r = (self.reconstruct(out, train)
             if (recon and self.reconstruct is not None) else None)
        return out, r


class Projector(nn.Module):
    """Two 1x1 conv+BN+GELU stages (reference model_module.py:323-348)."""

    def __init__(self, in_ch: int, proj_dim: int = 64, **kw):
        super().__init__()
        self.proj = nn.Sequential(
            conv1x1(in_ch, proj_dim, **kw), BatchNorm2d(proj_dim, **kw), nn.GELU(),
            conv1x1(proj_dim, proj_dim, **kw), BatchNorm2d(proj_dim, **kw), nn.GELU())

    def forward(self, x, train: bool = False):
        return run(self.proj, x, train)


class ClassificationHead(nn.Module):
    """Global pool -> L2 normalize -> Linear (reference model_module.py:355-369)."""

    def __init__(self, in_ch: int, num_classes: int, **kw):
        super().__init__()
        self.fc = nn.Linear(in_ch, num_classes, **kw)

    def forward(self, x):
        x = global_avg_pool(x)
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        return self.fc(x)


class FeatureDownAlign(nn.Module):
    """Channel/stride alignment conv+BN+GELU (reference model_module.py:371-396)."""

    def __init__(self, in_ch: int, out_ch: int, downsample: bool = True, **kw):
        super().__init__()
        if in_ch == out_ch and not downsample:
            self.proj = None
            return
        conv = (conv3x3(in_ch, out_ch, stride=2, **kw) if downsample
                else conv1x1(in_ch, out_ch, **kw))
        self.proj = nn.Sequential(conv, BatchNorm2d(out_ch, **kw), nn.GELU())

    def forward(self, x, train: bool = False):
        return x if self.proj is None else run(self.proj, x, train)


class FusionReduce(nn.Module):
    """1x1 conv + BN + GELU channel reduction (reference model_module.py:782-794)."""

    def __init__(self, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.reduce = nn.Sequential(conv1x1(in_ch, out_ch, **kw),
                                    BatchNorm2d(out_ch, **kw), nn.GELU())

    def forward(self, x, train: bool = False):
        return run(self.reduce, x, train)

