"""Grouped AdamW with per-group hyperparameters, counterpart of
``dmf_tpu/train/optim.py``.

The reference adds a param group to its torch optimizer at an unfreeze event
(selector_helpers.py:119-742).  Here, as in the JAX package, each parameter
has a static group id from its name, and the per-group learning rate, weight
decay and trainable flag are host values handed to every step; unfreezing
changes a flag, never the optimizer.  ``torch.optim.AdamW`` with param groups
would not follow the JAX step: its step count is per parameter, not per
group, and it has no notion of a group that is present but frozen.

Semantics (optim.py:191-257):
* a group's step count advances only while it is trainable, so a group
  unfrozen late bias-corrects from step 1, as the reference's fresh group;
* a frozen group and an excluded parameter (group -1) are not updated and
  keep their moments; a parameter without a gradient is skipped, as torch
  skips it;
* decoupled weight decay: ``p -= lr * (mhat / (sqrt(vhat) + eps) + wd * p)``;
* discriminative lr/wd per depth (selector_helpers.py:262-271):
  ``lr_i = base_lr / f^(n-1-i)``, ``wd_i = reg_base * g^(n-1-i)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..parallel.tensor import parameter_shards, sharding_mesh

# ---------------------------------------------------------------------------
# Param grouping (selector_helpers.py:156-181)
# ---------------------------------------------------------------------------


def classify_param(name: str, use_backbone: bool) -> int:
    """A parameter's reference group from its name.

    Groups (n=3): with a backbone 0 = backbone and adapter necks,
    1 = block1 + block2, 2 = block3 + other; without one 0 = block1,
    1 = block2, 2 = block3 + other.  The port's names are in the reference
    layout (``backbone.*``, ``backbone_adapter.necks.*``, ``block1.*``), and
    these substring tests give every parameter the group the JAX package gives
    its Flax path.
    """
    if use_backbone and "backbone" in name:
        return 0
    if "block1" in name:
        return 1 if use_backbone else 0
    if "block2" in name:
        return 1
    return 2  # block3 and 'other'


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Static grouping of one model's parameters."""

    group_ids: Dict[str, int]  # parameter name -> group (-1: excluded)
    num_groups: int
    names: Tuple[str, ...]  # the groups' names, for metrics

    def members(self, gid: int) -> List[str]:
        return [n for n, g in self.group_ids.items() if g == gid]


def build_group_spec(param_names: Sequence[str], use_backbone: bool,
                     reference_compat: bool = True, num_groups: int = 3) -> GroupSpec:
    """Group ids for ``param_names``.  Under ``reference_compat`` the
    ``classification_head`` is in no group (selector_helpers.py:161-162):
    the single model's classifier stays frozen at its initial weights."""
    ids = {n: (-1 if reference_compat and "classification_head" in n
               else classify_param(n, use_backbone)) for n in param_names}
    names = (("backbone", "block1+2", "block3+other") if use_backbone
             else ("block1", "block2", "block3+other"))
    return GroupSpec(group_ids=ids, num_groups=num_groups, names=names)


def build_fusion_group_spec(param_names: Sequence[str], cfg: Config) -> GroupSpec:
    """Group ids over the fusion network's ``dwi.*``, ``dce.*`` and
    ``fusion.*`` parameters (selector_helpers.py:479-490): groups 0-2 are the
    two encoders' depth groups merged, each encoder's parameter classified
    by its own name (:func:`build_group_spec`); group 3 is the fusion head,
    chosen by its prefix (its ``refine`` and ``cross_attn_block`` names would
    match the encoders' substring tests)."""
    ids = {n: 3 for n in param_names if n.startswith("fusion.")}
    for enc in ("dwi", "dce"):
        own = [n[len(enc) + 1:] for n in param_names if n.startswith(enc + ".")]
        spec = build_group_spec(own, cfg.model_config(enc).use_backbone, cfg.reference_compat)
        ids.update({f"{enc}.{n}": g for n, g in spec.group_ids.items()})
    stray = [n for n in param_names if n not in ids]
    if stray:
        raise ValueError(f"not parameters of dwi, dce or fusion: {stray}")
    return GroupSpec(group_ids={n: ids[n] for n in param_names}, num_groups=4,
                     names=("enc_backbone", "enc_block1+2", "enc_block3+other", "fusion_head"))


def describe_groups(params: Dict[str, torch.Tensor], spec: GroupSpec,
                    hp: Optional["GroupedHyperParams"] = None, max_examples: int = 3) -> str:
    """The optimizer-group dump (selector_helpers.py:336-353), the text of
    ``dmf_tpu/train/optim.py::describe_groups``: per group its tensor and
    element counts, the lr, wd and trainable flag of ``hp`` when given, and
    the first ``max_examples`` parameter names."""
    by_group: Dict[int, list] = {}
    for name, p in params.items():
        by_group.setdefault(int(spec.group_ids[name]), []).append((name, p.numel()))
    first = min((g for g in by_group if g >= 0), default=0)
    lines = ["optimizer groups:"]
    for gid in sorted(by_group):
        entries = by_group[gid]
        n_params = sum(n for _, n in entries)
        if gid < 0:
            head = f"  [excluded] {len(entries)} leaves, {n_params:,} params"
        else:
            name = spec.names[gid - first] if gid - first < len(spec.names) else str(gid)
            head = f"  group {gid} ({name}): {len(entries)} leaves, {n_params:,} params"
            if hp is not None:
                head += (f", lr={float(hp.lr[gid]):.2e}"
                         f" wd={float(hp.wd[gid]):.2e}"
                         f" trainable={float(hp.trainable[gid]):.0f}")
        lines.append(head)
        lines.extend(f"      {path}" for path, _ in entries[:max_examples])
    return "\n".join(lines)


def discriminative_hparams(opt_cfg, num_groups: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group (lr, wd) vectors (selector_helpers.py:237-277)."""
    n = num_groups
    lrs = np.zeros(n, np.float64)
    wds = np.zeros(n, np.float64)
    for i in range(n):
        lrs[i] = (opt_cfg.lr / (opt_cfg.lr_decay_factor ** (n - 1 - i))
                  if opt_cfg.discriminative_lr else opt_cfg.lr)
        wds[i] = (opt_cfg.reg_base * (opt_cfg.reg_decay_factor ** (n - 1 - i))
                  if opt_cfg.discriminative_reg else opt_cfg.weight_decay)
    return lrs, wds


# ---------------------------------------------------------------------------
# Grouped AdamW
# ---------------------------------------------------------------------------


class GroupedHyperParams(NamedTuple):
    """Per-group hyperparameters on the host, fp32 as the JAX step reads them."""

    lr: np.ndarray  # (num_groups,)
    wd: np.ndarray  # (num_groups,)
    trainable: np.ndarray  # (num_groups,) in {0., 1.}


@dataclasses.dataclass
class AdamWState:
    """First and second moments by parameter name, and the per-group step
    counts (host integers: the bias correction is a host scalar)."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: np.ndarray  # (num_groups,) int64


def adamw_init(params: Dict[str, torch.Tensor], num_groups: int = 3) -> AdamWState:
    return AdamWState(mu={n: torch.zeros_like(p, memory_format=torch.preserve_format)
                          for n, p in params.items()},
                      nu={n: torch.zeros_like(p, memory_format=torch.preserve_format)
                          for n, p in params.items()},
                      count=np.zeros(num_groups, np.int64))


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor], grads: Dict[str, Optional[torch.Tensor]],
                 state: AdamWState, spec: GroupSpec, hp: GroupedHyperParams,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One AdamW step, in place on ``params`` and ``state``."""
    for gid in range(spec.num_groups):
        if not hp.trainable[gid]:
            continue
        state.count[gid] += 1
        names = [n for n in spec.members(gid) if grads.get(n) is not None]
        if not names:
            continue
        c = int(state.count[gid])
        lr, wd = float(hp.lr[gid]), float(hp.wd[gid])
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        m = [state.mu[n] for n in names]
        v = [state.nu[n] for n in names]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        denom = torch._foreach_div(v, 1.0 - b2 ** c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, 1.0 - b1 ** c)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, p, alpha=wd)
        torch._foreach_add_(p, upd, alpha=-lr)


class ModelShards(NamedTuple):
    """The parameters of a model that are shards over a mesh's model axis:
    the norms and counts below sum their gradients' terms over the model
    group and count the replicated ones once (``parallel/tensor.py``)."""

    mesh: object
    names: frozenset


def model_shards(model: torch.nn.Module) -> Optional[ModelShards]:
    """The :class:`ModelShards` of a model sharded over a mesh's model axis,
    ``None`` for a whole one."""
    mesh = sharding_mesh(model)
    return None if mesh is None else ModelShards(mesh, frozenset(parameter_shards(model)))


def _total(per_leaf: torch.Tensor, names: Sequence[str],
           shards: Optional[ModelShards]) -> torch.Tensor:
    """The sum of per-gradient terms: the shards' summed over the model
    group, the replicated gradients' once."""
    sharded = [n in shards.names for n in names] if shards is not None else []
    if not any(sharded):
        return per_leaf.sum()
    flags = torch.tensor(sharded, device=per_leaf.device)
    part = torch.where(flags, per_leaf, 0).sum()
    shards.mesh.model_all_reduce(part)
    return torch.where(flags, 0, per_leaf).sum() + part


def global_norm(grads: Dict[str, torch.Tensor],
                shards: Optional[ModelShards] = None) -> torch.Tensor:
    """L2 norm over every gradient, by parameter name (a device scalar)."""
    sq = torch.stack(torch._foreach_norm([t.float() for t in grads.values()])) ** 2
    return _total(sq, list(grads), shards).sqrt()


def group_grad_norms(grads: Dict[str, Optional[torch.Tensor]], spec: GroupSpec,
                     shards: Optional[ModelShards] = None) -> Dict[str, torch.Tensor]:
    """Per-group gradient norms, keyed ``grad_norm_<group name>`` (the
    reference's backbone-only norm, train.py:825-862); excluded parameters
    count in no group."""
    out = {}
    for gid in range(spec.num_groups):
        g = {n: grads[n] for n in spec.members(gid) if grads.get(n) is not None}
        if g:
            out[f"grad_norm_{spec.names[gid]}"] = global_norm(g, shards)
    return out


def count_nonfinite(grads: Dict[str, torch.Tensor],
                    shards: Optional[ModelShards] = None) -> torch.Tensor:
    """Non-finite gradient entries (train.py:229-233)."""
    return _total(torch.stack([(~torch.isfinite(g)).sum() for g in grads.values()]),
                  list(grads), shards)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        shards: Optional[ModelShards] = None) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before clipping."""
    norm = global_norm(grads, shards)
    torch._foreach_mul_(list(grads.values()),
                        torch.clamp(max_norm / norm.clamp(min=1e-12), max=1.0))
    return norm


# ---------------------------------------------------------------------------
# Freeze/unfreeze + LR controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SingleModelOptController:
    """Frozen backbone at the start, one unfreeze at
    ``foundation_model_unfreeze_timer`` with lr
    ``foundation_model_unfreeze_lr`` and wd 0 (the reference reads a
    misspelled ``fondation_model_unfreeze_wd`` key, selector_helpers.py:207-217).
    Plateau reductions act on the groups present at the event; a group
    unfrozen later joins at its fresh lr (optim.py:308-380)."""

    cfg: Config
    method: str
    lr_scale: float = 1.0  # global multiplier (cosine / warmup schedulers)

    def __post_init__(self):
        mc = self.cfg.model_config(self.method)
        self.use_backbone = mc.use_backbone
        self.base_lrs, self.base_wds = discriminative_hparams(mc.optimizer, 3)
        self.unfrozen = not (self.cfg.backbone_freeze_on_start and self.use_backbone)
        self.group_scales = np.ones(3)

    def on_epoch_start(self, epoch: int) -> None:
        if (not self.unfrozen and self.cfg.backbone_freeze_on_start
                and epoch == self.cfg.foundation_model_unfreeze_timer):
            self.unfrozen = True
            self.group_scales[0] = 1.0  # a fresh param group

    def _unfreeze_applies(self) -> bool:
        return self.use_backbone and self.unfrozen and self.cfg.backbone_freeze_on_start

    def _raw_lrs(self) -> np.ndarray:
        lrs = self.base_lrs.copy()
        if self._unfreeze_applies():
            lrs[0] = self.cfg.foundation_model_unfreeze_lr
        return lrs

    def _present(self) -> np.ndarray:
        trainable = np.ones(3, np.float32)
        if self.use_backbone and not self.unfrozen:
            trainable[0] = 0.0
        return trainable

    def apply_plateau(self, factor: float, min_lr: float) -> None:
        """One torch ``ReduceLROnPlateau`` event on the groups present:
        ``lr_g = max(lr_g * factor, min_lr)``."""
        raw, present = self._raw_lrs(), self._present()
        for g in range(len(raw)):
            if present[g] and raw[g] > 0:
                self.group_scales[g] = max(raw[g] * self.group_scales[g] * factor,
                                           min_lr) / raw[g]

    def hyperparams(self) -> GroupedHyperParams:
        wds = self.base_wds.copy()
        if self._unfreeze_applies():
            wds[0] = 0.0
        return GroupedHyperParams(
            lr=np.asarray(self._raw_lrs() * self.group_scales * self.lr_scale, np.float32),
            wd=np.asarray(wds, np.float32),
            trainable=self._present())


@dataclasses.dataclass
class FusionOptController:
    """Gradual deep->shallow unfreeze across both encoders
    (LightningFusionOptimizerFactory, selector_helpers.py:357-742; JAX
    optim.py:382-476).  Groups 0-2 are the merged encoder depth groups,
    group 3 the fusion head, always trainable.  Every ``unfreeze_timer``
    epochs the deepest frozen encoder group joins with
    ``lr = backbone_unfreeze_lr * factor^(k-1)`` and
    ``wd = reg_base * reg_decay^(k-1)`` for the k-th unfreeze
    (selector_helpers.py:541-613); the wd reads ``cfg.dwi_model.optimizer``
    for both encoders, as the JAX controller does.  Plateau reductions act on
    the groups present at the event; a group unfrozen later joins at its
    fresh lr."""

    cfg: Config
    lr_scale: float = 1.0

    def __post_init__(self):
        self.base_lrs, self.base_wds = discriminative_hparams(
            self.cfg.fusion_model.optimizer, 4)
        self.layers_unfrozen = 0
        self.num_backbone_groups = self.cfg.backbone_num_groups
        self.frozen = self.cfg.backbone_freeze_on_start
        # per-group lr/wd captured at the unfreeze
        self.unfreeze_lrs = self.base_lrs.copy()
        self.unfreeze_wds = self.base_wds.copy()
        self.group_scales = np.ones(4)

    def on_epoch_start(self, epoch: int) -> None:
        t = self.cfg.unfreeze_timer
        if (not self.frozen or epoch == 0 or t <= 0 or epoch % t != 0
                or self.layers_unfrozen >= self.num_backbone_groups):
            return
        g = self.num_backbone_groups - 1 - self.layers_unfrozen
        self.layers_unfrozen += 1
        k = self.layers_unfrozen
        opt = self.cfg.dwi_model.optimizer
        self.unfreeze_lrs[g] = (self.cfg.backbone_unfreeze_lr
                                * self.cfg.backbone_unfreeze_lr_factor ** (k - 1))
        self.unfreeze_wds[g] = opt.reg_base * opt.reg_decay_factor ** (k - 1)
        self.group_scales[g] = 1.0  # a fresh param group

    def _raw_lrs_wds(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        trainable = np.ones(4, np.float32)
        lrs, wds = self.base_lrs.copy(), self.base_wds.copy()
        if self.frozen:
            for g in range(self.num_backbone_groups):
                if g >= self.num_backbone_groups - self.layers_unfrozen:
                    lrs[g], wds[g] = self.unfreeze_lrs[g], self.unfreeze_wds[g]
                else:
                    trainable[g] = 0.0
        return lrs, wds, trainable

    def apply_plateau(self, factor: float, min_lr: float) -> None:
        """One torch ``ReduceLROnPlateau`` event on the groups present."""
        raw, _, present = self._raw_lrs_wds()
        for g in range(len(raw)):
            if present[g] and raw[g] > 0:
                self.group_scales[g] = max(raw[g] * self.group_scales[g] * factor,
                                           min_lr) / raw[g]

    def hyperparams(self) -> GroupedHyperParams:
        lrs, wds, trainable = self._raw_lrs_wds()
        return GroupedHyperParams(
            lr=np.asarray(lrs * self.group_scales * self.lr_scale, np.float32),
            wd=np.asarray(wds, np.float32), trainable=trainable)
