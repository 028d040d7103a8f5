"""Train and eval steps of fusion training (both encoders and the fusion
head), counterparts of ``dmf_tpu/train/fusion.py`` (the reference's
``LightningFusionModel._shared_step``, train_fusion.py:204-321).

The gradual unfreeze arrives as per-group hyperparameters
(:class:`~.optim.FusionOptController`); the groups are static
(:func:`~.optim.build_fusion_group_spec`).  Under ``cfg.reference_compat``
the reference's semantics hold:
* label smoothing in training only; the validation loss is the
  classification loss alone;
* the three mask losses (DWI, DCE, fused) against the same ground truth,
  averaged (train_fusion.py:246-254);
* the regularizers read keys the fusion outputs do not have, so each adds 0
  (train_fusion.py:260-267): they are left out;
* the fused "mimic" pairs the first four *samples* of ``proj_fused`` as
  (student, teacher) couples (train_fusion.py:291-296); without
  ``reference_compat`` the term is dropped.

Every parameter gets a gradient, zeros where the loss does not reach it
(``refine``, ``fusion_conv_reduce``, the encoders' projectors and
classification heads), as the JAX step hands every leaf one: AdamW's
decoupled decay then shrinks those in a trainable group as it does in JAX.

A batch is ``{"dwi": (B, H, W, C), "dce": (B, H, W, C) processed volumes,
"labels": (B,), "masks": (B, h, w, 1) optional, "aux_w": float}``; the steps
hand the models NCHW maps.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..config import Config
from ..evals.predict import to_model
from ..models.build import forward_in
from ..losses import compute_recon_list_loss, label_smoothing, mimic_feat_loss, safe_mask_loss
from ..parallel.mesh import RowShard, active_shard
from ..parallel.sharding import reduce_gradients
from .optim import (GroupSpec, GroupedHyperParams, adamw_update, count_nonfinite, global_norm,
                    model_shards)
from .state import TrainState

Metrics = Dict[str, torch.Tensor]
PARTS = ("dwi", "dce", "fusion")


class FusionNetwork(nn.Module):
    """The two encoders and the fusion head as one module, so that one
    :class:`~.state.TrainState` (``num_groups=4``) holds them: parameter names
    ``dwi.*``, ``dce.*``, ``fusion.*``.  ``forward`` is the fusion forward
    from the processed inputs (the JAX package's ``make_fusion_apply``,
    train_fusion.py:227-236)."""

    def __init__(self, dwi: nn.Module, dce: nn.Module, fusion: nn.Module):
        super().__init__()
        self.dwi, self.dce, self.fusion = dwi, dce, fusion

    def forward(self, dwi_x, dce_x, train: bool = False, mc: bool = False,
                generator: Optional[torch.Generator] = None, lean_encoders: bool = False):
        """NCHW maps in; ``(logits, fused_mask, aux, parts)`` out, ``parts``
        holding each encoder's aux and mask.  ``lean_encoders`` skips the
        encoders' reconstruction heads and projectors, which only the train
        losses read."""
        kw = dict(train=train, mc=mc, generator=generator, lean=lean_encoders)
        _, d_aux, d_mask = self.dwi(dwi_x, **kw)
        _, c_aux, c_mask = self.dce(dce_x, **kw)
        logits, fused_mask, aux = self.fusion(d_aux["raw_feats"], c_aux["raw_feats"],
                                              d_mask, c_mask, train=train, generator=generator)
        parts = {"dwi_aux": d_aux, "dce_aux": c_aux, "dwi_mask": d_mask, "dce_mask": c_mask}
        return logits, fused_mask, aux, parts


def fusion_sample_pair_mimic(proj_fused: torch.Tensor) -> torch.Tensor:
    """The reference's fused "mimic": the cosine distance between the fused
    projections of samples (0, 1) and of (2, 3), channels as rows
    (train_fusion.py:291-296); 0 below four samples.  A sample's NCHW
    ``(C, H, W)`` flattened to ``(C, H*W)`` is already that layout."""
    if proj_fused.shape[0] < 4:
        return torch.zeros((), device=proj_fused.device)
    p = proj_fused.reshape(proj_fused.shape[0], proj_fused.shape[1], -1)
    return (mimic_feat_loss(p[0], p[1]) + mimic_feat_loss(p[2], p[3])) / 2.0


def compute_fusion_losses(cfg: Config, clf_loss_fn, mask_loss_fn, logits, fused_mask, aux,
                          parts, dwi_x, dce_x, masks, labels, aux_w: float, is_train: bool,
                          shard: Optional[RowShard] = None):
    """Total loss and per-term metrics of one batch (train_fusion.py:204-321);
    ``dwi_x``, ``dce_x`` and ``masks`` are NCHW.

    With ``shard`` (a data mesh's step on this rank's rows) the loss is this
    rank's share of the global batch's: the per-sample terms' share of their
    global means, and ``1 / n_data`` of the pair mimic, which reads samples
    0-3 of the *global* batch (gathered, with their gradient, from the
    ranks that hold them; 0 below four global samples, as JAX gates it on
    ``valid.sum() >= 4``, train/fusion.py:184-194)."""
    fp = cfg.fusion_model
    zero = torch.zeros((), device=logits.device)
    targets = (label_smoothing(labels, cfg.class_num, fp.label_smoothing_alpha)
               if is_train and fp.label_smoothing_enabled else labels)
    clf_loss = clf_loss_fn(logits, targets)
    loss = clf_loss
    metrics: Metrics = {"clf_loss": clf_loss, "mask_loss": zero}

    if fp.mask.enabled and masks is not None:
        mask_loss = sum(safe_mask_loss(m, masks, mask_loss_fn)
                        for m in (parts["dwi_mask"], parts["dce_mask"], fused_mask)) / 3.0
        if is_train:
            loss = loss + fp.mask.lambda_mask * mask_loss
        metrics["mask_loss"] = mask_loss

    recon_val = mimic_val = zero
    if is_train and fp.recon_enabled:
        dwi_in, dce_in = dwi_x.detach(), dce_x.detach()
        fused_in = torch.cat([dwi_in, dce_in], dim=1)
        recon_val = (compute_recon_list_loss(parts["dwi_aux"]["recon_feats"], dwi_in)
                     + compute_recon_list_loss(parts["dce_aux"]["recon_feats"], dce_in)
                     + compute_recon_list_loss(aux["recon_fused"], fused_in)) / 3.0
        loss = loss + fp.lambda_recon * recon_val * aux_w
        if shard is not None:
            loss = shard.share(loss)
        if fp.mimic_enabled and aux.get("proj_fused") is not None:
            if cfg.reference_compat:
                proj = aux["proj_fused"]
                if shard is not None:
                    proj = shard.gather_head(proj, 4) if shard.total >= 4 else proj[:0]
                mimic_val = fusion_sample_pair_mimic(proj)
            loss = loss + fp.lambda_mimic * mimic_val * aux_w / (shard.size if shard else 1)
    elif shard is not None:
        loss = shard.share(loss)
    metrics["recon_loss"] = recon_val
    metrics["mimic_loss"] = mimic_val
    metrics["acc"] = (logits.argmax(dim=-1) == labels).float().mean()
    metrics["loss"] = loss
    return loss, metrics


def _inputs(net: FusionNetwork, batch):
    dwi_x, dce_x = to_model(batch["dwi"], net.dwi), to_model(batch["dce"], net.dce)
    masks = batch.get("masks")
    if masks is not None:
        masks = to_model(masks, net.fusion)
    labels = torch.as_tensor(batch["labels"], device=dwi_x.device).long()
    return dwi_x, dce_x, masks, labels


def make_fusion_train_step(cfg: Config, clf_loss_fn: Callable,
                           mask_loss_fn: Optional[Callable], spec: GroupSpec,
                           compute_dtype: Optional[torch.dtype] = None):
    """``train_step(state, batch, generator, hp) -> metrics`` on a
    :class:`FusionNetwork` state: both encoders and the head in train mode
    (dropout masks from ``generator``), the gradient of every parameter
    (zeros where the loss does not reach), the norms of all of them and of
    each part, the grouped AdamW update in place.  Under a data mesh's
    :class:`~..parallel.mesh.RowShard` the step is the global batch's, and
    on a model sharded over a model axis the norms are the whole model's,
    as ``make_single_train_step``'s, whose ``compute_dtype`` this takes
    too."""
    opt = cfg.fusion_model.optimizer
    b1, b2 = opt.betas

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator],
                   hp: GroupedHyperParams) -> Metrics:
        net = state.model
        dwi_x, dce_x, masks, labels = _inputs(net, batch)
        logits, fused_mask, aux, parts = forward_in(net, compute_dtype, dwi_x, dce_x,
                                                    train=True, generator=generator)
        shard = active_shard()
        loss, metrics = compute_fusion_losses(
            cfg, clf_loss_fn, mask_loss_fn, logits, fused_mask, aux, parts, dwi_x, dce_x,
            masks, labels, batch["aux_w"], is_train=True, shard=shard)
        params = dict(net.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True, materialize_grads=True)))
        if shard is not None:
            reduce_gradients(list(grads.values()), shard.mesh)
            # the loss is already this rank's share; the pair mimic is global
            metrics = shard.reduce_metrics(metrics, summed=("loss",),
                                           replicated=("mimic_loss",))
        shards = model_shards(net)
        metrics["grad_norm"] = global_norm(grads, shards)
        for part in PARTS:
            metrics[f"{part}_grad_norm"] = global_norm(
                {n: g for n, g in grads.items() if n.startswith(part + ".")}, shards)
        metrics["grad_nonfinite"] = count_nonfinite(grads, shards)
        adamw_update(params, grads, state.opt_state, spec, hp, b1=b1, b2=b2, eps=opt.eps)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_fusion_eval_step(cfg: Config, clf_loss_fn: Callable, mask_loss_fn: Optional[Callable],
                          compute_dtype: Optional[torch.dtype] = None):
    """``eval_step(state, batch) -> (logits, probs, metrics)`` on the served
    eval route (kernels 1, 2 and 6 on the card), without autograd, in
    ``compute_dtype`` as the train step; the loss metric is the
    classification loss alone."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        net = state.model
        dwi_x, dce_x, masks, labels = _inputs(net, batch)
        logits, fused_mask, aux, parts = forward_in(net, compute_dtype, dwi_x, dce_x,
                                                    lean_encoders=True)
        _, metrics = compute_fusion_losses(cfg, clf_loss_fn, mask_loss_fn, logits, fused_mask,
                                           aux, parts, dwi_x, dce_x, masks, labels, 1.0,
                                           is_train=False)
        metrics["loss"] = metrics["clf_loss"]
        return logits, torch.softmax(logits.float(), dim=-1), metrics

    return eval_step
