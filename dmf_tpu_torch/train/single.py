"""Train and eval steps of the single-modality encoder, counterparts of
``dmf_tpu/train/single.py`` (the reference's ``LightningSingleModel._shared_step``,
train.py:294-428).

Under ``cfg.reference_compat`` the reference's semantics hold:
* label smoothing in training only (train.py:338-340);
* the validation loss is the classification loss alone: every auxiliary term
  joins the loss only in training (train.py:360-400);
* recon and mimic are weighted twice: the metric carries ``lambda * aux_w``
  and the loss adds ``lambda * metric * aux_w`` (train.py:397-400, 462-464);
* the single model's recon loss is a sum over its heads (train.py:445-454).

A batch is ``{"imgs": (B, H, W, C) processed volumes, "labels": (B,),
"masks": (B, h, w, 1) optional, "aux_w": float}`` on the model's device; the
steps hand the model NCHW maps.  A step's metrics stay device tensors until
the caller reads them (the fit loop reads an epoch's at once).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import Config
from ..evals.predict import to_model
from ..models.build import forward_in
from ..parallel.mesh import active_shard
from ..parallel.sharding import reduce_gradients
from ..losses import (compute_attn_energy_loss, compute_feat_norm_loss,
                      compute_feature_consistency_loss, label_smoothing,
                      mimic_feat_loss, single_model_recon_loss)
from .optim import (GroupSpec, GroupedHyperParams, adamw_update, clip_by_global_norm,
                    count_nonfinite, global_norm, group_grad_norms, model_shards)
from .state import TrainState

Metrics = Dict[str, torch.Tensor]


def compute_single_losses(cfg: Config, method: str, clf_loss_fn, mask_loss_fn,
                          logits, aux, mask_pred, inputs, masks, labels,
                          aux_w: float, is_train: bool):
    """Total loss and per-term metrics of one batch (train.py:294-428);
    ``inputs`` and ``masks`` are NCHW."""
    mc = cfg.model_config(method)
    zero = torch.zeros((), device=logits.device)
    metrics: Metrics = {}
    targets = (label_smoothing(labels, cfg.class_num, mc.label_smoothing_alpha)
               if is_train and mc.label_smoothing_enabled else labels)
    clf_loss = clf_loss_fn(logits, targets)
    loss = clf_loss
    metrics["clf_loss"] = clf_loss

    if mc.attn_reg_enabled:
        attn_e = compute_attn_energy_loss(aux)
        feat_c = compute_feature_consistency_loss(aux)
        if is_train:
            loss = (loss + attn_e * mc.lambda_attn_energy
                    + feat_c * mc.lambda_feature_consistency)
        metrics["attn_energy_loss"] = attn_e
    if mc.feat_norm_reg_enabled:
        feat_n = compute_feat_norm_loss(aux)
        if is_train:
            loss = loss + feat_n * mc.lambda_feat_norm
        metrics["feat_norm_loss"] = feat_n

    if mc.mask.enabled and mask_pred is not None and masks is not None:
        mask_loss = mask_loss_fn(mask_pred, masks)
        if is_train:
            loss = loss + mc.mask.lambda_mask * mask_loss
        metrics["mask_loss"] = mask_loss
    else:
        metrics["mask_loss"] = zero

    recon_metric = mimic_metric = zero
    if mc.recon_enabled:
        recon_raw = single_model_recon_loss(aux["recon_feats"], inputs)
        mimic_raw = zero
        if mc.mimic_enabled and aux.get("proj_pairs") is not None:
            p1, p1_r, p2, p2_r = aux["proj_pairs"][:4]
            mimic_raw = mimic_feat_loss(p1, p1_r) + mimic_feat_loss(p2, p2_r)
        if is_train and cfg.reference_compat:
            recon_metric = mc.lambda_recon * recon_raw * aux_w
            mimic_metric = mc.lambda_mimic * mimic_raw * aux_w
            loss = loss + (mc.lambda_recon * recon_metric * aux_w
                           + mc.lambda_mimic * mimic_metric * aux_w)
        else:
            recon_metric, mimic_metric = recon_raw, mimic_raw
            if is_train:
                loss = loss + aux_w * (mc.lambda_recon * recon_raw
                                       + mc.lambda_mimic * mimic_raw)
    metrics["recon_loss"] = recon_metric
    metrics["mimic_loss"] = mimic_metric
    metrics["acc"] = (logits.argmax(dim=-1) == labels).float().mean()
    metrics["loss"] = loss
    return loss, metrics


def _inputs(model, batch):
    x = to_model(batch["imgs"], model)
    masks = batch.get("masks")
    if masks is not None:
        masks = to_model(masks, model)
    labels = torch.as_tensor(batch["labels"], device=x.device).long()
    return x, masks, labels


def make_single_train_step(cfg: Config, method: str, clf_loss_fn: Callable,
                           mask_loss_fn: Optional[Callable], spec: GroupSpec,
                           compute_dtype: Optional[torch.dtype] = None):
    """``train_step(state, batch, generator, hp) -> metrics``: one forward
    in train mode (dropout masks from ``generator``, on the model's device),
    gradients of every parameter, the grouped AdamW update in place.
    ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the forward in that
    dtype on the fp32 parameters (``models/build.py::forward_in``, JAX's
    modules built with ``dtype=bfloat16``); the losses read the fp32 inputs,
    and the gradients, the moments and the update stay fp32.

    Under a data mesh's :class:`~..parallel.mesh.RowShard` (``batch`` this
    rank's rows) the loss is this rank's share of the global batch's mean,
    the gradients are summed over the data group before the norms, the clip
    and the update, and the metrics are the global batch's.  On a model
    sharded over a mesh's model axis (``parallel/tensor.py``) the update
    runs on this rank's shards and the norms, the clip and the non-finite
    count sum the shards over the model group."""
    mc = cfg.model_config(method)
    use_clip = (not cfg.reference_compat) and mc.grad_clip and mc.grad_clip > 0
    b1, b2 = mc.optimizer.betas

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator],
                   hp: GroupedHyperParams) -> Metrics:
        model = state.model
        x, masks, labels = _inputs(model, batch)
        logits, aux, mask_pred = forward_in(model, compute_dtype, x, train=True,
                                            generator=generator)
        loss, metrics = compute_single_losses(
            cfg, method, clf_loss_fn, mask_loss_fn, logits, aux, mask_pred, x, masks,
            labels, batch["aux_w"], is_train=True)
        shard = active_shard()
        if shard is not None:
            loss = shard.share(loss)
        params = dict(model.named_parameters())
        # every parameter's gradient, as the JAX step takes them (the frozen
        # and the excluded ones count in the norms)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True)))
        present = {n: g for n, g in grads.items() if g is not None}
        if shard is not None:
            reduce_gradients(list(present.values()), shard.mesh)
            metrics = shard.reduce_metrics(metrics)
        shards = model_shards(model)
        metrics["grad_norm"] = global_norm(present, shards)
        metrics.update(group_grad_norms(grads, spec, shards))
        metrics["grad_nonfinite"] = count_nonfinite(present, shards)
        if use_clip:
            clip_by_global_norm(present, mc.grad_clip, shards)
        adamw_update(params, grads, state.opt_state, spec, hp, b1=b1, b2=b2,
                     eps=mc.optimizer.eps)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_single_eval_step(cfg: Config, method: str, clf_loss_fn: Callable,
                          mask_loss_fn: Optional[Callable],
                          compute_dtype: Optional[torch.dtype] = None):
    """``eval_step(state, batch) -> (logits, probs, metrics)`` on the served
    eval route (the kernels on the card), without autograd, in
    ``compute_dtype`` as the train step; the loss metric is the
    classification loss alone."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model = state.model
        x, masks, labels = _inputs(model, batch)
        logits, aux, mask_pred = forward_in(model, compute_dtype, x)
        _, metrics = compute_single_losses(
            cfg, method, clf_loss_fn, mask_loss_fn, logits, aux, mask_pred, x, masks,
            labels, 1.0, is_train=False)
        metrics["loss"] = metrics["clf_loss"]
        return logits, torch.softmax(logits.float(), dim=-1), metrics

    return eval_step
