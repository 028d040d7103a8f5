"""Auxiliary losses on (N, C, H, W) maps, counterparts of
``dmf_tpu/losses/aux.py``: reconstruction, mimic and the regularizers
(train.py:991-1048, loss.py:7-9, train_fusion.py:709-744).  The channel axis
is dim 1 here where the JAX functions reduce the last axis of NHWC maps.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.resize import resize_bilinear


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """train.py:1041-1042."""
    return torch.sqrt((pred - target) ** 2 + eps ** 2).mean()


def recon_image_loss(pred_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sigmoid, clamp, Charbonnier (train.py:1043-1048)."""
    pred = torch.sigmoid(pred_logits).clamp(0.0, 1.0)
    return charbonnier_loss(pred, target.clamp(0.0, 1.0))


def single_model_recon_loss(recon_feats: Sequence[Optional[torch.Tensor]],
                            inputs: torch.Tensor) -> torch.Tensor:
    """Sum (not mean) of the heads' recon losses against the input, its
    channel mean for a one-channel head; each head is upsampled bilinearly to
    the input (train.py:445-454)."""
    total = torch.zeros((), dtype=inputs.dtype, device=inputs.device)
    for pred_r in recon_feats:
        if pred_r is None:
            continue
        up = resize_bilinear(pred_r, inputs.shape[-2:])
        target = inputs
        if up.shape[1] == 1 and target.shape[1] > 1:
            target = target.mean(dim=1, keepdim=True)
        total = total + recon_image_loss(up, target)
    return total


def compute_recon_list_loss(recon_list, input_img: torch.Tensor) -> torch.Tensor:
    """Multi-scale recon loss over the valid heads, normalised by their
    count; both sides channel-meaned on a channel mismatch
    (train_fusion.py:709-744)."""
    if recon_list is None:
        return torch.zeros((), dtype=input_img.dtype, device=input_img.device)
    if not isinstance(recon_list, (list, tuple)):
        recon_list = [recon_list]
    valid = [r for r in recon_list if r is not None]
    total = torch.zeros((), dtype=input_img.dtype, device=input_img.device)
    if not valid:
        return total
    for r in valid:
        r_up = resize_bilinear(r, input_img.shape[-2:])
        if r_up.shape[1] != input_img.shape[1]:
            r_up = r_up.mean(dim=1, keepdim=True)
            target = input_img.mean(dim=1, keepdim=True)
        else:
            target = input_img
        total = total + recon_image_loss(r_up, target)
    return total / len(valid)


def proj_cosine_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """1 - cosine similarity along the channel axis (loss.py:7-9)."""
    an = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp(min=eps)
    bn = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp(min=eps)
    return (1.0 - (an * bn).sum(dim=1)).mean()


def mimic_feat_loss(s_feat: torch.Tensor, t_feat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Cosine distance of the flattened, L2-normalised features; the
    teacher (second argument) is detached (train.py:1033-1038)."""
    s = s_feat.flatten(1)
    t = t_feat.detach().flatten(1)
    s = s / torch.linalg.vector_norm(s, dim=1, keepdim=True).clamp(min=1e-12)
    t = t / torch.linalg.vector_norm(t, dim=1, keepdim=True).clamp(min=1e-12)
    return (1.0 - (s * t).sum(dim=1).clamp(-1.0 + eps, 1.0 - eps)).mean()


def compute_attn_energy_loss(aux: dict) -> torch.Tensor:
    """L1 energy of the mask-attention map (train.py:991-1000)."""
    attn_map = aux.get("mask_attn_map")
    if attn_map is None:
        return torch.zeros(())
    return attn_map.abs().mean()


def compute_feature_consistency_loss(aux: dict) -> torch.Tensor:
    """MSE of the channel-normalised p1 and upsampled p2 projections
    (train.py:1001-1018)."""
    proj_pairs = aux.get("proj_pairs")
    if proj_pairs is None:
        return torch.zeros(())
    p1, _p1_r, p2, _p2_r = proj_pairs[:4]
    p2_up = resize_bilinear(p2, p1.shape[-2:])
    p1n = p1 / (torch.linalg.vector_norm(p1, dim=1, keepdim=True) + 1e-6)
    p2n = p2_up / (torch.linalg.vector_norm(p2_up, dim=1, keepdim=True) + 1e-6)
    return ((p1n - p2n) ** 2).mean()


def compute_feat_norm_loss(aux: dict) -> torch.Tensor:
    """Mean squared activation summed over the raw features
    (train.py:1021-1030)."""
    raw_feats = aux.get("raw_feats")
    if raw_feats is None:
        return torch.zeros(())
    total = torch.zeros((), device=raw_feats[0].device)
    for f in raw_feats:
        total = total + (f.float() ** 2).mean()
    return total
