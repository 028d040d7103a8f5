"""Dual-modality fusion model (NCHW), counterpart of ``dmf_tpu/models/fusion.py``.

Reference ``FusionModel`` + helpers (model_module.py:745-1000): 1x1
projections of each encoder's deepest features, a softmax modality gate,
cross-attention over pooled tokens, SE, and mask / classifier / recon /
projector heads.  The concat + reduce and the residual ``refine`` block
feed nothing (see forward): the eval route skips them, the train route runs
them for their BatchNorm statistics, as the JAX train step does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig

from ..ops.attention import scaled_dot_product_attention
from ..ops.resize import adaptive_avg_pool, global_avg_pool, resize_bilinear
from ..parallel.tensor import copy_to_model, model_mesh, reduce_from_model
from .layers import (FusionReduce, MaskHeadResize, Projector, ReconHead,
                     ResLiteBlock, SEBlock, conv1x1)


class GatingAttention(nn.Module):
    """Softmax gate over [pvec_dwi | pvec_dce | mask confidences]
    (reference model_module.py:745-780)."""

    def __init__(self, in_features: int, **kw):
        super().__init__()
        self.fc = nn.Linear(in_features, 2, **kw)

    def forward(self, pvec_dwi, pvec_dce, dwi_mask=None, dce_mask=None):
        parts = [pvec_dwi, pvec_dce]
        if dwi_mask is not None and dce_mask is not None:
            parts += [dwi_mask.mean(dim=(-2, -1)).flatten(1),
                      dce_mask.mean(dim=(-2, -1)).flatten(1)]
        return torch.softmax(self.fc(torch.cat(parts, dim=1)), dim=1)


class CrossAttentionBlock(nn.Module):
    """Cross-attention on pooled tokens + LN-MLP FFN, returning head-averaged
    weights (reference model_module.py:799-818).  ``cross_attn`` holds the
    packed ``in_proj`` parameters of ``nn.MultiheadAttention``; the forward
    runs the port's plain attention so that rounding follows the JAX route."""

    def __init__(self, channels: int, num_heads: int = 4, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.cross_attn = nn.MultiheadAttention(channels, num_heads,
                                                batch_first=True, **kw)
        self.attn_ffn = nn.Sequential(
            nn.LayerNorm(channels, eps=1e-5, **kw), nn.Linear(channels, channels, **kw),
            nn.GELU(), nn.Linear(channels, channels, **kw))

    def forward(self, query_tokens, key_value_tokens):
        B, Nq, C = query_tokens.shape
        Nk = key_value_tokens.shape[1]
        D = C // self.num_heads
        wq, wk, wv = self.cross_attn.in_proj_weight.chunk(3)
        bq, bk, bv = self.cross_attn.in_proj_bias.chunk(3)
        # over a model axis in_proj holds this rank's heads of q, k and v
        # and out_proj is row-parallel (parallel/tensor.py)
        mesh = model_mesh(self.cross_attn.out_proj)
        H = wq.shape[0] // D
        if mesh is not None:
            query_tokens = copy_to_model(query_tokens, mesh)
            key_value_tokens = copy_to_model(key_value_tokens, mesh)

        def split(t, n):
            return t.reshape(B, n, H, D).transpose(1, 2)

        q = split(F.linear(query_tokens, wq, bq), Nq)
        k = split(F.linear(key_value_tokens, wk, bk), Nk)
        v = split(F.linear(key_value_tokens, wv, bv), Nk)
        out, weights = scaled_dot_product_attention(q, k, v, return_weights=True)
        out = self.cross_attn.out_proj(out.transpose(1, 2).reshape(B, Nq, H * D))
        if mesh is None:
            return out + self.attn_ffn(out), weights.mean(dim=1)
        # the head average of every rank's heads (fusion.py:80-88)
        avg = reduce_from_model(weights.sum(dim=1), mesh) / self.num_heads
        return out + self.attn_ffn(out), avg


class FusionModel(nn.Module):
    """``forward(raw_dwi, raw_dce, dwi_mask, dce_mask, lean, train, generator)``
    returns ``(logits, fused_mask_logits, aux)``; aux keys proj_fused /
    recon_fused / gating_weights / attn_weights / p_dwi / p_dce.
    ``lean=True`` computes the logits only (mask, recon and projector heads
    are skipped).  The only dropout of the JAX model sits in the unconsumed
    ``refine`` block, so the fused head is deterministic and takes no ``mc``
    flag.  ``train=True`` is the JAX training route: BatchNorm on batch
    statistics, ``refine``'s dropout drawn from ``generator``, and no kernel
    wrapper called (``fusion_se`` unfused)."""

    def __init__(self, config: ModelConfig, num_classes: int,
                 dwi_channels: int, dce_channels: int, feature_size: int,
                 with_masks: bool = True, **kw):
        super().__init__()
        cfg = config
        fs = cfg.fusion_specific
        fc = fs.fusion_channels
        self.config = cfg
        self.proj_in_dwi = conv1x1(dwi_channels, fc, **kw) if dwi_channels != fc else None
        self.proj_in_dce = conv1x1(dce_channels, fc, **kw) if dce_channels != fc else None
        self.fusion_conv_reduce = FusionReduce(2 * fc, fc, **kw)
        self.refine = ResLiteBlock(fc, fc, dropout=cfg.dropout, mid_squeeze=2, **kw)
        use_masks = fs.use_mask_attention and with_masks
        self.use_mask_attention = use_masks
        self.gating = GatingAttention(2 * fc + (2 if use_masks else 0), **kw)
        self.cross_attn_block = (CrossAttentionBlock(fc, fs.mha_heads, **kw)
                                 if fs.use_cross_attention else None)
        self.fusion_se = SEBlock(fc, 2, **kw) if cfg.use_se else None
        self.mask_head = MaskHeadResize(fc, feature_size,
                                        out_size=cfg.mask.mask_target_size[0], **kw)
        self.classifier = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                                        nn.Linear(fc, num_classes, **kw))
        self.fusion_reconstruct = ReconHead(fc, fs.fusion_recon_ch, **kw)
        self.projF = Projector(fc, cfg.proj_dim, **kw)

    def forward(self, raw_feats_dwi: Sequence[torch.Tensor],
                raw_feats_dce: Sequence[torch.Tensor],
                dwi_mask_pred: Optional[torch.Tensor] = None,
                dce_mask_pred: Optional[torch.Tensor] = None,
                lean: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        fs = self.config.fusion_specific
        f3_dwi, f3_dce = raw_feats_dwi[-1], raw_feats_dce[-1]
        p_dwi = self.proj_in_dwi(f3_dwi) if self.proj_in_dwi is not None else f3_dwi
        p_dce = self.proj_in_dce(f3_dce) if self.proj_in_dce is not None else f3_dce

        # fusion_conv_reduce -> refine -> gelu(reduced + residual) is computed
        # by the JAX model but consumed by nothing (fusion.py:139-147).  At
        # inference XLA drops it as dead code and so does the port; a JAX
        # train step still updates its BatchNorm statistics (a mutable output)
        # and hands its parameters zero gradients, so the train route runs it
        # and leaves its result unused.
        if train:
            reduced = self.fusion_conv_reduce(torch.cat([p_dwi, p_dce], dim=1), train)
            self.refine(reduced, train, generator=generator)
        if self.use_mask_attention:
            gating_weights = self.gating(global_avg_pool(p_dwi), global_avg_pool(p_dce),
                                         dwi_mask_pred, dce_mask_pred)
        else:
            gating_weights = self.gating(global_avg_pool(p_dwi), global_avg_pool(p_dce))
        fused = (gating_weights[:, 0, None, None, None] * p_dwi
                 + gating_weights[:, 1, None, None, None] * p_dce)

        attn_weights = None
        if self.cross_attn_block is not None:
            hp, wp = fs.token_pool
            B, fc = p_dwi.shape[:2]

            def tokens(t):
                return adaptive_avg_pool(t, (hp, wp)).reshape(B, fc, hp * wp).transpose(1, 2)

            attn_out, attn_weights = self.cross_attn_block(tokens(p_dwi), tokens(p_dce))
            lowres = attn_out.transpose(1, 2).reshape(B, fc, hp, wp)
            fused = fused + resize_bilinear(lowres, fused.shape[-2:])

        fused_refined = (self.fusion_se(fused, train)[0] if self.fusion_se is not None
                         else fused)
        logits = self.classifier(fused_refined)
        if lean:
            return logits, None, None
        aux = {
            "proj_fused": self.projF(fused_refined, train),
            "recon_fused": self.fusion_reconstruct(fused_refined, train),
            "gating_weights": gating_weights,
            "attn_weights": attn_weights,
            "p_dwi": p_dwi,
            "p_dce": p_dce,
        }
        return logits, self.mask_head(fused_refined), aux
