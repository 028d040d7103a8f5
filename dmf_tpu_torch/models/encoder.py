"""Single-modality encoder, counterpart of ``dmf_tpu/models/encoder.py``.

Reference ``ModelMaskHeadBackbone`` (model_module.py:481-733): SE modality
attention on the raw channels -> backbone + adapter -> block1 -> learned
alpha-blend with the backbone at f2 and f3 -> block2 -> mask head at the
configured stage with spatial attention -> block3 -> pooled projections ->
L2-normalized classification head.  With ``use_hybrid_transformer`` the
final stage is a :class:`~.transformer.TransformerStage` on f2 plus a 1x1
projection to c3 (encoder.py:206-221) in place of block3.

With a ViT/DINO backbone (``transformer_backbone``) the adapter lays its
16 x 16 token grids out as maps, so f1-f3 are 16^2 for a 256^2 input; its
``backbone_layers`` is a :class:`~.backbones.vit.ViTSize` for a narrow test
ViT, as ``(1, 1, 1, 1)`` is a shallow ResNet.

``forward`` returns ``(logits, aux, mask_pred)`` with the JAX aux keys.
``train=True`` is the JAX training route: BatchNorm on batch statistics
everywhere (the frozen backbone included), dropout on, and no kernel wrapper
called (the SE and neck stages run unfused).  The
``prefix_only``/``prefix`` split (encoder.py:47-121) lets the MC predictor run
the deterministic prefix once; ``lean=True`` skips the reconstruction heads
and projectors, which a pass that only needs probabilities does not use
(XLA drops them by dead-code elimination; eager PyTorch has to be told).

``config.remat`` runs each ResLite block call under activation
checkpointing when autograd records it (the JAX encoder wraps
``ResLiteBlock`` in ``nn.remat``, encoder.py:78-81): the backward recomputes
the block's activations from its input, on the same dropout masks and
without a second BatchNorm statistics update (:func:`remat_block`), so a
step's numbers are those of the plain step.  The backbone, the adapter and
the transformer stage are not checkpointed; the eval, MC and serving
routes never are.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig

from ..ops.resize import adaptive_avg_pool
from .adapter import BackboneAdapter
from .backbones.registry import build_backbone
from .backbones.vit import ViTSize
from .layers import (BatchNorm2d, ClassificationHead, FeatureDownAlign,
                     MaskGuidedSpatialAttention, MaskHeadResize, Projector,
                     ResLiteBlock, SEBlock)
from .transformer import TransformerStage


def _block_size(size: int, downsample: bool, repeats: int, each: bool) -> int:
    """Spatial size after a ResLiteBlock (stride-2 1x1 convs halve, rounding up)."""
    for _ in range(repeats if (downsample and each) else int(downsample)):
        size = (size + 1) // 2
    return size


def remat_block(block: nn.Module, x: torch.Tensor, train: bool, mc: bool,
                generator: Optional[torch.Generator], recon: bool = True):
    """``block(x, train, mc, generator, recon=recon)`` under
    ``torch.utils.checkpoint``: the block's activations are not kept for the
    backward, which recomputes them from ``x``.

    The recomputation replays the forward exactly.  ``checkpoint`` restores
    only the default CPU and CUDA generators, while the block's dropout draws
    from ``generator``: the replay sets that generator to its state before
    the forward, and afterwards back to the state it finds (the forward's
    draws and any since), so the same masks are drawn and the stream goes on
    as without remat.  The replay's train-mode BatchNorm would update the
    running statistics a second time: it updates throwaway copies, so they
    end as after a plain step (JAX's recomputation discards its
    ``batch_stats`` too).
    """
    start = generator.get_state() if generator is not None else None

    @contextlib.contextmanager
    def replay():
        found = generator.get_state() if generator is not None else None
        norms = [(bn, bn.running_mean, bn.running_var) for bn in block.modules()
                 if isinstance(bn, BatchNorm2d)]
        if generator is not None:
            generator.set_state(start)
        for bn, mean, var in norms:
            bn.running_mean, bn.running_var = mean.clone(), var.clone()
        try:
            yield
        finally:
            for bn, mean, var in norms:
                bn.running_mean, bn.running_var = mean, var
            if generator is not None:
                generator.set_state(found)

    # preserve_rng_state=False: the block draws from ``generator`` alone
    return checkpoint(lambda t: block(t, train, mc, generator, recon=recon), x,
                      use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), replay()))


class Encoder(nn.Module):
    def __init__(self, method: str, config: ModelConfig, channel_num: int,
                 num_classes: int,
                 backbone_layers: Union[Sequence[int], ViTSize] = (3, 4, 6, 3), **kw):
        super().__init__()
        cfg = config
        hybrid = cfg.use_hybrid_transformer
        if hybrid and cfg.mask.enabled and cfg.mask.mask_stage.lower() == "f3":
            raise ValueError("mask_stage='f3' not supported with hybrid transformer")
        self.method = method
        self.config = cfg
        c1, c2, c3 = cfg.channels
        self.modality_attention = (SEBlock(channel_num, 2, **kw)
                                   if cfg.enable_modality_attention else None)
        size = cfg.input_size
        if cfg.use_backbone:
            self.backbone = build_backbone(cfg, channel_num, layers=backbone_layers, **kw)
            self.backbone_adapter = BackboneAdapter(
                self.backbone.output_dims, cfg.backbone_index_lists,
                (c1, c1, c2), **kw)
            first = cfg.backbone_index_lists[0][0]
            size = -(-size // self.backbone.reductions[first])
            f1_in = c1
        else:
            self.backbone = self.backbone_adapter = None
            f1_in = channel_num

        def block(cin, cout, i, recon_ch):
            return ResLiteBlock(
                cin, cout, downsample=cfg.downsample[i], recon_ch=recon_ch,
                use_se=cfg.use_se, dropout=cfg.dropout,
                num_repeats=cfg.repeat_blocks[i],
                downsample_each_repeat=cfg.downsample_each_repeat,
                mid_squeeze=cfg.mid_squeeze, **kw)

        def stage(i, s):
            return _block_size(s, cfg.downsample[i], cfg.repeat_blocks[i],
                               cfg.downsample_each_repeat)

        s1 = stage(0, size)
        s2 = stage(1, s1)
        s3 = stage(2, s2)
        self.block1 = block(f1_in, c1, 0, 1)
        self.block2 = block(c1, c2, 1, 1)
        if hybrid:
            self.block3 = None
            self.transformer = TransformerStage(
                c2, cfg.transformer_embed_dim, depth=cfg.transformer_depth,
                heads=cfg.transformer_heads, patch_size=cfg.transformer_patch_size, **kw)
            self.trans_out_proj = nn.Conv2d(cfg.transformer_embed_dim, c3, 1, **kw)
            s3 = s2 // cfg.transformer_patch_size
        else:
            self.block3 = block(c2, c3, 2, 0)
            self.transformer = None
        # the alpha-blend scalars and norms, as the exporter emits them
        # (ref_ckpt.py:444-449, 478-486): the reference registers them
        # whatever the backbone setting (model_module.py:593-596), but the JAX
        # model with a backbone and the hybrid stage has no f3 blend
        self.f2_weight = nn.Parameter(torch.tensor(0.5, **kw))
        self.norm_f2 = nn.GroupNorm(c1, c1, eps=1e-5, **kw)
        if not (hybrid and cfg.use_backbone):
            self.f3_weight = nn.Parameter(torch.tensor(0.5, **kw))
            self.norm_f3 = nn.GroupNorm(c2, c2, eps=1e-5, **kw)

        m = cfg.mask
        self.mask_stage = m.mask_stage.lower() if m.enabled else None
        mask_in = {"f1": (c1, s1), "f2": (c2, s2), "f3": (c3, s3)}
        if self.mask_stage == "f2":
            self.f1_to_f2 = FeatureDownAlign(c1, c2, downsample=False, **kw)
        if self.mask_stage == "f3":
            self.f2_to_f3 = FeatureDownAlign(c2, c3, downsample=False, **kw)
        if self.mask_stage is not None:
            ch, s = mask_in[self.mask_stage]
            self.mask_head = MaskHeadResize(ch, s, out_size=m.mask_target_size[0], **kw)
            self.mask_spatial_attention = MaskGuidedSpatialAttention(**kw)
        pd = cfg.proj_dim
        self.proj_f1 = Projector(c1, pd, **kw)
        self.proj_f2 = Projector(c2, pd, **kw)
        self.proj_r1 = Projector(1, pd, **kw)
        self.proj_r2 = Projector(1, pd, **kw)
        self.classification_head = ClassificationHead(c3, num_classes, **kw)
        self.feature_size = s3

    def forward(self, x: torch.Tensor, train: bool = False, mc: bool = False,
                generator: Optional[torch.Generator] = None,
                prefix_only: bool = False, prefix=None, lean: bool = False):
        cfg = self.config
        mask_pred = mask_attn_map = mod_attn_map = None
        if prefix is not None:
            x_in, mod_attn_map, bb = prefix
            f1_b, f2_b, f3_b = bb if bb is not None else (None, None, None)
        else:
            x = x.to(self.f2_weight.dtype)
            if self.modality_attention is not None:
                x_in, mod_attn_map = self.modality_attention(x, train)
            else:
                x_in = x
            if self.backbone is not None:
                f1_b, f2_b, f3_b = self.backbone_adapter(self.backbone(x_in, train), train)
                bb = (f1_b, f2_b, f3_b)
            else:
                f1_b = f2_b = f3_b = bb = None
            if prefix_only:
                return x_in, mod_attn_map, bb
        f1_in = f1_b if self.backbone is not None else x_in

        run_block = (remat_block if cfg.remat and train and torch.is_grad_enabled()
                     else lambda block, *a, **kw: block(*a, **kw))
        f1, r1 = run_block(self.block1, f1_in, train, mc, generator, recon=not lean)
        if self.mask_stage == "f1":
            mask_pred = self.mask_head(f1)
            f1, mask_attn_map = self.mask_spatial_attention(f1, mask_pred)
        if self.backbone is not None:
            alpha = torch.sigmoid(self.f2_weight)
            f2_in = self.norm_f2(alpha * f2_b + (1 - alpha) * f1)
        else:
            f2_in = f1
        f2, r2 = run_block(self.block2, f2_in, train, mc, generator, recon=not lean)
        if self.mask_stage == "f2":
            mask_pred = self.mask_head(f2 + self.f1_to_f2(f1, train))
            f2, mask_attn_map = self.mask_spatial_attention(f2, mask_pred)
        if self.transformer is not None:
            # dropout is on in training too (transformer.py:36, :70)
            f3 = self.trans_out_proj(self.transformer(f2, train or mc, generator))
        else:
            if self.backbone is not None:
                alpha = torch.sigmoid(self.f3_weight)
                f3_in = self.norm_f3(alpha * f3_b + (1 - alpha) * f2)
            else:
                f3_in = f2
            f3, _ = run_block(self.block3, f3_in, train, mc, generator)
            if self.mask_stage == "f3":
                mask_pred = self.mask_head(f3 + self.f2_to_f3(f2, train))
                f3, mask_attn_map = self.mask_spatial_attention(f3, mask_pred)

        logits = self.classification_head(f3)
        proj_pairs = None
        if not lean:
            pd = (cfg.proj_dim, cfg.proj_dim)
            proj_pairs = [self.proj_f1(adaptive_avg_pool(f1, pd), train),
                          self.proj_r1(adaptive_avg_pool(r1, pd), train),
                          self.proj_f2(adaptive_avg_pool(f2, pd), train),
                          self.proj_r2(adaptive_avg_pool(r2, pd), train)]
        aux = {
            "raw_feats": [f1, f2, f3],
            "recon_feats": [r1, r2],
            "proj_pairs": proj_pairs,
            "mask_attn_map": mask_attn_map,
            "mod_attn_map": mod_attn_map,
        }
        return logits, aux, mask_pred
