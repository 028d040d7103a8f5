"""Assemble the fusion serving models (counterpart of bench.py:502-578).

``build_fusion_models`` builds the two encoders (by default each backed by a
ResNet-50 on the dilated stride-8 pyramid; with ``use_backbone=False,
use_hybrid_transformer=True`` the hybrid CNN->Transformer encoders of
``bench.py --encoder hybrid-nb``) and the fusion head at the config's widths,
on seeded random weights drawn from an explicit generator with the JAX
package's initializers.  The models go to the card unless the caller asks
for the CPU; on a CUDA device they are put in ``channels_last`` memory
format, the layout the kernels take.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..config import Config, resolve_backbone_config

from .encoder import Encoder
from .fusion import FusionModel
from .transformer import TransformerBlock


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every weight from ``generator`` with the JAX initializers
    (models/layers.py:20-30): conv kernels U(+-sqrt(1/fan_in)), dense kernels
    U(+-sqrt(6/fan_in)), BN scale N(1, 0.02), biases zero, norms identity,
    LayerScale gammas constant (transformer.py:94-99)."""
    for m in module.modules():
        if isinstance(m, TransformerBlock):
            m.gamma1.fill_(m.init_scale)
            m.gamma2.fill_(m.init_scale)
        if isinstance(m, nn.Conv2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            bound = math.sqrt(6.0 / m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.MultiheadAttention):
            bound = math.sqrt(6.0 / m.embed_dim)
            m.in_proj_weight.uniform_(-bound, bound, generator=generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.normal_(1.0, 0.02, generator=generator)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


def build_fusion_models(cfg: Config, device="cuda", dtype: torch.dtype = torch.float32,
                        generator: Optional[torch.Generator] = None,
                        backbone_layers: Sequence[int] = (3, 4, 6, 3)
                        ) -> Tuple[Encoder, Encoder, FusionModel]:
    """``(dwi_encoder, dce_encoder, fusion)`` on ``device`` in ``dtype``.

    ``generator`` must live on ``device`` (default: one seeded with
    ``cfg.seed``).  ``backbone_layers`` cuts the ResNet depth for small
    tests; widths always come from ``cfg``.
    """
    if generator is None:
        generator = torch.Generator(device).manual_seed(cfg.seed)
    kw = {"device": device, "dtype": dtype}
    dwi = Encoder("dwi", resolve_backbone_config(cfg.dwi_model),
                  cfg.dwi_channel_num, cfg.class_num, backbone_layers, **kw)
    dce = Encoder("dce", resolve_backbone_config(cfg.dce_model),
                  cfg.dce_channel_num, cfg.class_num, backbone_layers, **kw)
    fusion = FusionModel(
        cfg.fusion_model, cfg.class_num,
        dwi_channels=dwi.config.channels[-1], dce_channels=dce.config.channels[-1],
        feature_size=dwi.feature_size,
        with_masks=dwi.mask_stage is not None and dce.mask_stage is not None,
        **kw)
    models = (dwi, dce, fusion)
    for m in models:
        init_weights(m, generator)
        if torch.device(device).type == "cuda":
            m.to(memory_format=torch.channels_last)
    return models
