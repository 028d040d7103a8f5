"""ViT-B/16 feature backbone (NCHW input, per-block token outputs).

Counterpart of ``dmf_tpu/models/backbones/vit.py`` (:24-111), the
reference's timm ViT/DINO ``features_only`` backbone
(foundation_model.py:371-431): a 16x16 patch embedding, a cls token and a
position embedding sized for the configured image (the reference overrides
``img_size=256``; ``importers.import_vit_base`` resizes a 224-grid one), and
12 pre-LN blocks whose token outputs, the cls token stripped, are returned
as (B, N, C), one per block, so that the adapter can chain them ([0-2],
[3-6], [7-11]).

Parameter names are timm's (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.norm1``, ``attn.qkv``, ``attn.proj``, ``norm2``,
``mlp.fc1``, ``mlp.fc2``), so a timm state dict loads with ``strict=True``.
LayerNorm eps is 1e-6 and the GELU exact, as in the JAX module (:49-55).
Attention goes through the port's ``ops/attention.py``, whose rule keeps
ViT-B/16's 257 tokens on the plain route in both packages.  The JAX
module's own initialisers are :meth:`ViTFeatures.reset_parameters`.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import scaled_dot_product_attention


class ViTSize(NamedTuple):
    """The widths a ViT is built with; ViT-B/16 by default."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12


class ViTSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim, **kw)
        self.proj = nn.Linear(embed_dim, embed_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, embed_dim: int, hidden: int, **kw):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, embed_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: float = 4.0, **kw):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6, **kw)
        self.attn = ViTSelfAttention(embed_dim, num_heads, **kw)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-6, **kw)
        self.mlp = Mlp(embed_dim, int(embed_dim * mlp_ratio), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, embed_dim: int, patch_size: int, **kw):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (B, C, g, g) -> (B, g*g, C): token r*g + c is patch (r, c), the JAX
        # module's row-major reshape of its NHWC map
        return self.proj(x).flatten(2).transpose(1, 2)


class ViTFeatures(nn.Module):
    """``forward(x, train) -> [block outputs as (B, N, C) tokens]``; ``train``
    changes nothing (the module has no dropout and no BatchNorm)."""

    def __init__(self, in_channels: int = 3, img_size: int = 256, patch_size: int = 16,
                 size: ViTSize = ViTSize(), **kw):
        super().__init__()
        embed_dim, depth, num_heads = size
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size, **kw)
        n_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim, **kw))
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, num_heads, **kw)
                                    for _ in range(depth))
        self.output_dims = (embed_dim,) * depth
        self.reductions = (patch_size,) * depth

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the weights with the JAX module's initialisers: Flax's default
        ``lecun_normal`` for every dense and conv kernel (a normal truncated
        at two standard deviations, variance 1 / fan_in), zero biases,
        ``pos_embed`` from normal(0.02), a zero ``cls_token`` and identity
        LayerNorms (vit.py:33-95)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.cls_token.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        feats = []
        for block in self.blocks:
            x = block(x)
            feats.append(x[:, 1:])  # strip the cls token
        return feats


# Flax's truncated_normal draws from N(0, 1) truncated to [-2, 2] and
# divides its stddev by that distribution's own (initializers.py)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's ``lecun_normal`` in place: fan_in = the elements of one output
    unit (in x kh x kw for a conv, in for a dense kernel)."""
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    lo, hi = (0.5 * (1.0 + math.erf(t / math.sqrt(2.0))) for t in (-2.0, 2.0))
    u = torch.empty_like(w, dtype=torch.float32).uniform_(lo, hi, generator=generator)
    w.copy_(torch.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std))


def vit_base_patch16(in_channels: int, img_size: int = 256, size: ViTSize = ViTSize(),
                     **kw) -> ViTFeatures:
    return ViTFeatures(in_channels, img_size, 16, size, **kw)
