"""Hybrid CNN->Transformer stage, counterpart of ``dmf_tpu/models/transformer.py``.

Reference transformer_model.py:1-175: a strided-conv patchify + LayerNorm,
pre-LN blocks with LayerScale residuals (init 0.1), multi-head
self-attention with attention and projection dropout 0.1, a 4x MLP with
exact GELU, and the tokens re-shaped into a feature map.  Module names follow
the reference layout that ``ref_ckpt.py:166-183`` emits:
``patch_embed.{proj,norm}`` and ``transformer.layers.{i}.{norm1, attn.qkv,
attn.proj, norm2, mlp.fc1, mlp.fc2, gamma1, gamma2}``.

Modes are explicit arguments, as in the JAX modules: ``mc=True`` turns every
dropout on, drawing its masks from an explicit ``torch.Generator`` (or from a
:class:`~..ops.dropout.SeedStream`, the serving program's seed route, passed
in its place), and then
attention takes the weights route (dropout on the materialized weights, then
the value product, transformer.py:45-49); otherwise attention goes through
:func:`~dmf_tpu_torch.ops.attention.scaled_dot_product_attention`, which
takes the flash kernels on the card at the hybrid stage's 4096 tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import scaled_dot_product_attention
from .layers import dropout


class MultiHeadSelfAttention(nn.Module):
    """Reference transformer_model.py:83-116; ``qkv`` is one packed Linear."""

    def __init__(self, embed_dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.1, proj_drop: float = 0.1, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim, bias=qkv_bias, **kw)
        self.proj = nn.Linear(embed_dim, embed_dim, **kw)

    def forward(self, x: torch.Tensor, mc: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        # (B, N, 3, H, D) -> (3, B, H, N, D), as transformer.py:41-43; the
        # flash route copies q, k and v into contiguous tensors
        q, k, v = self.qkv(x).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        if mc and self.attn_drop > 0.0:
            # attention-weight dropout needs the materialized weights
            _, w = scaled_dot_product_attention(q, k, v, return_weights=True)
            w = dropout(w, self.attn_drop, generator)
            out = torch.einsum("bhqk,bhkd->bhqd", w, v)
        else:
            out = scaled_dot_product_attention(q, k, v)
        out = self.proj(out.transpose(1, 2).reshape(B, N, C))
        return dropout(out, self.proj_drop if mc else 0.0, generator)


class MLP(nn.Module):
    """Reference transformer_model.py:118-134."""

    def __init__(self, embed_dim: int, mlp_ratio: float = 4.0, drop: float = 0.1, **kw):
        super().__init__()
        hidden = int(embed_dim * mlp_ratio)
        self.drop = drop
        self.fc1 = nn.Linear(embed_dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, embed_dim, **kw)

    def forward(self, x, mc: bool = False, generator: Optional[torch.Generator] = None):
        p = self.drop if mc else 0.0
        x = dropout(F.gelu(self.fc1(x)), p, generator)
        return dropout(self.fc2(x), p, generator)


class TransformerBlock(nn.Module):
    """Pre-LN block with LayerScale residuals (reference transformer_model.py:68-81)."""

    def __init__(self, embed_dim: int, heads: int, init_scale: float = 0.1, **kw):
        super().__init__()
        self.init_scale = init_scale
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5, **kw)
        self.attn = MultiHeadSelfAttention(embed_dim, heads, **kw)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5, **kw)
        self.mlp = MLP(embed_dim, **kw)
        self.gamma1 = nn.Parameter(torch.full((embed_dim,), init_scale, **kw))
        self.gamma2 = nn.Parameter(torch.full((embed_dim,), init_scale, **kw))

    def forward(self, x, mc: bool = False, generator: Optional[torch.Generator] = None):
        x = x + self.attn(self.norm1(x), mc, generator) * self.gamma1
        return x + self.mlp(self.norm2(x), mc, generator) * self.gamma2


class PatchEmbed(nn.Module):
    """Strided-conv patchify + LayerNorm over the tokens."""

    def __init__(self, in_ch: int, embed_dim: int, patch_size: int, **kw):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, stride=patch_size, **kw)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5, **kw)


class TransformerStage(nn.Module):
    """Patchify -> encoder blocks -> feature map (reference transformer_model.py:137-175).

    Input (B, C, H, W); output (B, embed_dim, H/p, W/p).  Tokens are in
    row-major (h, w) order, as the JAX stage flattens its NHWC map; on a
    ``channels_last`` map the token view and the map view are the same memory.
    """

    def __init__(self, in_ch: int, embed_dim: int, depth: int = 2, heads: int = 8,
                 patch_size: int = 2, **kw):
        super().__init__()
        self.patch_embed = PatchEmbed(in_ch, embed_dim, patch_size, **kw)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            TransformerBlock(embed_dim, heads, **kw) for _ in range(depth))

    def forward(self, x: torch.Tensor, mc: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.patch_embed.proj(x)
        B, C, Hp, Wp = x.shape
        tokens = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        for block in self.transformer.layers:
            tokens = block(tokens, mc, generator)
        return tokens.transpose(1, 2).reshape(B, C, Hp, Wp)
