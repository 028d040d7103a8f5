"""Plain softmax attention that can return its weights.

Counterpart of the XLA route of ``dmf_tpu/ops/attention.py`` (``_xla_attention``,
:20-26).  The fusion cross-attention has 16 tokens and asks for its weights,
so the flash route (a TPU kernel for the hybrid-transformer encoders) is not
on this path.  Rounding follows the JAX route: the softmax runs in fp32 and
the weights are cast back to the input dtype before the value product.
"""

from __future__ import annotations

from typing import Optional

import torch


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 scale: Optional[float] = None,
                                 return_weights: bool = False):
    """Attention over (B, H, N, D) tensors; returns ``out`` or ``(out, weights)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
    return (out, weights) if return_weights else out
