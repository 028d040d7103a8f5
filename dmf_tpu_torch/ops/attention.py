"""Softmax attention: the plain route, and the dispatch to the flash kernels.

Counterpart of ``dmf_tpu/ops/attention.py``.  The plain route is the JAX
package's XLA route (``_xla_attention``, :20-26): the softmax runs in fp32
and the weights are cast back to the input dtype before the value product.
The flash route (``ops/flash_attention.py``) is taken under the JAX rule
(:45-61), kept exactly so that both packages take the same route at the same
shapes: no weights asked for, ``N_q == N_k >= 512`` and ``N % 512 == 0``;
on the port it is taken for CUDA tensors (the JAX package takes it on the
TPU).  The fusion cross-attention (16 tokens, with weights) stays plain.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import attention_weights, flash_attention

# the JAX kernel's default blocks (flash_attention.py:38-39); N must be a
# multiple of both, clamped to N, for the JAX package to dispatch it
_JAX_BLOCKS = (256, 512)


def use_flash(n_q: int, n_k: int, return_weights: bool) -> bool:
    """The JAX package's shape rule for the flash route (attention.py:53-59)."""
    return (not return_weights and n_q >= 512 and n_q == n_k
            and all(n_q % min(b, n_q) == 0 for b in _JAX_BLOCKS))


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float):
    """``(out, weights)`` with the (N_q, N_k) weights materialized."""
    weights = attention_weights(q, k, scale)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
    return out, weights


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 scale: Optional[float] = None,
                                 return_weights: bool = False):
    """Attention over (B, H, N, D) tensors; returns ``out`` or ``(out, weights)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda and use_flash(q.shape[-2], k.shape[-2], return_weights):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale)
    out, weights = plain_attention(q, k, v, scale)
    return (out, weights) if return_weights else out
