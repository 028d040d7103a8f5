"""ResLite-block epilogue ``SE(dropout(gelu(x + identity)))``: wrapper and plain version.

Counterpart of ``dmf_tpu/ops/epilogue_pallas.py::se_epilogue`` (the Pallas
kernels ``_epilogue_kernel`` / ``_epilogue_kernel_t``).  The wrapper runs the
plain version below for tensors on the CPU, and the Triton kernel in
``epilogue_triton.py`` for tensors on a CUDA device; there is no fallback
from one to the other.

Rounding points follow the TPU kernel (epilogue_pallas.py:226-252): the
residual add and GELU run in fp32 and ``y`` is rounded to the map dtype; the
dropout scale ``1/(1-p)`` is applied in the map dtype; the pool is an fp32
sum rounded to the map dtype; the SE MLP accumulates in fp32 with the hidden
activation rounded to the map dtype; the sigmoid and the final product run in
fp32.  Weights are cast to the map dtype first.

Maps are (N, C, H, W); SE weights use torch's (out, in) layout, i.e. the
reference's ``se.fc.1``/``se.fc.3`` 1x1 convs: ``w1`` (C/2, C), ``w2`` (C, C/2).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def se_epilogue_ref(x: torch.Tensor, identity: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor,
                    drop_rate: float = 0.0,
                    keep: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Plain PyTorch version; ``keep`` (bool, shape of ``x``) injects a mask.

    With ``drop_rate > 0`` and no ``keep``, the mask is drawn from
    ``generator`` (keep with probability ``1 - drop_rate``).
    """
    dt = x.dtype
    c = x.shape[1]
    w1 = w1.reshape(-1, c).to(dt).float()
    w2 = w2.reshape(c, -1).to(dt).float()
    y = F.gelu(x.float() + identity.float()).to(dt)
    if drop_rate > 0.0:
        if keep is None:
            if generator is None:
                raise ValueError("drop_rate > 0 requires a keep mask or a generator")
            keep = torch.empty_like(x, dtype=torch.float32).uniform_(
                generator=generator) < (1.0 - drop_rate)
        scale = torch.tensor(1.0 / (1.0 - drop_rate), dtype=dt, device=x.device)
        y = y * keep.to(dt) * scale
    n_pix = x.shape[2] * x.shape[3]
    pool = (y.float().sum(dim=(2, 3)) / n_pix).to(dt).float()
    h = F.gelu(pool @ w1.t() + b1.to(dt).float()).to(dt).float()
    s = torch.sigmoid(h @ w2.t() + b2.to(dt).float())
    return (y.float() * s[:, :, None, None]).to(dt)


def se_epilogue(x: torch.Tensor, identity: torch.Tensor,
                w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor,
                drop_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fused ``SE(dropout(gelu(x + identity)))``; returns the scaled map.

    CPU tensors take :func:`se_epilogue_ref`.  CUDA tensors launch the Triton
    kernel, which takes ``channels_last`` maps in fp32 or bf16 and raises on
    anything else.  ``drop_rate > 0`` needs ``generator`` (on the tensors'
    device): it supplies the mask on the CPU and the kernel's Philox seed on
    the card.
    """
    if drop_rate > 0.0 and generator is None:
        raise ValueError("drop_rate > 0 requires a generator")
    if x.device.type == "cpu":
        return se_epilogue_ref(x, identity, w1, b1, w2, b2, drop_rate,
                               generator=generator)
    if x.device.type != "cuda":
        raise ValueError(f"se_epilogue: unsupported device {x.device}")
    from .epilogue_triton import draw_seed, launch_se_epilogue

    seed = draw_seed(generator, x.device) if drop_rate > 0.0 else None
    out = launch_se_epilogue(x, identity, w1, b1, w2, b2, drop_rate, seed)
    se_epilogue.launches += 1
    return out


se_epilogue.launches = 0
