"""Standalone squeeze-excitation ``(x * s, s)``: wrapper and plain version.

Counterpart of ``dmf_tpu/ops/se_pallas.py::se_scale`` (the Pallas kernel
``_se_kernel``), which ``SEBlock(fused=True)`` reaches.  The wrapper calls the
``se_scale`` operator (``ops/library.py``), which runs the plain version below
for tensors on the CPU, and the CUDA kernel ``csrc/se_scale.cu`` (through
``se_cuda.py``) for tensors on a CUDA device; there is no fallback from one to
the other.

Rounding points follow the TPU kernel (se_pallas.py:112-127): weights and
biases are cast to the map dtype; the pool is an fp32 sum rounded to the map
dtype; both dense layers accumulate in fp32; GELU (exact erf) and sigmoid run
in fp32 and the hidden activation is rounded to the map dtype; the output is
``x * s`` in fp32 rounded once, and ``s`` is returned in the map dtype.

Maps are (N, C, H, W); weights use torch's (out, in) layout, i.e. the
reference's ``fc.1``/``fc.3`` 1x1 convs: ``w1`` (mid, C), ``w2`` (C, mid).
``s`` comes back shaped (N, C, 1, 1), as ``SEBlock`` returns it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def se_scale_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version; returns ``(x * s, s)``."""
    dt = x.dtype
    c = x.shape[1]
    w1 = w1.reshape(-1, c).to(dt).float()
    w2 = w2.reshape(c, -1).to(dt).float()
    n_pix = x.shape[2] * x.shape[3]
    pool = (x.float().sum(dim=(2, 3)) / n_pix).to(dt).float()
    h = F.gelu(pool @ w1.t() + b1.to(dt).float()).to(dt).float()
    s = torch.sigmoid(h @ w2.t() + b2.to(dt).float())
    return (x.float() * s[:, :, None, None]).to(dt), s.to(dt)[:, :, None, None]


def se_scale(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x * sigmoid(W2 gelu(W1 pool(x) + b1) + b2), s)``.

    Goes through the ``se_scale`` operator (``ops/library.py``): CPU tensors
    take :func:`se_scale_ref` (directly where autograd would record the
    call).  CUDA tensors launch the CUDA kernel, which takes
    ``channels_last`` fp32 or bf16 maps and raises on anything else; the
    output is ``channels_last``.  The kernel has no backward, so on the card
    a call that autograd would record raises.
    """
    from .prepared import check_no_grad, records_grad

    if x.device.type == "cpu" and records_grad(x, w1, b1, w2, b2):
        return se_scale_ref(x, w1, b1, w2, b2)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"se_scale: unsupported device {x.device}")
    check_no_grad("se_scale", x, w1, b1, w2, b2)
    return torch.ops.dmf.se_scale(x, w1, b1, w2, b2)


se_scale.launches = 0
