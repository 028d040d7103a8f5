"""ResLite-block epilogue ``SE(dropout(gelu(x + identity)))``: wrapper and plain version.

Counterpart of ``dmf_tpu/ops/epilogue_pallas.py::se_epilogue`` (the Pallas
kernels ``_epilogue_kernel`` / ``_epilogue_kernel_t``).  The wrapper calls the
``se_epilogue`` operator (``ops/library.py``), which runs the plain version
below for tensors on the CPU, and the CUDA kernel ``csrc/se_epilogue.cu``
(through ``epilogue_cuda.py``) for tensors on a CUDA device; there is no
fallback from one to the other.

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

from typing import Optional, Union

import torch
import torch.nn.functional as F

from .dropout import SeedStream, keep_mask_plain


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
                generator: Union[torch.Generator, SeedStream, None] = None) -> torch.Tensor:
    """Fused ``SE(dropout(gelu(x + identity)))``; returns the scaled map.

    Goes through the ``se_epilogue`` operator (``ops/library.py``): CPU
    tensors take :func:`se_epilogue_ref`, CUDA tensors launch the CUDA
    kernel, which takes ``channels_last`` maps in fp32 or bf16 and raises on
    anything else.  ``drop_rate > 0`` needs ``generator``: a
    ``torch.Generator`` on the tensors' device supplies the mask on the CPU
    (the plain version, called directly) and the kernel's Philox seed on the
    card; a :class:`~.dropout.SeedStream` (the seed route) supplies the seed
    and the site's counter base on both devices, so both draw the same mask.
    The kernel has no backward, so on the card a call that autograd would
    record raises; on the CPU such a call takes the plain version directly.
    """
    from .prepared import check_no_grad, records_grad

    if drop_rate > 0.0 and generator is None:
        raise ValueError("drop_rate > 0 requires a generator")
    params = (w1, b1, w2, b2)
    seed, base = None, 0
    if drop_rate > 0.0 and isinstance(generator, SeedStream):
        seed, base = generator.seed, generator.take(x.numel())
    elif drop_rate > 0.0:
        if x.device.type == "cpu":
            return se_epilogue_ref(x, identity, *params, drop_rate, generator=generator)
        if x.device.type == "cuda":
            from .epilogue_cuda import draw_seed

            seed = draw_seed(generator, x.device)
    if x.device.type == "cpu" and records_grad(x, identity, *params):
        keep = keep_mask_plain(x.shape, drop_rate, seed, base) if seed is not None else None
        return se_epilogue_ref(x, identity, *params, drop_rate, keep=keep)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"se_epilogue: unsupported device {x.device}")
    check_no_grad("se_epilogue", x, identity, *params)
    return torch.ops.dmf.se_epilogue(x, identity, *params, drop_rate, seed, base)


se_epilogue.launches = 0
