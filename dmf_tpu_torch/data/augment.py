"""Train-time augmentation and eval resize (NHWC), counterpart of
``dmf_tpu/data/augment.py``.

RandomAffine(degrees=+-90, translate=(0.1, 0.1), shear=0.1) with nearest
sampling and zero fill, then random horizontal and vertical flips, then a
bilinear resize to the input size (the reference's torchvision pipeline,
prepare_single_model.py:107-114).  The whole batch is warped in one gather.

Randomness comes from an explicit ``torch.Generator`` on the images' device
in place of ``jax.random`` keys; the two give different streams, so the
augmentation agrees with the JAX package in distribution, and exactly for
fixed parameters (:func:`affine_nearest`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops.resize import resize_bilinear


def _resize_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    if tuple(x.shape[-3:-1]) == (size, size):
        return x
    single = x.dim() == 3
    y = resize_bilinear((x[None] if single else x).permute(0, 3, 1, 2), (size, size))
    y = y.permute(0, 2, 3, 1).contiguous()
    return y[0] if single else y


def affine_nearest(img: torch.Tensor, angle_deg, translate_xy, shear_xy_deg) -> torch.Tensor:
    """Affine warp about the image centre, nearest sampling, zero fill.

    ``img`` (H, W, C), or (N, H, W, C) with each parameter a scalar or an
    (N,) tensor.  The inverse map follows augment.py:24-73 in fp32:
    ``src = inv(R(angle) @ Shear) @ (out - centre - translate) + centre``,
    rounded half to even.
    """
    single = img.dim() == 3
    x = img[None] if single else img
    N, H, W, C = x.shape
    f32 = {"dtype": torch.float32, "device": x.device}

    def vec(v):
        return torch.as_tensor(v, **f32).reshape(-1).expand(N)

    a = vec(angle_deg) * math.pi / 180.0
    sx = vec(shear_xy_deg[0]) * math.pi / 180.0
    sy = vec(shear_xy_deg[1]) * math.pi / 180.0
    cos_a, sin_a = torch.cos(a), torch.sin(a)
    one = torch.ones_like(a)
    R = torch.stack([torch.stack([cos_a, -sin_a], -1), torch.stack([sin_a, cos_a], -1)], -2)
    S = torch.stack([torch.stack([one, torch.tan(sx)], -1),
                     torch.stack([torch.tan(sy), one], -1)], -2)
    m_inv = torch.linalg.inv(R @ S)  # (N, 2, 2)
    cx, cy = (W - 1) * 0.5, (H - 1) * 0.5
    ys, xs = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32), indexing="ij")
    out_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], 0)  # (2, HW)
    offset = torch.stack([cx + vec(translate_xy[0]), cy + vec(translate_xy[1])], -1)
    ctr = torch.tensor([cx, cy], **f32)
    src = m_inv @ (out_xy[None] - offset[:, :, None]) + ctr[None, :, None]  # (N, 2, HW)
    src_x = torch.round(src[:, 0]).long()
    src_y = torch.round(src[:, 1]).long()
    valid = (src_x >= 0) & (src_x < W) & (src_y >= 0) & (src_y < H)
    idx = src_y.clamp(0, H - 1) * W + src_x.clamp(0, W - 1)  # (N, HW)
    out = torch.gather(x.reshape(N, H * W, C), 1, idx[..., None].expand(N, H * W, C))
    out = torch.where(valid[..., None], out, 0.0).reshape(N, H, W, C)
    return out[0] if single else out


def random_affine_flip(generator: torch.Generator, imgs: torch.Tensor,
                       degrees: float = 90.0,
                       translate: Tuple[float, float] = (0.1, 0.1),
                       shear: Tuple[float, float] = (0.1, 0.1)) -> torch.Tensor:
    """RandomAffine + H/V flips of (H, W, C) or (N, H, W, C) images, each
    image with its own draw from ``generator``."""
    single = imgs.dim() == 3
    x = imgs[None] if single else imgs
    N, H, W, _ = x.shape
    u = torch.rand((N, 3), generator=generator, device=x.device)
    angle = -degrees + 2.0 * degrees * u[:, 0]
    tx = (2.0 * u[:, 1] - 1.0) * (translate[0] * W)
    ty = (2.0 * u[:, 2] - 1.0) * (translate[1] * H)
    flips = torch.rand((N, 2), generator=generator, device=x.device) < 0.5
    # torchvision shear=(0.1, 0.1) is the (min, max) range of the x-shear only
    out = affine_nearest(x, angle, (tx, ty), ((shear[0] + shear[1]) * 0.5, 0.0))
    out = torch.where(flips[:, 0, None, None, None], out.flip(2), out)
    out = torch.where(flips[:, 1, None, None, None], out.flip(1), out)
    return out[0] if single else out


def augment_batch(generator: torch.Generator, imgs: torch.Tensor, input_size: int,
                  degrees: float = 90.0, translate: Tuple[float, float] = (0.1, 0.1),
                  shear: Tuple[float, float] = (0.1, 0.1)) -> torch.Tensor:
    """(N, H, W, C) -> (N, input_size, input_size, C): augment, then resize."""
    return _resize_nhwc(random_affine_flip(generator, imgs, degrees, translate, shear),
                        input_size)


def eval_resize(imgs: torch.Tensor, input_size: int) -> torch.Tensor:
    """Val/test pipeline: resize only (prepare_single_model.py:115-123)."""
    return _resize_nhwc(imgs, input_size)
