"""Checkpoint import: a torch ResNet-50 or ViT-B/16 state dict -> a state
dict of the port's :class:`~.resnet.ResNetFeatures` or
:class:`~.vit.ViTFeatures`.

Counterpart of the import side of ``dmf_tpu/models/backbones/importers.py``
(:36-186, :249-299), the reference's weight plumbing:

* RadImageNet (Lab-Rasool) key remapping (foundation_model.py:180-218);
* first-conv channel adaptation for N-channel grayscale medical input:
  simple mean-replicate (foundation_model.py:99-124) and the advanced
  BT.601-luminance + deterministic linspace scaling variant
  (foundation_model.py:128-176);
* the ViT position embedding's bicubic resize from the checkpoint's grid to
  the module's (the reference builds its 224-trained ViTs at
  ``img_size=256``, foundation_model.py:321-369).

The adaptation, the remap and the resize are numpy, the JAX package's
arithmetic (the resize is ``jax.image.resize``'s formula written out).  Both
modules are in timm's key layout, so an import adapts the first conv and
checks the checkpoint against the module: every key it needs and its shape
(and for ResNet-50 the count of imported tensors).  The export direction
needs no converter: the module's state dict is already the timm layout
(``models/weights.py``).  No network access: callers supply a loaded state
dict.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .resnet import ResNetFeatures
from .vit import ViTFeatures, ViTSize


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


# ---------------------------------------------------------------------------
# First-conv channel adaptation
# ---------------------------------------------------------------------------


def adapt_first_conv(w: np.ndarray, in_channels: int) -> np.ndarray:
    """Mean-replicate adaptation (foundation_model.py:99-124). OIHW."""
    if w.shape[1] == in_channels:
        return w
    w_mean = w.mean(axis=1, keepdims=True)
    return np.repeat(w_mean, in_channels, axis=1)


def advanced_adapt_first_conv(
    w: np.ndarray, in_channels: int, eps: float = 0.05
) -> np.ndarray:
    """BT.601-luminance + monotonic per-channel scaling
    (foundation_model.py:128-176). OIHW."""
    if w.shape[1] == in_channels:
        return w
    if w.shape[1] >= 3:
        lum = 0.2989 * w[:, 0:1] + 0.5870 * w[:, 1:2] + 0.1140 * w[:, 2:3]
    else:
        lum = w.mean(axis=1, keepdims=True)
    w_new = np.repeat(lum, in_channels, axis=1)
    scales = np.linspace(1.0 - eps, 1.0 + eps, in_channels).reshape(
        1, in_channels, 1, 1
    )
    return (w_new * scales).astype(w.dtype)


# ---------------------------------------------------------------------------
# RadImageNet (Lab-Rasool) -> timm key remap (foundation_model.py:180-218)
# ---------------------------------------------------------------------------


def map_rasool_to_timm_keys(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    layer_map = {"4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4"}
    out = {}
    for k, v in sd.items():
        nk = k[len("backbone."):] if k.startswith("backbone.") else k
        if nk == "0.weight":
            nk = "conv1.weight"
        elif nk.startswith("1."):
            nk = "bn1." + nk[2:]
        elif nk and nk[0] in layer_map and len(nk) > 1 and nk[1] == ".":
            nk = f"{layer_map[nk[0]]}.{nk[2:]}"
        if nk.startswith("fc."):
            continue
        out[nk] = v
    return out


# ---------------------------------------------------------------------------
# ResNet import
# ---------------------------------------------------------------------------


def import_resnet50(
    state_dict: Mapping[str, object],
    in_channels: int,
    use_advanced_adapt: bool = True,
    deep_stem: bool = False,
    min_tensors: int = 100,
) -> Dict[str, torch.Tensor]:
    """A timm-layout ResNet-50 (``deep_stem``: resnet50d) state dict ->
    the state dict of ``ResNetFeatures(in_channels)`` (CPU tensors), with
    the first conv adapted to ``in_channels``.

    For RadImageNet checkpoints call :func:`map_rasool_to_timm_keys` first
    (the reference chains them the same way, foundation_model.py:275-281).
    Keys the module does not hold (timm's ``fc``) are ignored.  Raises
    ``KeyError`` on a missing tensor, ``ValueError`` on a shape mismatch and
    ``RuntimeError`` if fewer than ``min_tensors`` tensors were imported,
    the reference's >=100-loaded-tensors check (foundation_model.py:297-301),
    counted as the JAX package counts: conv weights and the four BatchNorm
    arrays, not the ``num_batches_tracked`` counters.  A counter the
    checkpoint lacks is set to 0.
    """
    sd = {k: _np(v) for k, v in state_dict.items()}

    # adapt the first conv (on OIHW, like the reference)
    first_key = "conv1.0.weight" if deep_stem else "conv1.weight"
    if first_key in sd:
        adapt = advanced_adapt_first_conv if use_advanced_adapt else adapt_first_conv
        sd[first_key] = adapt(sd[first_key], in_channels)

    # the module on the meta device: its keys and shapes, nothing allocated
    template = ResNetFeatures(in_channels, deep_stem=deep_stem, avg_down=deep_stem,
                              device="meta").state_dict()
    out: Dict[str, torch.Tensor] = {}
    n_loaded = 0
    for key, ref in template.items():
        if key.endswith("num_batches_tracked"):
            out[key] = (torch.from_numpy(np.array(sd[key], np.int64)).reshape(())
                        if key in sd else torch.zeros((), dtype=torch.int64))
            continue
        if key not in sd:
            raise KeyError(f"ResNet-50 checkpoint has no tensor {key!r}")
        arr = sd[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch importing {key!r}: checkpoint "
                             f"{tuple(arr.shape)} vs module {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(arr, np.float32))
        n_loaded += 1
    if n_loaded < min_tensors:
        raise RuntimeError(
            f"suspiciously few tensors imported ({n_loaded} < {min_tensors}) "
            "— checkpoint layout mismatch (foundation_model.py:297-301)"
        )
    return out


# ---------------------------------------------------------------------------
# ViT import
# ---------------------------------------------------------------------------


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 (jax.image's
    ``_fill_keys_cubic_kernel``; torch's bicubic uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """The (n_in, n_out) float32 resampling matrix of ``jax.image.resize``'s
    ``"bicubic"`` along one axis (its ``compute_weight_mat``, antialiased):
    half-pixel centres; when shrinking, the kernel is widened by the scale;
    each output's weights are renormalised to sum to one over the input
    taps (so taps outside the grid are dropped, not clamped)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_pos_embed(pos: np.ndarray, new_grid: int) -> np.ndarray:
    """Bicubically resize the (1, 1 + G*G, C) position embedding to a
    ``new_grid`` x ``new_grid`` grid, the cls token kept, as
    ``jax.image.resize(..., "bicubic")`` does it (importers.py:254-269)."""
    pos = np.asarray(pos, np.float32)
    cls_tok, grid = pos[:, :1], pos[:, 1:]
    g = int(round(np.sqrt(grid.shape[1])))
    if g == new_grid:
        return pos
    w = _cubic_weights(g, new_grid).astype(np.float64)
    grid = grid.reshape(g, g, -1).astype(np.float64)
    resized = np.einsum("hwc,hH,wW->HWc", grid, w, w).astype(np.float32)
    return np.concatenate([cls_tok, resized.reshape(1, new_grid * new_grid, -1)], axis=1)


def import_vit_base(state_dict: Mapping[str, object], in_channels: int,
                    img_size: int = 256, patch_size: int = 16, depth: Optional[int] = None,
                    use_advanced_adapt: bool = True) -> Dict[str, torch.Tensor]:
    """A timm ``vit_base_patch16``-layout state dict -> the state dict of
    ``ViTFeatures(in_channels, img_size, patch_size)`` (CPU tensors).

    The patch embedding is adapted to ``in_channels`` and the position
    embedding resized to the module's grid ``img_size // patch_size``.  The
    width comes from the checkpoint; ``depth`` (default: the checkpoint's
    block count) is the number of blocks imported.  Keys the module does not
    hold (timm's ``norm``, ``head``) are ignored.  Raises ``KeyError`` on a
    missing tensor and ``ValueError`` on a shape mismatch.
    """
    sd = {k: _np(v) for k, v in state_dict.items()}
    if depth is None:
        depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    adapt = advanced_adapt_first_conv if use_advanced_adapt else adapt_first_conv
    if "patch_embed.proj.weight" in sd:
        sd["patch_embed.proj.weight"] = adapt(sd["patch_embed.proj.weight"], in_channels)
    if "pos_embed" in sd:
        sd["pos_embed"] = resize_pos_embed(sd["pos_embed"], img_size // patch_size)
    width = int(sd["cls_token"].shape[-1]) if "cls_token" in sd else 768
    template = ViTFeatures(in_channels, img_size, patch_size, ViTSize(width, depth, 1),
                           device="meta").state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, ref in template.items():
        if key not in sd:
            raise KeyError(f"ViT checkpoint has no tensor {key!r}")
        arr = sd[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch importing {key!r}: checkpoint "
                             f"{tuple(arr.shape)} vs module {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(arr, np.float32))
    return out
