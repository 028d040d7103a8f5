"""Checkpoint import: a torch ResNet-50 state dict -> a state dict of the
port's :class:`~.resnet.ResNetFeatures`.

Counterpart of the import side of ``dmf_tpu/models/backbones/importers.py``
(:36-186), the reference's weight plumbing:

* RadImageNet (Lab-Rasool) key remapping (foundation_model.py:180-218);
* first-conv channel adaptation for N-channel grayscale medical input:
  simple mean-replicate (foundation_model.py:99-124) and the advanced
  BT.601-luminance + deterministic linspace scaling variant
  (foundation_model.py:128-176).

The adaptation and the remap are numpy, bit for bit the JAX package's
arithmetic.  ``ResNetFeatures`` is in timm's key layout, so the import
adapts the stem conv and checks the checkpoint against the module: every
key it needs, its shape, and the count of imported tensors.  No network
access: callers supply a loaded state dict.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .resnet import ResNetFeatures


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
