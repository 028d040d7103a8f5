"""Mask visualisation (the reference's train.py:945-989), counterpart of
``dmf_tpu/utils/visualize.py``.

The same panels (input, GT mask, predicted mask logits, the prediction
binarised at sigmoid > 0.5) as the JAX function hands to matplotlib, written
as one 8-bit grayscale PNG by the standard library alone (``zlib``,
``struct``): the card's machine has no matplotlib.  The panels stand side by
side, top-aligned, ``GAP`` black columns apart; each is scaled from its own
minimum to its own maximum as ``imshow(cmap="gray")`` autoscales (a constant
panel is black), and the titles go into a ``tEXt`` chunk (keyword
``Title``, the panels' titles joined by `` | ``).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

GAP = 4  # black columns between panels


def _to2d(x) -> np.ndarray:
    x = np.asarray(x)
    while x.ndim > 2:
        x = x[..., 0] if x.shape[-1] <= 4 else x[0]
    return x


def mask_panels(input_img: np.ndarray, gt_mask: Optional[np.ndarray],
                pred_mask: np.ndarray, title_prefix: str = ""
                ) -> List[Tuple[np.ndarray, str]]:
    """The ``(image, title)`` panels of :func:`visualize_mask_triplet`."""
    input_img = np.asarray(input_img)
    img = _to2d(input_img if input_img.ndim == 2 else input_img[..., 0])
    pred = _to2d(pred_mask)
    pred_bin = (1.0 / (1.0 + np.exp(-pred)) > 0.5).astype(np.float32)
    panels = [(img, f"{title_prefix}Input")]
    if gt_mask is not None:
        panels.append((_to2d(gt_mask), "GT Mask"))
    return panels + [(pred, "Pred Mask"), (pred_bin, "Pred Bin")]


def to_gray8(x: np.ndarray) -> np.ndarray:
    """``x`` scaled from its minimum to its maximum into 8-bit gray, as
    matplotlib's ``Normalize`` and its 256-entry gray colormap map it:
    ``min(floor(256 * (x - min) / (max - min)), 255)``."""
    x = np.asarray(x, np.float64)
    lo, hi = float(x.min()), float(x.max())
    if not hi > lo:
        return np.zeros(x.shape, np.uint8)
    return np.minimum(np.floor((x - lo) / (hi - lo) * 256.0), 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png_gray8(path: str, image: np.ndarray, text: str = "") -> None:
    """Write a (H, W) uint8 image as an 8-bit grayscale PNG, ``text`` in a
    ``tEXt`` chunk under the keyword ``Title``."""
    h, w = image.shape
    raw = b"".join(b"\x00" + image[r].tobytes() for r in range(h))  # filter 0 per row
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
    if text:
        png += _chunk(b"tEXt", b"Title\x00" + text.encode("latin-1", "replace"))
    png += _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


def visualize_mask_triplet(
    input_img: np.ndarray,  # (H, W, C) or (H, W)
    gt_mask: Optional[np.ndarray],
    pred_mask: np.ndarray,  # logits (H, W) or (H, W, 1)
    out_path: str,
    title_prefix: str = "",
) -> str:
    """Write the panels of ``input_img``, ``gt_mask`` (if any) and
    ``pred_mask`` (logits) side by side to the PNG ``out_path``; returns
    ``out_path``."""
    panels = mask_panels(input_img, gt_mask, pred_mask, title_prefix)
    grays = [to_gray8(p) for p, _ in panels]
    height = max(g.shape[0] for g in grays)
    width = sum(g.shape[1] for g in grays) + GAP * (len(grays) - 1)
    canvas = np.zeros((height, width), np.uint8)
    col = 0
    for g in grays:
        canvas[:g.shape[0], col:col + g.shape[1]] = g
        col += g.shape[1] + GAP
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    write_png_gray8(out_path, canvas, " | ".join(t for _, t in panels))
    return out_path
