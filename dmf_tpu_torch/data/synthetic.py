"""Synthetic dataset generator shaped like the Kaggle breast-MRI tensors.

A copy of ``dmf_tpu/data/synthetic.py`` (numpy only), so that the port
imports nothing of the JAX package; ``tests/test_torch_data.py`` holds the
two equal.

Used by tests, the debug suite and the benchmark (the real ``.pth`` tensors
from the reference's drive layout, parameters_generate.py:280-286, are not
distributed with either framework).  Shapes follow BASELINE.md: DWI 13
b-value channels, DCE 6 phases, binary tumor masks, 4 classes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_synthetic_arrays(
    n_train: int = 64,
    n_test: int = 16,
    image_size: int = 64,
    dwi_channels: int = 13,
    dce_channels: int = 6,
    num_classes: int = 4,
    mask_size: int = 64,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Return channels-last arrays mimicking the raw tensor store.

    Tumors are gaussian blobs whose intensity scales with the class so the
    pipeline has learnable signal end to end.
    """
    rng = np.random.RandomState(seed)

    def blobs(n, labels):
        ys, xs = np.mgrid[0:image_size, 0:image_size]
        imgs_dwi = rng.rand(n, image_size, image_size, dwi_channels).astype(np.float32)
        imgs_dce = rng.rand(n, image_size, image_size, dce_channels).astype(np.float32)
        masks = np.zeros((n, mask_size, mask_size, 1), np.float32)
        sy, sx = np.mgrid[0:mask_size, 0:mask_size]
        for i in range(n):
            cy, cx = rng.randint(image_size // 4, 3 * image_size // 4, size=2)
            r = image_size // 8 + labels[i] * 2
            blob = np.exp(-(((ys - cy) ** 2 + (xs - cx) ** 2) / (2.0 * r**2)))
            amp = 0.5 + 0.5 * labels[i] / max(1, num_classes - 1)
            imgs_dwi[i] += amp * blob[..., None] * np.linspace(
                1.0, 0.3, dwi_channels
            )
            imgs_dce[i] += amp * blob[..., None] * np.linspace(
                0.4, 1.0, dce_channels
            )
            mcy, mcx = cy * mask_size // image_size, cx * mask_size // image_size
            mr = max(2, r * mask_size // image_size)
            masks[i, ..., 0] = (
                ((sy - mcy) ** 2 + (sx - mcx) ** 2) <= mr**2
            ).astype(np.float32)
        return imgs_dwi, imgs_dce, masks

    train_labels = rng.randint(0, num_classes, size=n_train).astype(np.int64)
    test_labels = rng.randint(0, num_classes, size=n_test).astype(np.int64)
    dwi, dce, masks = blobs(n_train, train_labels)
    dwi_t, dce_t, _ = blobs(n_test, test_labels)

    return {
        "dwi": dwi,
        "dce": dce,
        "masks": masks,
        "labels": train_labels,
        "dwi_test": dwi_t,
        "dce_test": dce_t,
        "labels_test": test_labels,
    }
