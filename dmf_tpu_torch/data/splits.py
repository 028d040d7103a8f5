"""Class-stratified K-fold splitting with exact reference parity.

A copy of ``dmf_tpu/data/splits.py`` (numpy only), so that the port imports
nothing of the JAX package; ``tests/test_torch_data.py`` holds the two equal.
Reproduces the sample ordering of ``data_segmentation`` /
``data_segmentation_mask`` (dataset.py:142-235) bit-for-bit: seeded
``np.random.seed(42)`` followed by one ``np.random.permutation`` per class in
class order, folds assembled class-by-class, train = concat of non-val folds
in fold order.  AUC parity with the reference depends on identical splits
(SURVEY.md §7 'Randomness parity').
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def stratified_fold_indices(
    labels: np.ndarray, segnum: int, classnum: int, seed: int = 42
) -> List[np.ndarray]:
    """Return per-fold index arrays, matching dataset.py:142-163 ordering."""
    labels = np.asarray(labels)
    rng_state = np.random.RandomState(seed)
    # the reference calls the *global* np.random.seed(42); RandomState(42)
    # yields the identical MT19937 stream.
    shuffled_per_class = []
    for c in range(classnum):
        sub = np.nonzero(labels == c)[0]
        perm = rng_state.permutation(sub.shape[0])
        shuffled_per_class.append(sub[perm])

    folds: List[np.ndarray] = []
    for i in range(segnum):
        parts = []
        for c in range(classnum):
            idx = shuffled_per_class[c]
            foldnum = int(len(idx) // segnum)
            if i != segnum - 1:
                parts.append(idx[i * foldnum : (i + 1) * foldnum])
            else:
                parts.append(idx[(segnum - 1) * foldnum :])
        folds.append(np.concatenate(parts) if parts else np.zeros(0, np.int64))
    return folds


def train_val_indices(
    labels: np.ndarray, segnum: int, classnum: int, fold: int, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, val_idx) for ``fold``; train folds concatenated in order
    (dataset.py:165-173)."""
    folds = stratified_fold_indices(labels, segnum, classnum, seed)
    val_idx = folds[fold]
    train_idx = np.concatenate([f for i, f in enumerate(folds) if i != fold])
    return train_idx, val_idx


def data_segmentation(
    imgs: np.ndarray,
    labels: np.ndarray,
    segnum: int,
    classnum: int,
    fold: int,
    seed: int = 42,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """API-parity equivalent of dataset.py:142-174.

    Returns ``[train_imgs, val_imgs], [train_labels, val_labels]``.  Note the
    reference materializes train labels as float32 via ``torch.zeros(0)``
    concat; we keep the original dtype (labels are cast to int at use sites
    in both frameworks).
    """
    tr, va = train_val_indices(labels, segnum, classnum, fold, seed)
    return [imgs[tr], imgs[va]], [labels[tr], labels[va]]


def data_segmentation_mask(
    imgs: np.ndarray,
    masks: np.ndarray,
    labels: np.ndarray,
    segnum: int,
    classnum: int,
    fold: int,
    seed: int = 42,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """API-parity equivalent of dataset.py:178-235 (images + masks)."""
    tr, va = train_val_indices(labels, segnum, classnum, fold, seed)
    return (
        [imgs[tr], imgs[va]],
        [masks[tr], masks[va]],
        [labels[tr], labels[va]],
    )
