"""Batching of in-memory splits, counterpart of ``dmf_tpu/data/pipeline.py``.

Batches are numpy index gathers from host arrays, or on-device gathers from a
split staged once on the card (:func:`stage_dataset_to_device`).  The order is
the JAX package's: one ``np.random.RandomState`` permutation per epoch.  The
tail is one short batch (the reference's ``DataLoader(drop_last=False)``);
the JAX package's padded tails exist for its mesh, which the port has not.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

Batch = Dict[str, Union[np.ndarray, torch.Tensor]]


class ArrayDataset:
    """In-memory dataset of aligned arrays (imgs/masks/labels/...); ``None``
    arrays are left out."""

    def __init__(self, **arrays: Optional[np.ndarray]):
        self.arrays = {k: v for k, v in arrays.items() if v is not None}
        lens = {len(v) for v in self.arrays.values()}
        if len(lens) > 1:
            raise ValueError(f"misaligned arrays: { {k: len(v) for k, v in self.arrays.items()} }")
        self.length = lens.pop() if lens else 0
        self.device_arrays: Optional[Dict[str, torch.Tensor]] = None

    def __len__(self) -> int:
        return self.length


def batch_indices(n: int, batch_size: int, shuffle: bool,
                  rng: Optional[np.random.RandomState] = None) -> Iterator[np.ndarray]:
    """Index arrays per batch, shuffled by ``rng`` as the JAX package
    shuffles (pipeline.py:40-77); the tail is one short batch."""
    order = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(order)
    for start in range(0, n, batch_size):
        yield order[start:start + batch_size]


def stage_dataset_to_device(dataset: ArrayDataset, device) -> Dict[str, torch.Tensor]:
    """Copy the dataset into device memory once (kept on the dataset), so
    that a batch is a gather on the card rather than a host copy."""
    if dataset.device_arrays is None:
        dataset.device_arrays = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                                 for k, v in dataset.arrays.items()}
    return dataset.device_arrays


def device_data_auto(dataset: ArrayDataset, device, override: Optional[bool] = None,
                     limit_bytes: int = 4 << 30) -> bool:
    """Whether to stage ``dataset`` on ``device``: ``override`` wins;
    otherwise on a CUDA device when the arrays fit under ``limit_bytes`` (on
    the CPU, host memory is device memory)."""
    if override is not None:
        return bool(override)
    if torch.device(device).type != "cuda":
        return False
    return sum(int(v.nbytes) for v in dataset.arrays.values()) <= limit_bytes


def iterate_batches(dataset: ArrayDataset, batch_size: int, shuffle: bool = False,
                    rng: Optional[np.random.RandomState] = None,
                    device=None) -> Iterator[Batch]:
    """Batches of every array of ``dataset``: numpy arrays, or tensors
    gathered on ``device`` from the staged copy when one is given."""
    staged = stage_dataset_to_device(dataset, device) if device is not None else None
    for idx in batch_indices(len(dataset), batch_size, shuffle, rng):
        if staged is None:
            yield {k: v[idx] for k, v in dataset.arrays.items()}
        else:
            i = torch.as_tensor(idx, device=device)
            yield {k: v.index_select(0, i) for k, v in staged.items()}
