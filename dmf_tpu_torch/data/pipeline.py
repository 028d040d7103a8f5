"""Batching of in-memory splits, counterpart of ``dmf_tpu/data/pipeline.py``.

Batches are numpy index gathers from host arrays, on-device gathers from a
split staged once on the card (:func:`stage_dataset_to_device`), or batches
that the native library's threaded loader gathers ahead of the consumer
(``native=True``, ``utils/native.py``).  The order of the first two is the
JAX package's: one ``np.random.RandomState`` permutation per epoch; the
native loader shuffles in C++ from a seed that the same ``rng`` draws, as the
JAX package's native route does.  The tail is one short batch (the
reference's ``DataLoader(drop_last=False)``).  Under a data mesh each rank
takes its rows of every global batch (``rows=``, ``parallel/mesh.py``): the
same permutation on every rank, so no data moves between ranks, and the
tail split unevenly (a share may be empty) where the JAX package pads it
with validity weights (``dmf_tpu/train/loop.py:206-245``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.native import NativeBatchLoader

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
        # the native loader and the batch size and shuffle it was built for
        self.native_loader: Optional[Tuple[Tuple[int, bool], NativeBatchLoader]] = None

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


def native_batches(dataset: ArrayDataset, batch_size: int, shuffle: bool,
                   rng: Optional[np.random.RandomState]) -> Iterator[Batch]:
    """Host batches from the native loader (``dmf_tpu/data/pipeline.py:214-277``
    without the padded tail).  The loader is built once per dataset, batch
    size and shuffle, and restarted each epoch by ``new_epoch`` rather than
    rebuilt (its slots and threads are reused); the seed is drawn from
    ``rng`` as the JAX package draws it.  Each batch is copied out of the
    loader's slot, in the dataset's dtypes."""
    seed = int((rng or np.random).randint(0, 2 ** 31 - 1)) if shuffle else 0
    key = (batch_size, bool(shuffle))
    if dataset.native_loader is not None and dataset.native_loader[0] == key:
        loader = dataset.native_loader[1]
        loader.new_epoch(seed)
    else:
        if dataset.native_loader is not None:
            dataset.native_loader[1].close()
        floats = {k: v for k, v in dataset.arrays.items() if k != "labels"}
        loader = NativeBatchLoader(floats, dataset.arrays.get("labels"), batch_size,
                                   shuffle=shuffle, seed=seed)
        dataset.native_loader = (key, loader)
    for batch in loader:
        yield {k: np.array(v, dtype=dataset.arrays[k].dtype) for k, v in batch.items()}


def iterate_batches(dataset: ArrayDataset, batch_size: int, shuffle: bool = False,
                    rng: Optional[np.random.RandomState] = None,
                    device=None, native: bool = False,
                    rows: Optional[Callable[[int], slice]] = None) -> Iterator[Batch]:
    """Batches of every array of ``dataset``: numpy arrays, or tensors
    gathered on ``device`` from the staged copy when one is given.  Without
    a staged copy, ``native=True`` takes the native loader
    (:func:`native_batches`); the staged copy wins, as in the JAX package
    (pipeline.py:163-191).  ``rows`` (a data mesh's ``Mesh.rows``) maps a
    global batch's size to this rank's slice of it: each batch is then this
    rank's rows (possibly none) of the global one."""
    if device is None and native:
        for batch in native_batches(dataset, batch_size, shuffle, rng):
            if rows is not None:
                sl = rows(len(batch["labels"]))
                batch = {k: v[sl] for k, v in batch.items()}
            yield batch
        return
    staged = stage_dataset_to_device(dataset, device) if device is not None else None
    for idx in batch_indices(len(dataset), batch_size, shuffle, rng):
        if rows is not None:
            idx = idx[rows(len(idx))]
        if staged is None:
            yield {k: v[idx] for k, v in dataset.arrays.items()}
        else:
            i = torch.as_tensor(idx, device=device)
            yield {k: v.index_select(0, i) for k, v in staged.items()}
