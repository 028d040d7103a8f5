"""Metric history as JSONL, the final ``metrics.json`` and the first batch's
input statistics.

The port's copy of ``dmf_tpu/utils/logging.py``'s ``MetricLogger``,
``save_metrics_json`` and ``input_stats`` (held equal by
``tests/test_torch_train.py`` and ``tests/test_torch_fusion_train.py``), the
counterparts of the reference's HistoryCallback and metrics.json
(run_training.py:338-349, 392-407).  The JSONL history is the record; the
JAX package's optional TensorBoard mirror of it is not copied.  Over a data
mesh (``mesh=``) only rank 0 writes, and every rank waits at a barrier.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class MetricLogger:
    def __init__(self, log_dir: str, name: str = "metrics", mesh=None):
        self.log_dir = os.path.abspath(log_dir)
        self.mesh = mesh
        if mesh is None or mesh.writer:
            os.makedirs(self.log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(self.log_dir, f"{name}.jsonl")
        self.history: List[Dict[str, Any]] = []

    def log_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        record = {"epoch": epoch, "time": time.time()}
        # vector metrics (the per-group lrs, the reference's LearningRateMonitor
        # pg{i} scalars) expand to indexed keys
        for k, v in metrics.items():
            if isinstance(v, (list, tuple)):
                record.update({f"{k}_{i}": float(x) for i, x in enumerate(v)})
            else:
                record[k] = float(v)
        self.history.append(record)
        if self.mesh is None or self.mesh.writer:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.mesh is not None:
            self.mesh.barrier()


def save_metrics_json(path: str, train_metrics: Dict[str, Any],
                      test_metrics: Dict[str, Any],
                      parameters: Optional[Dict[str, Any]] = None, mesh=None) -> None:
    """Final per-run metrics file (run_training.py:392-407), written by
    global rank 0 alone over a ``mesh``."""
    if mesh is not None and not mesh.writer:
        mesh.barrier()
        return

    def clean(obj):
        if isinstance(obj, dict):
            return {k: clean(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [clean(v) for v in obj]
        if hasattr(obj, "tolist"):
            return obj.tolist()
        return obj

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"train_metrics": clean(train_metrics),
                   "test_metrics": clean(test_metrics),
                   "parameters": clean(parameters) if parameters else None},
                  f, indent=2)
    if mesh is not None:
        mesh.barrier()


def input_stats(inputs, masks=None) -> str:
    """The input-normalisation debug line (train.py:1074-1079), printed for a
    first batch under ``debug_training``: min, max, mean and std of
    ``inputs`` (and of ``masks``), read on the host."""

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    x = host(inputs)
    s = (f"[DEBUG] Input Stats: Min={x.min():.4f}, Max={x.max():.4f}, "
         f"Mean={x.mean():.4f}, Std={x.std():.4f}")
    if masks is not None:
        m = host(masks)
        s += (f"\n[DEBUG] Mask Stats: Min={m.min():.4f}, Max={m.max():.4f}, "
              f"Mean={m.mean():.4f}")
    return s
