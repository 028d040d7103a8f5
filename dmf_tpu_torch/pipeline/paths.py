"""Output path layout of a run (run_training.py:352-376), the port's copy of
``dmf_tpu/pipeline/paths.py``."""

from __future__ import annotations

import os
from typing import Dict


def prepare_output_paths(method: str, fold: int, base_dir: str = "results") -> Dict[str, str]:
    root = os.path.join(base_dir, method, f"fold_{fold}")
    paths = {
        "root": root,
        "checkpoints": os.path.join(root, "checkpoints"),
        "logs": os.path.join(root, "logs"),
        "metrics": os.path.join(root, "metrics.json"),
    }
    for key in ("root", "checkpoints", "logs"):
        os.makedirs(paths[key], exist_ok=True)
    return paths
