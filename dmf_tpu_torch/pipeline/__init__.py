"""Pipelines: the single-modality data preparation (``prepare_single``) and
the single-modality run of one fold (``run_single``)."""

from .prepare_single import (
    SingleModelData,
    build_single_model,
    export_processed_splits,
    load_processed_split,
    load_raw_tensors,
    prepare_single_data,
    save_processed_split,
)
from .run_single import run_single_model, test_single_model

__all__ = [
    "SingleModelData",
    "build_single_model",
    "export_processed_splits",
    "load_processed_split",
    "load_raw_tensors",
    "prepare_single_data",
    "run_single_model",
    "save_processed_split",
    "test_single_model",
]
