"""Pipelines: the single-modality data preparation (``prepare_single``)."""

from .prepare_single import (
    SingleModelData,
    build_single_model,
    export_processed_splits,
    load_processed_split,
    load_raw_tensors,
    prepare_single_data,
    save_processed_split,
)

__all__ = [
    "SingleModelData",
    "build_single_model",
    "export_processed_splits",
    "load_processed_split",
    "load_raw_tensors",
    "prepare_single_data",
    "save_processed_split",
]
