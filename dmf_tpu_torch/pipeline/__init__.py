"""Pipelines: the single-modality data preparation (``prepare_single``), the
single-modality run of one fold or of several in one call (``run_single``)
and the fusion run of one fold (``run_fusion``)."""

from .prepare_single import (
    SingleModelData,
    build_single_model,
    export_processed_splits,
    load_processed_split,
    load_raw_tensors,
    prepare_single_data,
    save_processed_split,
)
from .run_fusion import (build_fusion_state, fusion_model_test, prepare_fusion_data,
                         run_fusion_model, test_fusion_model)
from .run_single import run_single_model, run_single_model_multifold, test_single_model

__all__ = [
    "SingleModelData",
    "build_fusion_state",
    "build_single_model",
    "export_processed_splits",
    "fusion_model_test",
    "load_processed_split",
    "load_raw_tensors",
    "prepare_fusion_data",
    "prepare_single_data",
    "run_fusion_model",
    "run_single_model",
    "run_single_model_multifold",
    "save_processed_split",
    "test_fusion_model",
    "test_single_model",
]
