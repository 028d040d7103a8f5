"""Data on the device: splits, synthetic data, preprocessing, augmentation,
per-modality processing."""

from .augment import affine_nearest, augment_batch, eval_resize, random_affine_flip
from .modality import ModalityProcessor
from .preprocess import (
    NyulStandardizer,
    append_adc,
    compute_adc_map,
    dce_global_max_normalize,
    dwi_normalize,
    nyul_transform,
    nyul_transform_fast,
    prep_dwi_adc_maps,
    preprocess_adc,
    preprocess_fusion_inputs,
    zero_to_one_adc,
)
from .splits import (
    data_segmentation,
    data_segmentation_mask,
    stratified_fold_indices,
    train_val_indices,
)
from .synthetic import make_synthetic_arrays

__all__ = [
    "affine_nearest",
    "augment_batch",
    "eval_resize",
    "random_affine_flip",
    "ModalityProcessor",
    "NyulStandardizer",
    "append_adc",
    "compute_adc_map",
    "dce_global_max_normalize",
    "dwi_normalize",
    "nyul_transform",
    "nyul_transform_fast",
    "prep_dwi_adc_maps",
    "preprocess_adc",
    "preprocess_fusion_inputs",
    "zero_to_one_adc",
    "data_segmentation",
    "data_segmentation_mask",
    "stratified_fold_indices",
    "train_val_indices",
    "make_synthetic_arrays",
]
