"""Fold-parallel training (``multifold``), counterpart of
``dmf_tpu/parallel`` without the device mesh (ROADMAP 1.13)."""

from .multifold import (index_fold_state, make_multifold_predictor, make_multifold_step,
                        stack_fold_batches, stack_fold_states)

__all__ = ["index_fold_state", "make_multifold_predictor", "make_multifold_step",
           "stack_fold_batches", "stack_fold_states"]
