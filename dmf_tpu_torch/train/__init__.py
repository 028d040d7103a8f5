"""Training: grouped AdamW with per-group hyperparameters and the unfreeze
controllers (``optim``), the schedulers (``schedule``), the train state
(``state``), the train and eval steps of the single-modality encoder
(``single``) and of the fusion network (``fusion``), the epoch loops
(``loop``) and the fold-parallel loop (``multifold_loop``).  Counterpart of
``dmf_tpu/train``."""

from .fusion import (FusionNetwork, compute_fusion_losses, fusion_sample_pair_mimic,
                     make_fusion_eval_step, make_fusion_train_step)
from .loop import FitResult, fit_fusion, fit_single, init_single_state
from .multifold_loop import fit_single_multifold
from .optim import (FusionOptController, GroupSpec, GroupedHyperParams,
                    SingleModelOptController, adamw_init, adamw_update,
                    build_fusion_group_spec, build_group_spec, describe_groups)
from .single import compute_single_losses, make_single_eval_step, make_single_train_step
from .state import TrainState

__all__ = [
    "FitResult", "FusionNetwork", "FusionOptController", "GroupSpec", "GroupedHyperParams",
    "SingleModelOptController", "TrainState", "adamw_init", "adamw_update",
    "build_fusion_group_spec", "build_group_spec", "compute_fusion_losses",
    "compute_single_losses", "describe_groups", "fit_fusion", "fit_single", "fit_single_multifold",
    "fusion_sample_pair_mimic", "init_single_state", "make_fusion_eval_step", "make_fusion_train_step", "make_single_eval_step",
    "make_single_train_step",
]
