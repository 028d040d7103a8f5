"""Loss selectors (selector_helpers.py:14-114), counterparts of
``dmf_tpu/losses/selectors.py``."""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..config import Config
from .classification import compute_class_weights, soft_focal_loss, soft_weighted_focal_loss
from .mask import dice_bce_loss, soft_dice_loss

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def get_classification_loss_fn(cfg: Config, train_labels, method: str) -> LossFn:
    """``fl``: soft focal loss; ``wfl``: soft weighted focal loss with the
    training labels' inverse class frequencies (selector_helpers.py:14-46)."""
    clp = cfg.model_config(method).classification_loss
    code = clp.loss_code
    gamma = clp.gamma if clp.gamma is not None else 2.0
    if code == "fl":
        return functools.partial(soft_focal_loss, gamma=gamma)
    if code == "wfl":
        return functools.partial(soft_weighted_focal_loss, gamma=gamma,
                                 class_weights=compute_class_weights(train_labels,
                                                                     cfg.class_num))
    raise ValueError(
        f"Invalid classification_loss_code {code!r}. Valid options: ['fl', 'wfl']")


def get_recon_loss_fn(cfg: Config, method: str) -> Optional[LossFn]:
    """The reference's MSE selector (selector_helpers.py:51-64); None when
    recon is off.  The train step uses the Charbonnier image loss of
    ``aux.py`` (train.py:1041-1048), as the JAX step does."""
    mc = cfg.model_config(method)
    if not mc.recon_enabled:
        return None
    if mc.reconstruction_loss_code == "mse":
        return lambda pred, target: ((pred - target) ** 2).mean()
    raise ValueError(f"Invalid {method} reconstruction_loss_code "
                     f"{mc.reconstruction_loss_code!r}. Only 'mse' supported.")


def get_mask_loss_fn(cfg: Config, method: str) -> Optional[LossFn]:
    """selector_helpers.py:95-114."""
    mp = cfg.model_config(method).mask
    if not mp.enabled:
        return None
    if mp.mask_loss_type == "dice":
        return soft_dice_loss
    if mp.mask_loss_type == "dice_bce":
        # the reference passes fixed 1.0/1.0 weights (selector_helpers.py:106)
        return functools.partial(dice_bce_loss, bce_weight=1.0, dice_weight=1.0)
    raise ValueError(f"Invalid mask loss: {mp.mask_loss_type}")
