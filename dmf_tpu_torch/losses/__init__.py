"""Losses (counterparts of ``dmf_tpu/losses``), on the port's NCHW maps.

The padded-tail validity weighting of ``dmf_tpu/losses/weighting.py`` is not
ported: the port runs a short tail batch at its own size, where that
weighting is the identity.
"""

from .aux import (charbonnier_loss, compute_attn_energy_loss, compute_feat_norm_loss,
                  compute_feature_consistency_loss, compute_recon_list_loss,
                  mimic_feat_loss, proj_cosine_loss, recon_image_loss,
                  single_model_recon_loss)
from .classification import (compute_class_weights, focal_loss, label_smoothing,
                             soft_focal_loss, soft_weighted_focal_loss,
                             weighted_focal_loss)
from .mask import dice_bce_loss, safe_mask_loss, soft_dice_loss
from .selectors import get_classification_loss_fn, get_mask_loss_fn, get_recon_loss_fn

__all__ = [
    "charbonnier_loss", "compute_attn_energy_loss", "compute_feat_norm_loss",
    "compute_feature_consistency_loss", "compute_recon_list_loss", "mimic_feat_loss",
    "proj_cosine_loss", "recon_image_loss", "single_model_recon_loss",
    "compute_class_weights", "focal_loss", "label_smoothing", "soft_focal_loss",
    "soft_weighted_focal_loss", "weighted_focal_loss", "dice_bce_loss",
    "safe_mask_loss", "soft_dice_loss", "get_classification_loss_fn",
    "get_mask_loss_fn", "get_recon_loss_fn",
]
