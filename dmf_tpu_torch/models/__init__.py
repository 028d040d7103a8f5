"""Model modules (NCHW) in the reference torch key layout."""

from .build import build_fusion_models, init_weights
from .encoder import Encoder
from .fusion import FusionModel
from .weights import (export_reference_encoder, export_reference_fusion,
                      load_lightning_ckpt, load_reference_state_dict, save_lightning_ckpt)

__all__ = ["Encoder", "FusionModel", "build_fusion_models", "export_reference_encoder",
           "export_reference_fusion", "init_weights", "load_lightning_ckpt",
           "load_reference_state_dict", "save_lightning_ckpt"]
