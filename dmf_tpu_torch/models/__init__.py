"""Model modules (NCHW) in the reference torch key layout."""

from .build import build_fusion_models, init_weights
from .encoder import Encoder
from .fusion import FusionModel
from .weights import load_reference_state_dict

__all__ = ["Encoder", "FusionModel", "build_fusion_models", "init_weights",
           "load_reference_state_dict"]
