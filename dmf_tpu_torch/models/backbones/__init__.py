from .importers import import_resnet50, import_vit_base
from .registry import build_backbone, pretrained_state_dict
from .resnet import Bottleneck, ResNetFeatures
from .vit import ViTFeatures, ViTSize

__all__ = ["Bottleneck", "ResNetFeatures", "ViTFeatures", "ViTSize", "build_backbone",
           "import_resnet50", "import_vit_base", "pretrained_state_dict"]
