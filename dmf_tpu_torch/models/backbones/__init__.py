from .importers import import_resnet50
from .registry import build_backbone, pretrained_state_dict
from .resnet import Bottleneck, ResNetFeatures

__all__ = ["Bottleneck", "ResNetFeatures", "build_backbone", "import_resnet50",
           "pretrained_state_dict"]
