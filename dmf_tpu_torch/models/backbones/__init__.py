from .resnet import Bottleneck, ResNetFeatures, build_backbone

__all__ = ["Bottleneck", "ResNetFeatures", "build_backbone"]
