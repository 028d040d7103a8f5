"""Backbone registry, counterpart of ``dmf_tpu/models/backbones/registry.py``
(:39-110; the reference's ``build_medical_backbone``,
foundation_model.py:490-573).

No config mutation (derived fields come from ``resolve_backbone_config``)
and no network downloads: pretrained weights are local files supplied as
``pretrained_path`` (the reference pulled them from the HF Hub at build
time, foundation_model.py:72-97).  The ResNet-50 names build a
:class:`~.resnet.ResNetFeatures`, the ViT-B/16 and DINO ones a
:class:`~.vit.ViTFeatures` (registry.py:86-97).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from ...config import ModelConfig, resolve_backbone_config
from .importers import import_resnet50, import_vit_base, map_rasool_to_timm_keys
from .resnet import ResNetFeatures
from .vit import ViTFeatures, ViTSize, vit_base_patch16

RESNET_NAMES = ("resnet50", "resnet50d", "radimagenet", "radimagenet_resnet50")
VIT_NAMES = ("vit_base_patch16_224", "dino_vitbase16_pretrain")


def _load_state_dict(path: str):
    """A torch checkpoint's state dict, unwrapped from a ``state_dict``,
    ``model_state_dict``, ``model`` or ``encoder`` entry.  Full unpickling,
    as the JAX loader does: torch's ``weights_only`` default refuses some
    checkpoints that package reads."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("state_dict", "model_state_dict", "model", "encoder"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    return ckpt


def _check_name(name: str) -> None:
    if name in RESNET_NAMES or name in VIT_NAMES:
        return
    if name in ("uni2-h", "uni2h"):
        # declared but never dispatched in the reference either
        # (foundation_model.py:437-483: "not implemented")
        raise NotImplementedError(
            "UNI2-h (pathology ViT-H) is declared but not implemented, "
            "matching the reference"
        )
    raise ValueError(f"unknown backbone_str {name!r}")


def pretrained_state_dict(mc: ModelConfig, in_channels: int,
                          pretrained_path: str) -> Dict[str, torch.Tensor]:
    """The state dict of the backbone named by ``mc.backbone_str`` imported
    from the local checkpoint ``pretrained_path`` (CPU tensors): timm
    ResNet-50 / resnet50d, a RadImageNet (Lab-Rasool) one for the
    ``radimagenet*`` names, or a timm ViT-B/16 / DINO one whose position
    embedding is resized to ``mc.input_size``.  The first conv is adapted
    to ``in_channels`` as ``mc.use_advanced_adapt`` says (imagenet resnets
    honor use_input_adapt, foundation_model.py:40; radimagenet always
    adapts, foundation_model.py:277-281)."""
    name = mc.backbone_str.lower()
    _check_name(name)
    mc = resolve_backbone_config(mc)
    sd = _load_state_dict(pretrained_path)
    if name in VIT_NAMES:
        return import_vit_base(sd, in_channels, img_size=mc.input_size,
                               use_advanced_adapt=mc.use_advanced_adapt)
    if name.startswith("radimagenet"):
        sd = map_rasool_to_timm_keys(sd)
    return import_resnet50(sd, in_channels, use_advanced_adapt=mc.use_advanced_adapt,
                           deep_stem=name == "resnet50d")


def build_backbone(mc: ModelConfig, in_channels: int,
                   pretrained_path: Optional[str] = None,
                   layers: Union[Sequence[int], ViTSize] = (3, 4, 6, 3),
                   **kw) -> Union[ResNetFeatures, ViTFeatures]:
    """The backbone named by ``mc.backbone_str``, with ``**kw`` (``device``,
    ``dtype``) passed to its layers.  Without ``pretrained_path`` it holds
    torch's default initialisation (``build_single_model`` redraws it);
    with one, the checkpoint's weights (:func:`pretrained_state_dict`).
    ``layers`` lets tests build a shallow network: a ResNet's blocks per
    stage, e.g. (1, 1, 1, 1), or a narrow :class:`~.vit.ViTSize` for a ViT
    name (any other value builds ViT-B/16's 768 x 12 blocks x 12 heads)."""
    name = mc.backbone_str.lower()
    _check_name(name)
    if name in VIT_NAMES:
        module = vit_base_patch16(in_channels, mc.input_size,
                                  layers if isinstance(layers, ViTSize) else ViTSize(), **kw)
    else:
        deep = name == "resnet50d"
        module = ResNetFeatures(in_channels, layers, deep_stem=deep, avg_down=deep, **kw)
    if pretrained_path:
        module.load_state_dict(pretrained_state_dict(mc, in_channels, pretrained_path))
    return module
