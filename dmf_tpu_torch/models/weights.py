"""Reference-layout state dicts in and out of the port's modules.

``dmf_tpu.models.ref_ckpt.export_reference_encoder`` / ``export_reference_fusion``
turn JAX variables into the reference torch key layout, and reference
Lightning checkpoints use the same layout.  :func:`load_reference_state_dict`
loads either with full accounting: every parameter and buffer of the module
must be filled, and a key the module does not hold is dropped only if it
matches :data:`DROPPED_KEY_PATTERNS`; anything else is an error.  A ViT/DINO
backbone (the state dict has ``backbone.patch_embed.proj.weight``) goes
through ``import_vit_base``, which resizes the checkpoint's position
embedding to the module's grid (ref_ckpt.py:552-566); it has no BatchNorm
statistics.

The export direction (:func:`export_reference_encoder`,
:func:`export_reference_fusion`, :func:`save_lightning_ckpt`) mirrors
``dmf_tpu/models/ref_ckpt.py`` (:55-84, :262-346, :419-500, :577-590,
:640-671): the port's modules carry the reference's names, so an export is
the module's state dict plus the slots that load drops, the backbone's
second path and the reference-only slots at the reference's defaults.  The
fillers are drawn in the JAX exporter's order from the same
``np.random.RandomState(seed)``, so the export of a module is bit-equal to
the JAX package's export of the same weights.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn

from .backbones.importers import import_vit_base
from .backbones.vit import ViTFeatures

# Keys of the reference layout that the port does not hold, each with why.
DROPPED_KEY_PATTERNS = (
    # the reference serializes the encoder's shared backbone a second time
    # under the adapter (model_module.py:539-546); the port holds it once
    re.compile(r"^backbone_adapter\.backbone\."),
    # MaskHeadResize registers down chains for four input sizes
    # (model_module.py:152-187); the port builds only the one its geometry uses
    re.compile(r"(^|\.)mask_head\.down_\d+_to_\d+\."),
    # feature-align convs are registered for every mask stage
    # (model_module.py:604-605); the port builds only the configured one
    re.compile(r"^(f1_to_f2|f2_to_f3)\."),
)


def canonical_key(key: str) -> str:
    """Strip Lightning's ``model.`` prefix and torch.compile's ``_orig_mod.``."""
    if key.startswith("model."):
        key = key[len("model."):]
    return key.replace("_orig_mod.", "")


def _tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.array(v))


def load_reference_state_dict(module: nn.Module,
                              state_dict: Mapping[str, Any]) -> Dict[str, List[str]]:
    """Fill ``module`` from a reference-layout state dict (numpy or torch values).

    Returns ``{"loaded": [...], "dropped": [...]}`` (canonical key names).
    Raises ``KeyError`` on a missing or unaccounted key and ``ValueError`` on
    a shape mismatch or a key given twice.
    """
    own = module.state_dict()
    src: Dict[str, Any] = {}
    for key, value in state_dict.items():
        ck = canonical_key(key)
        if ck in src:
            raise ValueError(f"state dict gives {ck!r} twice")
        src[ck] = value
    vit = getattr(module, "backbone", None)
    if isinstance(vit, ViTFeatures) and "backbone.patch_embed.proj.weight" in src:
        src = _import_vit_backbone(vit, src)
    new: Dict[str, torch.Tensor] = {}
    dropped, unexpected = [], []
    for key, value in src.items():
        if key in own:
            t = _tensor(value)
            if tuple(t.shape) != tuple(own[key].shape):
                raise ValueError(f"shape mismatch at {key!r}: state dict "
                                 f"{tuple(t.shape)} vs module {tuple(own[key].shape)}")
            new[key] = t
        elif any(p.search(key) for p in DROPPED_KEY_PATTERNS):
            dropped.append(key)
        else:
            unexpected.append(key)
    missing = sorted(set(own) - set(new))
    if missing or unexpected:
        raise KeyError(f"state dict does not fit {type(module).__name__}: "
                       f"missing {missing[:8]} ({len(missing)}), "
                       f"unexpected {sorted(unexpected)[:8]} ({len(unexpected)})")
    module.load_state_dict(new, strict=True)
    return {"loaded": sorted(new), "dropped": sorted(dropped)}


def _import_vit_backbone(vit: ViTFeatures, src: Dict[str, Any]) -> Dict[str, Any]:
    """``src`` with its ``backbone.`` tensors imported into ``vit``'s
    geometry: the patch embedding adapted to its channels and the position
    embedding resized to its grid.  Keys the import does not take stay as
    they were, for the caller's accounting."""
    sub = {k[len("backbone."):]: v for k, v in src.items() if k.startswith("backbone.")}
    proj = vit.patch_embed.proj
    patch = proj.kernel_size[0]
    grid = math.isqrt(vit.pos_embed.shape[1] - 1)
    imported = import_vit_base(sub, proj.in_channels, img_size=grid * patch,
                               patch_size=patch, depth=len(vit.blocks))
    return {**src, **{"backbone." + k: v for k, v in imported.items()}}


# ---------------------------------------------------------------------------
# Export: the port's modules -> reference-layout state dicts
# ---------------------------------------------------------------------------

# MaskHeadResize's down chains by their conv count (ref_ckpt.py:135-136)
_MASK_CHAINS = {1: "down_64_to_32", 2: "down_128_to_32",
                3: "down_256_to_32", 4: "down_512_to_32"}


def load_lightning_ckpt(path: str) -> Dict[str, Any]:
    """Load a ``.ckpt``/``.pth`` file and return the bare model state dict,
    Lightning's ``model.`` prefix dropped (prepare_single_model.py:213-216);
    full unpickling, as the JAX loader does."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {(k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items()}


def save_lightning_ckpt(path: str, state_dict: Mapping[str, Any],
                        prefix: str = "model.") -> None:
    """Write a Lightning-layout checkpoint the reference's resume path loads
    directly (``{'state_dict': {'model.'+k: tensor}}``,
    prepare_single_model.py:208-218)."""
    torch.save({"state_dict": {prefix + k: _tensor(v).clone()
                               for k, v in state_dict.items()}}, path)


class _Fillers:
    """The reference-only slots at torch's default initialisation, drawn
    from ``rng`` (ref_ckpt.py:327-344)."""

    def __init__(self, out: Dict[str, np.ndarray], rng: np.random.RandomState):
        self.out, self.rng = out, rng

    def put(self, key: str, v) -> None:
        self.out[key] = np.asarray(v, dtype=np.float32)

    def conv(self, key: str, out_ch: int, in_ch: int, k: int, bias: bool = True) -> None:
        """torch nn.Conv2d default init: U(+-1/sqrt(fan_in)), weight and bias alike."""
        bound = 1.0 / np.sqrt(in_ch * k * k)
        self.put(key + ".weight", self.rng.uniform(-bound, bound, (out_ch, in_ch, k, k)))
        if bias:
            self.put(key + ".bias", self.rng.uniform(-bound, bound, (out_ch,)))

    def bn(self, key: str, ch: int) -> None:
        """torch nn.BatchNorm2d defaults: identity affine, fresh statistics."""
        self.put(key + ".weight", np.ones(ch))
        self.put(key + ".bias", np.zeros(ch))
        self.put(key + ".running_mean", np.zeros(ch))
        self.put(key + ".running_var", np.ones(ch))
        self.out[key + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def mask_chains(self, head: nn.Module, key: str) -> None:
        """The reference registers all four down chains whatever the geometry
        (model_module.py:152-187); fill the ones the port does not build."""
        chain = getattr(head, head.chain_name) if head.chain_name is not None else ()
        n_mid = sum(isinstance(m, nn.Conv2d) for m in chain)
        mid_ch = head.pre.out_channels
        for cnt, name in _MASK_CHAINS.items():
            if cnt == n_mid:
                continue
            for j in range(cnt):
                self.conv(f"{key}.{name}.{2 * j}", mid_ch, mid_ch, 3)


def _state(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's state dict as host numpy arrays (floats in fp32)."""
    out = {}
    for k, v in module.state_dict().items():
        v = v.detach().cpu()
        out[k] = v.numpy() if v.dtype == torch.int64 else v.float().numpy()
    return out


def export_reference_encoder(model: nn.Module, seed: int = 0) -> Dict[str, np.ndarray]:
    """An :class:`~.encoder.Encoder` -> a reference ``ModelMaskHeadBackbone``
    state dict (numpy values) that the genuine module accepts with
    ``load_state_dict(strict=True)``, bit-equal to
    ``dmf_tpu.models.ref_ckpt.export_reference_encoder`` on the same weights.

    The backbone, ResNet-50 or ViT (whose state dict is timm's layout, the
    position embedding at the module's own grid), goes under both paths the
    reference serializes
    (``backbone._orig_mod.`` and ``backbone_adapter.backbone._orig_mod.``,
    model_module.py:539-546); the unused mask-head chains and the feature
    aligns the port does not build (registered unconditionally,
    model_module.py:604-605) get torch-default fills from
    ``np.random.RandomState(seed)``.  Wrap with :func:`save_lightning_ckpt`.
    """
    out: Dict[str, np.ndarray] = {}
    for k, v in _state(model).items():
        if k.startswith("backbone."):
            for prefix in ("backbone._orig_mod.", "backbone_adapter.backbone._orig_mod."):
                out[prefix + k[len("backbone."):]] = v
        else:
            out[k] = v
    fill = _Fillers(out, np.random.RandomState(seed))
    if getattr(model, "mask_stage", None) is not None:
        fill.mask_chains(model.mask_head, "mask_head")
    c1, c2, c3 = model.config.channels
    for name, ci, co in (("f1_to_f2", c1, c2), ("f2_to_f3", c2, c3)):
        if hasattr(model, name) or ci == co:
            continue
        fill.conv(name + ".proj.0", co, ci, 1, bias=False)
        fill.bn(name + ".proj.1", co)
    return out


def export_reference_fusion(model: nn.Module, seed: int = 0) -> Dict[str, np.ndarray]:
    """A :class:`~.fusion.FusionModel` -> a reference ``FusionModel`` state
    dict accepted by ``load_state_dict(strict=True)`` on the genuine module,
    bit-equal to ``dmf_tpu.models.ref_ckpt.export_reference_fusion`` on the
    same weights (see :func:`export_reference_encoder`)."""
    out = _state(model)
    _Fillers(out, np.random.RandomState(seed)).mask_chains(model.mask_head, "mask_head")
    return out
