"""Load reference-layout state dicts into the port's modules, strictly.

``dmf_tpu.models.ref_ckpt.export_reference_encoder`` / ``export_reference_fusion``
turn JAX variables into the reference torch key layout, and reference
Lightning checkpoints use the same layout.  :func:`load_reference_state_dict`
loads either with full accounting: every parameter and buffer of the module
must be filled, and a key the module does not hold is dropped only if it
matches :data:`DROPPED_KEY_PATTERNS`; anything else is an error.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn

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
