"""Model introspection: capture intermediate activations.

Counterpart of ``dmf_tpu/utils/introspect.py``, which gives Flax's
``capture_intermediates`` the ergonomics of the reference's ``GetWeights``
forward-hook feature grabber (train.py:926-942).  In PyTorch the grabber is
the hook itself: one forward hook on every submodule.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def capture_features(module: torch.nn.Module, *args, path_filter: str = "",
                     **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """Run ``module(*args, **kwargs)`` capturing every submodule's output.

    Returns ``(outputs, features)`` where ``features`` maps '/'-joined
    submodule paths (the qualified names with '/' for '.'; ``module`` itself
    is ``""``) to their output, the first element of a tuple output,
    keeping only paths containing ``path_filter``.  A submodule called more
    than once keeps its first call's output, as the JAX function does.  The
    hooks are removed however the call ends.
    """
    feats: Dict[str, Any] = {}
    handles = []

    def hook(name):
        def grab(_module, _inputs, output):
            feats.setdefault(name, output[0] if isinstance(output, tuple) else output)
        return grab

    try:
        for qualname, sub in module.named_modules():
            name = qualname.replace(".", "/")
            if path_filter in name:
                handles.append(sub.register_forward_hook(hook(name)))
        outputs = module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return outputs, feats
