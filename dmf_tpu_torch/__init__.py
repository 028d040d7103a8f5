"""dmf_tpu_torch: the PyTorch/CUDA port of ``dmf_tpu`` for one NVIDIA H100.

The JAX package ``dmf_tpu`` stays the reference; this package mirrors its
module paths (``config``, ``ops/``, ``models/``, ``models/backbones/``,
``data/``, ``evals/``) so each counterpart is easy to find.  It imports
``torch`` and nothing of ``jax``, ``flax`` or ``dmf_tpu``: the configuration
tree is its own copy (``config.py``).

Ported so far: fusion inference (``normal``/``tta``/``mc``/``tta_mc``) with
two ResNet-50-backed encoders, the fusion head and the TTA x MC predictor;
and the hybrid CNN->Transformer encoders without a backbone (``hybrid-nb``).
The TPU kernels on those paths have hand-written Hopper counterparts:
``ops/epilogue.py``, ``ops/conv3x3.py`` and ``ops/flash_attention.py``
(CUDA C++).
"""

from .config import Config, default_parameters, resolve_backbone_config

__all__ = ["Config", "default_parameters", "resolve_backbone_config"]
