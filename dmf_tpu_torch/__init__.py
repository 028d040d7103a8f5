"""dmf_tpu_torch: the PyTorch/CUDA port of ``dmf_tpu`` for one NVIDIA H100.

The JAX package ``dmf_tpu`` stays the reference; this package mirrors its
module paths (``ops/``, ``models/``, ``models/backbones/``, ``data/``,
``evals/``) so each counterpart is easy to find.  It imports ``torch`` and
never ``jax``: the only thing it takes from ``dmf_tpu`` is the stdlib-only
configuration tree (``dmf_tpu.config``).

Ported so far: fusion inference (``normal``/``tta``/``mc``/``tta_mc``) with
two ResNet-50-backed encoders, the fusion head and the TTA x MC predictor.
The two TPU kernels on that path have hand-written Hopper counterparts:
``ops/epilogue.py`` (Triton) and ``ops/conv3x3.py`` (CUDA C++).
"""

from dmf_tpu.config import Config, default_parameters, resolve_backbone_config

__all__ = ["Config", "default_parameters", "resolve_backbone_config"]
