"""dmf_tpu_torch: the PyTorch/CUDA port of ``dmf_tpu`` for one NVIDIA H100.

The JAX package ``dmf_tpu`` stays the reference; this package mirrors its
module paths (``config``, ``ops/``, ``models/``, ``models/backbones/``,
``data/``, ``losses/``, ``train/``, ``evals/``, ``pipeline/``, ``utils/``) so
each counterpart is easy to find.  It imports ``torch`` and nothing of
``jax``, ``flax`` or ``dmf_tpu``: the configuration tree is its own copy
(``config.py``).

Ported so far: fusion inference (``normal``/``tta``/``mc``/``tta_mc``) with
two ResNet-50-backed encoders, the fusion head and the TTA x MC predictor;
the hybrid CNN->Transformer encoders without a backbone (``hybrid-nb``); the
single-modality data preparation; single-modality and fusion training
(``pipeline.run_single.run_single_model``, ``pipeline.run_fusion.run_fusion_model``)
with ResNet-50 backbones from local checkpoints; the command line
(``python -m dmf_tpu_torch run|debug-suite|bench|export-ckpt|export-serving``);
the benchmark entry point, ``bench.py``'s counterpart (``bench.py``);
the weights-free ``torch.export`` serving artifact (``serving.py``); and the
mask triptych, profiling and introspection utilities (``utils/``).  Every TPU
kernel has a hand-written Hopper counterpart in ``csrc/`` (CUDA C++), behind
a wrapper in ``ops/``; those of the served paths are ``torch.library``
operators too (``ops/library.py``).
"""

from .config import Config, default_parameters, from_reference_dict, resolve_backbone_config

__all__ = ["Config", "default_parameters", "from_reference_dict", "resolve_backbone_config"]
