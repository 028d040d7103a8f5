"""Ops: resize, attention and the hand-written kernels with their plain versions.

Importing the package registers the kernels' ``torch.library`` operators
(``library.py``), which the kernel wrappers call.
"""

from . import library  # noqa: F401
