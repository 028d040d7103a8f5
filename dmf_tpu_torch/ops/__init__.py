"""Ops: resize, attention and the two hand-written kernels with their plain versions."""
