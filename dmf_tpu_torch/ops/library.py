"""The hand-written kernels of the served paths as ``torch.library`` operators.

The kernels are reached through ``ctypes`` with raw ``data_ptr()``s, which
neither ``torch.export`` nor any fake-tensor trace can pass through.  Each is
registered here as an operator in the ``dmf`` namespace, so that a traced
program holds one node per kernel call and runs the kernel when the program
runs, in a process that holds none of the model code:

==================  =================================================  =======
operator            CUDA implementation                                kernel
==================  =================================================  =======
``se_epilogue``     ``epilogue_cuda.launch_se_epilogue``                1
``keep_mask``       ``epilogue_cuda.keep_mask`` (kernel 1's keep test)  1
``conv3x3_bn_gelu`` ``conv3x3.launch_conv3x3_bn_gelu``                  2
``se_scale``        ``se_cuda.launch_se_scale``                         6
``flash_forward``   ``flash_attention.launch_flash_forward``            3
==================  =================================================  =======

Each operator has three implementations:

* CUDA: the ``ctypes`` launch with its checks, on the current stream; it
  raises on what the kernel does not take and never falls back.  Each
  launch adds one to its wrapper's count (``se_epilogue.launches`` etc.), so
  the counts are those of the launches a program makes, not of the Python
  calls a trace makes.  Weights are prepared (cast, transposed, folded with
  BatchNorm) inside, on real tensors, once per parameter set
  (``ops/prepared.py``).
* CPU: the plain version, its outputs in the strides of the fake
  implementation.
* fake: the outputs' shapes, dtypes and strides (``channels_last`` maps as
  the kernels write them), which is what a trace sees.

The operators have no autograd formula: the wrappers call them only where
autograd would not record the call (on the CPU they take the plain version
directly otherwise, on the card they raise); ``flash_forward`` sits inside
``flash_attention._FlashAttention``, whose backward launches the backward
kernels.  Importing this module registers the operators: a serving process
imports it (with ``torch``) and nothing else of the package.  It imports no
model code.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import conv3x3, dropout, epilogue, epilogue_cuda, flash_attention, se, se_cuda

NAMESPACE = "dmf"
OPERATORS = ("se_epilogue", "keep_mask", "conv3x3_bn_gelu", "se_scale", "flash_forward")

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("se_epilogue(Tensor x, Tensor identity, Tensor w1, Tensor b1, Tensor w2, "
            "Tensor b2, float drop_rate, Tensor? seed, int base) -> Tensor")
_LIB.define("keep_mask(Tensor x, float drop_rate, Tensor seed, int base) -> Tensor")
_LIB.define("conv3x3_bn_gelu(Tensor x, Tensor weight, Tensor? conv_bias, Tensor bn_weight, "
            "Tensor bn_bias, Tensor bn_mean, Tensor bn_var, float eps, int tile_n) -> Tensor")
_LIB.define("se_scale(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) "
            "-> (Tensor, Tensor)")
_LIB.define("flash_forward(Tensor q, Tensor k, Tensor v, float scale) -> (Tensor, Tensor)")


def launch_counts() -> dict:
    """The kernel launches counted so far, by operator."""
    return {"se_epilogue": epilogue.se_epilogue.launches,
            "keep_mask": dropout.keep_mask.launches,
            "conv3x3_bn_gelu": conv3x3.conv3x3_bn_gelu.launches,
            "se_scale": se.se_scale.launches,
            "flash_forward": flash_attention.flash_attention.launches}


def reset_launch_counts() -> None:
    """Set every count of :func:`launch_counts` to 0."""
    for fn in (epilogue.se_epilogue, dropout.keep_mask, conv3x3.conv3x3_bn_gelu,
               se.se_scale, flash_attention.flash_attention):
        fn.launches = 0


def _map_format(x: torch.Tensor) -> torch.memory_format:
    """The memory format of a map operator's output for input ``x``:
    channels_last on the card (the kernels write NHWC) or where ``x`` is
    channels_last and not NCHW-contiguous, NCHW-contiguous otherwise."""
    if x.device.type == "cuda" or not x.is_contiguous():
        return torch.channels_last
    return torch.contiguous_format


def _map_like(x: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.empty(x.shape if shape is None else shape, dtype=x.dtype, device=x.device,
                       memory_format=_map_format(x))


# ----------------------------------------------------------- se_epilogue
def _se_epilogue_cuda(x, identity, w1, b1, w2, b2, drop_rate: float,
                      seed: Optional[torch.Tensor], base: int):
    out = epilogue_cuda.launch_se_epilogue(x, identity, w1, b1, w2, b2, drop_rate, seed, base)
    epilogue.se_epilogue.launches += 1
    return out


def _se_epilogue_cpu(x, identity, w1, b1, w2, b2, drop_rate: float,
                     seed: Optional[torch.Tensor], base: int):
    keep = None
    if drop_rate > 0.0:
        if seed is None:
            raise ValueError("se_epilogue: drop_rate > 0 needs a seed")
        keep = dropout.keep_mask_plain(x.shape, drop_rate, seed, base)
    out = epilogue.se_epilogue_ref(x, identity, w1, b1, w2, b2, drop_rate, keep=keep)
    return _map_like(x).copy_(out)


def _se_epilogue_fake(x, identity, w1, b1, w2, b2, drop_rate, seed, base):
    return _map_like(x)


# ------------------------------------------------------------- keep_mask
def _keep_mask_cuda(x, drop_rate: float, seed: torch.Tensor, base: int):
    mask = epilogue_cuda.keep_mask(x, drop_rate, seed, base)
    dropout.keep_mask.launches += 1
    return mask


def _keep_mask_cpu(x, drop_rate: float, seed: torch.Tensor, base: int):
    return dropout.keep_mask_plain(x.shape, drop_rate, seed, base)


def _keep_mask_fake(x, drop_rate, seed, base):
    return epilogue_cuda.seed_order_empty(x, torch.bool)


# ------------------------------------------------------- conv3x3_bn_gelu
def _conv_cuda(x, weight, conv_bias, bn_weight, bn_bias, bn_mean, bn_var, eps: float,
               tile_n: int):
    out = conv3x3.launch_conv3x3_bn_gelu(x, weight, conv_bias, bn_weight, bn_bias, bn_mean,
                                         bn_var, eps, tile_n)
    conv3x3.conv3x3_bn_gelu.launches += 1
    return out


def _conv_shape(x, weight):
    return (x.shape[0], weight.shape[0], x.shape[2], x.shape[3])


def _conv_cpu(x, weight, conv_bias, bn_weight, bn_bias, bn_mean, bn_var, eps: float,
              tile_n: int):
    out = conv3x3.conv3x3_bn_gelu_ref(x, weight, conv_bias, bn_weight, bn_bias, bn_mean,
                                      bn_var, eps)
    return _map_like(x, _conv_shape(x, weight)).copy_(out)


def _conv_fake(x, weight, conv_bias, bn_weight, bn_bias, bn_mean, bn_var, eps, tile_n):
    return _map_like(x, _conv_shape(x, weight))


# -------------------------------------------------------------- se_scale
def _se_scale_cuda(x, w1, b1, w2, b2):
    out = se_cuda.launch_se_scale(x, w1, b1, w2, b2)
    se.se_scale.launches += 1
    return out


def _se_scale_cpu(x, w1, b1, w2, b2):
    out, s = se.se_scale_ref(x, w1, b1, w2, b2)
    return _map_like(x).copy_(out), s.contiguous()


def _se_scale_fake(x, w1, b1, w2, b2):
    return _map_like(x), x.new_empty((x.shape[0], x.shape[1], 1, 1))


# --------------------------------------------------------- flash_forward
def _flash_cuda(q, k, v, scale: float):
    out = flash_attention.launch_flash_forward(q, k, v, scale)
    flash_attention.flash_attention.launches += 1
    return out


def _flash_cpu(q, k, v, scale: float):
    out, lse = flash_attention.flash_attention_ref(q, k, v, scale)
    return out.contiguous(), lse.contiguous()


def _flash_fake(q, k, v, scale):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(q.shape[:-1], dtype=torch.float32))


for _name, _cuda, _cpu, _fake in (
        ("se_epilogue", _se_epilogue_cuda, _se_epilogue_cpu, _se_epilogue_fake),
        ("keep_mask", _keep_mask_cuda, _keep_mask_cpu, _keep_mask_fake),
        ("conv3x3_bn_gelu", _conv_cuda, _conv_cpu, _conv_fake),
        ("se_scale", _se_scale_cuda, _se_scale_cpu, _se_scale_fake),
        ("flash_forward", _flash_cuda, _flash_cpu, _flash_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)
