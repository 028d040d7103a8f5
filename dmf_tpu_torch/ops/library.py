"""The hand-written kernels of the served paths as ``torch.library`` operators.

The kernels are reached through ``ctypes`` with raw ``data_ptr()``s, which
neither ``torch.export`` nor any fake-tensor trace can pass through.  Each is
registered here as an operator in the ``dmf`` namespace, so that a traced
program holds one node per kernel call and runs the kernel when the program
runs, in a process that holds none of the model code:

==============================  ==================================================  =============
operator                        CUDA implementation                                 kernel
==============================  ==================================================  =============
``se_epilogue``                 ``epilogue_cuda.launch_se_epilogue``                1
``keep_mask``                   ``epilogue_cuda.keep_mask`` (kernel 1's keep test)  1
``conv3x3_bn_gelu``             ``conv3x3.launch_conv3x3_bn_gelu``                  2
``se_scale``                    ``se_cuda.launch_se_scale``                         6
``flash_forward``               ``flash_attention.launch_flash_forward``            3
``flash_forward_dropout``       ``flash_attention.launch_flash_forward_dropout``    3 (dropout)
``flash_backward_dq_dropout``   ``flash_attention.launch_flash_bwd_dq_dropout``     4 (dropout)
``flash_backward_dkv_dropout``  ``flash_attention.launch_flash_bwd_dkv_dropout``    5 (dropout)
``int8_conv``                   ``quant_cuda.launch_int8_conv``                     int8 conv
``quantize``                    ``quant_cuda.launch_quantize``                      int8 quantize
``dynamic_quantize``            ``quant_cuda.launch_dynamic_quantize``              int8 quantize
==============================  ==================================================  =============

``flash_forward_dropout`` has two instances, chosen by the shape
(``flash_attention.dropout_group``, once a call): the head-shared one (a
pre-pass makes one Philox call for the heads whose bits it holds, counted
in ``flash_attention_dropout.launches_shared``) and the per-element one
(``launches_each``); ``launches`` counts both.  It returns the undropped
softmax's lse beside the output, which the backward's two dropout
operators take (``flash_attention._FlashAttentionDropout``; counted in
``flash_attention_dropout.launches_dq`` and ``launches_dkv``).

The last three are the int8 serving path's kernels (``ops/quant.py``),
which replace no Pallas kernel: XLA lowers JAX's int8 conv and quantize.
``flash_forward_dropout`` (the forward kernels' dropout variants, the MC
attention of the seed route and the training route at the flash shapes)
replaces none either: XLA lowers JAX's materialized-weights route; its
backward operators are the dropout instances of kernels 4 and 5.

The products among them carry FLOP formulas for
``torch.utils.flop_counter.FlopCounterMode``, registered on the operator
packets by :func:`register_flop_formulas` (once, on the first count: on a
card's machine ``torch.utils.flop_counter`` imports ``triton``, which the
operators themselves never need), so a count over a call that reaches the
kernels sees them:
``conv3x3_bn_gelu`` 2 N H W Cout 9 Cin, ``flash_forward`` 4 BH Nq Nk D (and
``flash_forward_dropout`` 4 B H Nq Nk D, the backward's dropout operators
the products their kernels run, S and dP recomputed in each: 6 and 8 B H
Nq Nk D),
``int8_conv`` twice its multiply-adds.  The others do elementwise work,
which the counter leaves out everywhere.

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
kernels, and ``flash_forward_dropout`` inside
``flash_attention._FlashAttentionDropout``, whose backward runs the two
backward dropout operators.  Importing this module registers the operators: a serving process
imports it (with ``torch``) and nothing else of the package.  It imports no
model code.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import (conv3x3, dropout, epilogue, epilogue_cuda, flash_attention, quant, quant_cuda,
               se, se_cuda)

NAMESPACE = "dmf"
OPERATORS = ("se_epilogue", "keep_mask", "conv3x3_bn_gelu", "se_scale", "flash_forward",
             "flash_forward_dropout", "flash_backward_dq_dropout", "flash_backward_dkv_dropout",
             "int8_conv", "quantize", "dynamic_quantize")

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("se_epilogue(Tensor x, Tensor identity, Tensor w1, Tensor b1, Tensor w2, "
            "Tensor b2, float drop_rate, Tensor? seed, int base, int first_pass=0, "
            "int passes=1) -> Tensor")
_LIB.define("keep_mask(Tensor x, float drop_rate, Tensor seed, int base, int first_pass=0, "
            "int passes=1) -> Tensor")
# (the dispatcher leaves out an argument equal to its schema default, so the
# implementations below repeat the defaults)
_LIB.define("conv3x3_bn_gelu(Tensor x, Tensor weight, Tensor? conv_bias, Tensor bn_weight, "
            "Tensor bn_bias, Tensor bn_mean, Tensor bn_var, float eps, int tile_n) -> Tensor")
_LIB.define("se_scale(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) "
            "-> (Tensor, Tensor)")
_LIB.define("flash_forward(Tensor q, Tensor k, Tensor v, float scale) -> (Tensor, Tensor)")
_LIB.define("flash_forward_dropout(Tensor q, Tensor k, Tensor v, float scale, float p, "
            "Tensor seed, int base, int first_pass, int passes, int heads, int h0) "
            "-> (Tensor, Tensor)")
_DROPOUT_BWD_ARGS = ("(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, Tensor delta, "
                     "float scale, float p, Tensor seed, int base, int first_pass, int passes, "
                     "int heads, int h0)")
_LIB.define(f"flash_backward_dq_dropout{_DROPOUT_BWD_ARGS} -> Tensor")
_LIB.define(f"flash_backward_dkv_dropout{_DROPOUT_BWD_ARGS} -> (Tensor, Tensor)")
_LIB.define("int8_conv(Tensor x, Tensor weight, Tensor w_scale, Tensor? x_scale, Tensor? bias, "
            "int[] stride, int[] padding, int[] dilation, ScalarType out_dtype) -> Tensor")
_LIB.define("quantize(Tensor x, Tensor scale, bool divide) -> Tensor")
_LIB.define("dynamic_quantize(Tensor x) -> (Tensor, Tensor)")


def launch_counts() -> dict:
    """The kernel launches counted so far, by operator (the dropout
    forward's by instance: ``flash_attention_dropout.launches_shared`` and
    ``launches_each``)."""
    return {"se_epilogue": epilogue.se_epilogue.launches,
            "keep_mask": dropout.keep_mask.launches,
            "conv3x3_bn_gelu": conv3x3.conv3x3_bn_gelu.launches,
            "se_scale": se.se_scale.launches,
            "flash_forward": flash_attention.flash_attention.launches,
            "flash_forward_dropout": flash_attention.flash_attention_dropout.launches,
            "flash_backward_dq_dropout": flash_attention.flash_attention_dropout.launches_dq,
            "flash_backward_dkv_dropout": flash_attention.flash_attention_dropout.launches_dkv,
            "int8_conv": quant.int8_conv.launches,
            "quantize": quant.quantize.launches,
            "dynamic_quantize": quant.dynamic_quantize.launches}


def reset_launch_counts() -> None:
    """Set every count of :func:`launch_counts` to 0."""
    for fn in (epilogue.se_epilogue, dropout.keep_mask, conv3x3.conv3x3_bn_gelu,
               se.se_scale, flash_attention.flash_attention,
               flash_attention.flash_attention_dropout, quant.int8_conv, quant.quantize,
               quant.dynamic_quantize):
        fn.launches = 0
    for counter in ("launches_shared", "launches_each", "launches_dq", "launches_dkv"):
        setattr(flash_attention.flash_attention_dropout, counter, 0)


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
                      seed: Optional[torch.Tensor], base: int, first_pass: int = 0,
                      passes: int = 1):
    out = epilogue_cuda.launch_se_epilogue(x, identity, w1, b1, w2, b2, drop_rate, seed, base,
                                           first_pass, passes)
    epilogue.se_epilogue.launches += 1
    return out


def _se_epilogue_cpu(x, identity, w1, b1, w2, b2, drop_rate: float,
                     seed: Optional[torch.Tensor], base: int, first_pass: int = 0,
                     passes: int = 1):
    keep = None
    if drop_rate > 0.0:
        if seed is None:
            raise ValueError("se_epilogue: drop_rate > 0 needs a seed")
        keep = dropout.keep_mask_plain(x.shape, drop_rate, seed, base, first_pass, passes)
    out = epilogue.se_epilogue_ref(x, identity, w1, b1, w2, b2, drop_rate, keep=keep)
    return _map_like(x).copy_(out)


def _se_epilogue_fake(x, identity, w1, b1, w2, b2, drop_rate, seed, base, first_pass=0,
                      passes=1):
    return _map_like(x)


# ------------------------------------------------------------- keep_mask
def _keep_mask_cuda(x, drop_rate: float, seed: torch.Tensor, base: int, first_pass: int = 0,
                    passes: int = 1):
    mask = epilogue_cuda.keep_mask(x, drop_rate, seed, base, first_pass, passes)
    dropout.keep_mask.launches += 1
    return mask


def _keep_mask_cpu(x, drop_rate: float, seed: torch.Tensor, base: int, first_pass: int = 0,
                   passes: int = 1):
    return dropout.keep_mask_plain(x.shape, drop_rate, seed, base, first_pass, passes)


def _keep_mask_fake(x, drop_rate, seed, base, first_pass=0, passes=1):
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


# ------------------------------------------------- flash_forward_dropout
def _flash_dropout_cuda(q, k, v, scale: float, p: float, seed, base: int, first_pass: int,
                        passes: int, heads: int, h0: int):
    group = flash_attention.dropout_group(heads, h0, q.shape[1], base)
    out = flash_attention.launch_flash_forward_dropout(q, k, v, scale, p, seed, base,
                                                       first_pass, passes, heads, h0, group)
    fn = flash_attention.flash_attention_dropout
    fn.launches += 1
    if group > 1:
        fn.launches_shared += 1
    else:
        fn.launches_each += 1
    return out


def _flash_dropout_cpu(q, k, v, scale: float, p: float, seed, base: int, first_pass: int,
                       passes: int, heads: int, h0: int):
    flash_attention._check_dropout(q, p, seed, first_pass, passes, heads, h0)
    out = flash_attention.flash_attention_dropout_ref(q, k, v, scale, p, seed, base, first_pass,
                                                      passes, heads, h0)
    return out.contiguous(), flash_attention.attention_lse(q, k, scale).contiguous()


def _flash_dropout_fake(q, k, v, scale, p, seed, base, first_pass, passes, heads, h0):
    return _flash_fake(q, k, v, scale)


# ------------------------------- flash_backward_dq_dropout, _dkv_dropout
def _flash_bwd_dropout_cuda(launch, counter):
    def impl(q, k, v, dout, lse, delta, scale: float, p: float, seed, base: int,
             first_pass: int, passes: int, heads: int, h0: int):
        group = flash_attention.dropout_group(heads, h0, q.shape[1], base)
        out = launch(q, k, v, dout, lse, delta, scale, p, seed, base, first_pass, passes,
                     heads, h0, group)
        fn = flash_attention.flash_attention_dropout
        setattr(fn, counter, getattr(fn, counter) + 1)
        return out
    return impl


def _flash_bwd_dropout_cpu(ref):
    def impl(q, k, v, dout, lse, delta, scale: float, p: float, seed, base: int,
             first_pass: int, passes: int, heads: int, h0: int):
        flash_attention._check_dropout(q, p, seed, first_pass, passes, heads, h0)
        out = ref(q, k, v, dout, lse, delta, scale, p, seed, base, first_pass, passes, heads, h0)
        return tuple(t.contiguous() for t in out) if isinstance(out, tuple) else out.contiguous()
    return impl


def _flash_bwd_dq_dropout_fake(q, k, v, dout, lse, delta, scale, p, seed, base, first_pass,
                               passes, heads, h0):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _flash_bwd_dkv_dropout_fake(q, k, v, dout, lse, delta, scale, p, seed, base, first_pass,
                                passes, heads, h0):
    return (torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


# ------------------------------------------------------------- int8_conv
def _int8_conv_cuda(x, weight, w_scale, x_scale, bias, stride, padding, dilation, out_dtype):
    out = quant_cuda.launch_int8_conv(x, weight, w_scale, x_scale, bias, stride, padding,
                                      dilation, out_dtype)
    quant.int8_conv.launches += 1
    return out


def _int8_conv_shape(x, weight, stride, padding, dilation):
    _, kh, kw, _ = weight.shape
    return (x.shape[0], weight.shape[0],
            quant_cuda.conv_out_size(x.shape[2], kh, stride[0], padding[0], dilation[0]),
            quant_cuda.conv_out_size(x.shape[3], kw, stride[1], padding[1], dilation[1]))


def _int8_conv_out(x, weight, stride, padding, dilation, out_dtype):
    return torch.empty(_int8_conv_shape(x, weight, stride, padding, dilation), dtype=out_dtype,
                       device=x.device, memory_format=_map_format(x))


def _int8_conv_cpu(x, weight, w_scale, x_scale, bias, stride, padding, dilation, out_dtype):
    out = quant.int8_conv_ref(x, weight, w_scale, x_scale, bias, stride, padding, dilation,
                              out_dtype)
    return _int8_conv_out(x, weight, stride, padding, dilation, out_dtype).copy_(out)


def _int8_conv_fake(x, weight, w_scale, x_scale, bias, stride, padding, dilation, out_dtype):
    return _int8_conv_out(x, weight, stride, padding, dilation, out_dtype)


# -------------------------------------------------------------- quantize
def _quantize_cuda(x, scale, divide: bool):
    out = quant_cuda.launch_quantize(x, scale, divide)
    quant.quantize.launches += 1
    return out


def _quantize_cpu(x, scale, divide: bool):
    return torch.empty_like(x, dtype=torch.int8).copy_(quant.quantize_ref(x, scale, divide))


def _quantize_fake(x, scale, divide):
    return torch.empty_like(x, dtype=torch.int8)


# ------------------------------------------------------ dynamic_quantize
def _dynamic_quantize_cuda(x):
    out = quant_cuda.launch_dynamic_quantize(x)
    quant.dynamic_quantize.launches += 1
    return out


def _dynamic_quantize_cpu(x):
    xq, scale = quant.dynamic_quantize_ref(x)
    return torch.empty_like(x, dtype=torch.int8).copy_(xq), scale


def _dynamic_quantize_fake(x):
    return torch.empty_like(x, dtype=torch.int8), x.new_empty((), dtype=torch.float32)


for _name, _cuda, _cpu, _fake in (
        ("se_epilogue", _se_epilogue_cuda, _se_epilogue_cpu, _se_epilogue_fake),
        ("keep_mask", _keep_mask_cuda, _keep_mask_cpu, _keep_mask_fake),
        ("conv3x3_bn_gelu", _conv_cuda, _conv_cpu, _conv_fake),
        ("se_scale", _se_scale_cuda, _se_scale_cpu, _se_scale_fake),
        ("flash_forward", _flash_cuda, _flash_cpu, _flash_fake),
        ("flash_forward_dropout", _flash_dropout_cuda, _flash_dropout_cpu, _flash_dropout_fake),
        ("flash_backward_dq_dropout",
         _flash_bwd_dropout_cuda(flash_attention.launch_flash_bwd_dq_dropout, "launches_dq"),
         _flash_bwd_dropout_cpu(flash_attention.flash_bwd_dq_dropout_ref),
         _flash_bwd_dq_dropout_fake),
        ("flash_backward_dkv_dropout",
         _flash_bwd_dropout_cuda(flash_attention.launch_flash_bwd_dkv_dropout, "launches_dkv"),
         _flash_bwd_dropout_cpu(flash_attention.flash_bwd_dkv_dropout_ref),
         _flash_bwd_dkv_dropout_fake),
        ("int8_conv", _int8_conv_cuda, _int8_conv_cpu, _int8_conv_fake),
        ("quantize", _quantize_cuda, _quantize_cpu, _quantize_fake),
        ("dynamic_quantize", _dynamic_quantize_cuda, _dynamic_quantize_cpu,
         _dynamic_quantize_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)


# ------------------------------------------------------------ FLOP formulas
def _conv_flop(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    n, cout, h, w = out_shape
    return 2 * n * h * w * cout * w_shape[1] * w_shape[2] * w_shape[3]


def _flash_flop(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    bh, nq, d = q_shape
    return 4 * bh * nq * k_shape[1] * d


def _flash_dropout_flop(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    b, h, nq, d = q_shape
    return 4 * b * h * nq * k_shape[2] * d


def _flash_bwd_dropout_flop(mult: int):
    def formula(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
        b, h, nq, d = q_shape
        return mult * b * h * nq * k_shape[2] * d
    return formula


def _int8_conv_flop(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    _, kh, kw, cin = w_shape  # OHWI
    return 2 * out_shape[0] * out_shape[1] * out_shape[2] * out_shape[3] * kh * kw * cin


_FLOP_FORMULAS = (("conv3x3_bn_gelu", _conv_flop), ("flash_forward", _flash_flop),
                  ("flash_forward_dropout", _flash_dropout_flop),
                  ("flash_backward_dq_dropout", _flash_bwd_dropout_flop(6)),
                  ("flash_backward_dkv_dropout", _flash_bwd_dropout_flop(8)),
                  ("int8_conv", _int8_conv_flop))
_flop_formulas_registered = False


def register_flop_formulas() -> None:
    """Register the products' FLOP formulas with ``FlopCounterMode``, once
    (imported here and not at module import: ``torch.utils.flop_counter``
    imports ``triton`` where it is installed)."""
    global _flop_formulas_registered
    if _flop_formulas_registered:
        return
    from torch.utils.flop_counter import register_flop_formula

    for name, formula in _FLOP_FORMULAS:
        register_flop_formula(getattr(torch.ops.dmf, name))(formula)
    _flop_formulas_registered = True
