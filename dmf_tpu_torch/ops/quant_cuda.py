"""CUDA kernels of the int8 serving path: the implicit-GEMM conv, the static
activation quantize and the dynamic one (abs-max, scale and quantize in one
launch).

They replace no Pallas kernel: the JAX package leaves its int8 conv
(``dmf_tpu/ops/quant.py:127-135``, ``lax.conv_general_dilated`` with an int32
result) and its quantize passes to XLA, and PyTorch has no int8 convolution
on CUDA.  The kernels are ``csrc/int8_conv.cu`` and ``csrc/int8_quantize.cu``
(their notes give the design).  This module checks the operands, picks the
launch (channel tile, pixel source), lays the weight out as the kernel's
tensor map reads it and allocates the outputs.  The libraries are built on
first use, never on import.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from .cuda_build import load_library

_CONV_SOURCES = ("int8_conv.cu",)
_QUANT_SOURCES = ("int8_quantize.cu",)
_FLOAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the conv's output modes: int32 accumulators, or dequantized fp32 / bf16
OUT_MODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def _conv_library() -> ctypes.CDLL:
    lib = load_library("int8_conv", _CONV_SOURCES)
    fn = lib.int8_conv_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.int8_conv_smem.argtypes = [ctypes.c_int]
    lib.int8_conv_smem.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _quant_library() -> ctypes.CDLL:
    lib = load_library("int8_quantize", _QUANT_SOURCES)
    q = lib.int8_quantize_launch
    q.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                                                ctypes.c_longlong, ctypes.c_void_p])
    q.restype = ctypes.c_int
    d = lib.int8_dynamic_quantize_launch
    d.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                        ctypes.c_int] + [ctypes.c_void_p] * 3)
    d.restype = ctypes.c_int
    lib.int8_dynamic_quantize_capacity.argtypes = [ctypes.c_int] * 2
    lib.int8_dynamic_quantize_capacity.restype = ctypes.c_int
    return lib


def conv_out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def conv_tile(o: int) -> int:
    """The tiles' channel width for ``o`` output channels: 64 up to 64, 128
    up to 128, else 256."""
    return 64 if o <= 64 else (128 if o <= 128 else 256)


def pixel_source(xq: torch.Tensor) -> int:
    """The kernel's pixel source (``csrc/int8_conv.cu``'s ``Src``) for the
    NHWC int8 map ``xq``: 0, 16-byte copies, where C % 16 == 0 and ``xq`` is
    16-byte aligned; else 1, element by element."""
    return 0 if xq.shape[1] % 16 == 0 and xq.data_ptr() % 16 == 0 else 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def weight_rows(wq: torch.Tensor) -> torch.Tensor:
    """The OHWI int8 weight as the (O, K) rows the kernel's tensor map reads:
    ``wq`` itself where K is a multiple of 16 and it is 16-byte aligned, else
    a copy with rows padded to a multiple of 16 bytes (the 7x7 stems' K = 686
    and 294), made once per weight (:func:`~.prepared.prepared`)."""
    from .prepared import prepared

    o, k = wq.shape[0], wq[0].numel()
    if k % 16 == 0 and wq.data_ptr() % 16 == 0:
        return wq.reshape(o, k)
    ld = -(-k // 16) * 16

    def make():
        rows = torch.zeros((o, ld), dtype=torch.int8, device=wq.device)
        rows[:, :k] = wq.reshape(o, k)
        return rows

    return prepared((wq,), ("int8_conv_rows",), make)


def launch_int8_conv(xq: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                     x_scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                     stride: Sequence[int], padding: Sequence[int], dilation: Sequence[int],
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the conv on a channels_last int8 (N, C, H, W) map and an OHWI
    int8 weight (O, kh, kw, C): int32 accumulators (``out_dtype`` int32,
    ``x_scale`` unused) or ``float(acc) * (x_scale * w_scale) + bias`` in fp32
    / bf16, a channels_last (N, O, Ho, Wo) map."""
    if xq.dim() != 4 or xq.dtype != torch.int8 or wq.dim() != 4 or wq.dtype != torch.int8:
        raise ValueError(f"int8_conv: need 4-D int8 x and weight, got {tuple(xq.shape)} "
                         f"{xq.dtype}, {tuple(wq.shape)} {wq.dtype}")
    if not xq.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("int8_conv: x must be channels_last (NHWC)")
    if not wq.is_contiguous():
        raise ValueError("int8_conv: the weight must be a contiguous OHWI tensor")
    if out_dtype not in OUT_MODES:
        raise ValueError(f"int8_conv: output dtype {out_dtype} not in {list(OUT_MODES)}")
    n, c, h, w = xq.shape
    o, kh, kw, wc = wq.shape
    if wc != c:
        raise ValueError(f"int8_conv: weight has {wc} input channels, x {c}")
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    ho, wo = conv_out_size(h, kh, sh, ph, dh), conv_out_size(w, kw, sw, pw, dw)
    if ho <= 0 or wo <= 0 or min(sh, sw, dh, dw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"int8_conv: no output for {tuple(xq.shape)} with kernel {kh}x{kw}, "
                         f"stride {tuple(stride)}, padding {tuple(padding)}, dilation "
                         f"{tuple(dilation)}")
    if max(n * h * w * c, n * ho * wo) >= 2 ** 31 or o * kh * kw * c >= 2 ** 62:
        raise ValueError("int8_conv: tensor too large (the kernel's offsets are 32-bit)")
    dequant = out_dtype != torch.int32
    if dequant:
        if x_scale is None or x_scale.numel() != 1 or x_scale.dtype != torch.float32:
            raise ValueError("int8_conv: a dequantized output needs an fp32 scalar x_scale")
        if w_scale.numel() != o or w_scale.dtype != torch.float32:
            raise ValueError(f"int8_conv: w_scale must be fp32 of {o} channels")
        if bias is not None and bias.numel() != o:
            raise ValueError(f"int8_conv: bias must have {o} channels")
    for t in (wq, w_scale, x_scale, bias):
        if t is not None and t.device != xq.device:
            raise ValueError("int8_conv: operands must be on x's device")
    rows = weight_rows(wq)
    out = torch.empty((n, o, ho, wo), dtype=out_dtype, device=xq.device,
                      memory_format=torch.channels_last)
    ws = w_scale.contiguous()
    xs = x_scale.reshape(1).contiguous() if dequant else None
    b = bias.float().contiguous() if (dequant and bias is not None) else None
    args = (pixel_source(xq), xq.data_ptr(), rows.data_ptr(), rows.stride(0), ws.data_ptr(),
            xs.data_ptr() if xs is not None else None, b.data_ptr() if b is not None else None,
            out.data_ptr(), OUT_MODES[out_dtype], conv_tile(o), n, h, w, c, o, kh, kw, ho, wo,
            sh, sw, ph, pw, dh, dw, _stream(xq))
    lib = _conv_library()
    if xq.device.index == torch.cuda.current_device():
        rc = lib.int8_conv_launch(*args)
    else:
        with torch.cuda.device(xq.device):
            rc = lib.int8_conv_launch(*args)
    if rc != 0:
        raise RuntimeError(f"int8_conv: kernel launch failed (CUDA error {rc})")
    return out


def _vec(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> int:
    """4 where the tensors line up for 4-element steps (16-byte fp32 or
    8-byte bf16 loads, 4-byte int8 stores), else 1."""
    ok = x.data_ptr() % (4 * x.element_size()) == 0
    if out is not None:
        ok = ok and out.data_ptr() % 4 == 0
    return 4 if ok else 1


def _check_float(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _FLOAT_DTYPES:
        raise ValueError(f"{name}: need fp32 or bf16, got {x.dtype}")
    if not (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{name}: x must be contiguous or channels_last")


def launch_quantize(x: torch.Tensor, scale: torch.Tensor, divide: bool) -> torch.Tensor:
    """Launch the quantize on a dense fp32 / bf16 tensor with an fp32 scalar
    ``scale`` on its device: ``x / scale`` (``divide``) or ``x * (1 / scale)``,
    rounded half to even and clamped to +-127; int8 in ``x``'s memory format."""
    _check_float("quantize", x)
    if scale.numel() != 1 or scale.dtype != torch.float32 or scale.device != x.device:
        raise ValueError("quantize: scale must be an fp32 scalar on x's device")
    out = torch.empty_like(x, dtype=torch.int8)
    s = scale.reshape(1).contiguous()
    lib = _quant_library()
    with torch.cuda.device(x.device):
        rc = lib.int8_quantize_launch(_FLOAT_DTYPES[x.dtype], _vec(x, out), x.data_ptr(),
                                      s.data_ptr(), int(divide), out.data_ptr(), x.numel(),
                                      _stream(x))
    if rc != 0:
        raise RuntimeError(f"quantize: kernel launch failed (CUDA error {rc})")
    return out


@functools.lru_cache(maxsize=None)
def _dynamic_capacity(device: int, dtype: int, vec: int) -> int:
    """The dynamic quantize's co-resident blocks on ``device``: its grid's
    cap and the size of its partials' workspace."""
    with torch.cuda.device(device):
        cap = _quant_library().int8_dynamic_quantize_capacity(dtype, vec)
    if cap <= 0:
        raise RuntimeError(f"dynamic_quantize: occupancy query failed (CUDA error {-cap})")
    return cap


def launch_dynamic_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dynamic quantize on a dense fp32 / bf16 tensor: ``(x_q,
    scale)`` with ``scale = max(max|x|, 1e-12) / 127`` an fp32 scalar (NaN
    where ``x`` holds one) and ``x_q = clip(rne(x / scale), -127, 127)``,
    int8 in ``x``'s memory format; one cooperative launch."""
    _check_float("dynamic_quantize", x)
    if x.numel() == 0:
        raise ValueError("dynamic_quantize: an empty tensor has no abs-max")
    out = torch.empty_like(x, dtype=torch.int8)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    dtype = _FLOAT_DTYPES[x.dtype]
    cap = _dynamic_capacity(x.device.index, dtype, vec)
    partial = torch.empty(cap, dtype=torch.int32, device=x.device)
    args = (dtype, vec, x.data_ptr(), x.numel(), partial.data_ptr(), cap, scale.data_ptr(),
            out.data_ptr(), _stream(x))
    launch = _quant_library().int8_dynamic_quantize_launch
    if x.device.index == torch.cuda.current_device():
        rc = launch(*args)
    else:
        with torch.cuda.device(x.device):
            rc = launch(*args)
    if rc != 0:
        raise RuntimeError(f"dynamic_quantize: kernel launch failed (CUDA error {rc})")
    return out, scale
