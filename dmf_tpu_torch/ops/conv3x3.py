"""Fused 3x3 conv + inference BatchNorm + GELU: wrapper and plain version.

Counterpart of ``dmf_tpu/ops/conv3x3_pallas.py::conv3x3_bn_gelu`` (the
Pallas kernels ``_conv_kernel`` / ``_conv_kernel_t``).  The wrapper runs the
plain version below for tensors on the CPU and the CUDA kernel in
``csrc/conv3x3_bn_gelu.cu`` for tensors on a CUDA device; there is no
fallback from one to the other.

Numerics follow the TPU kernel (conv3x3_pallas.py:284-289): weights are cast
to the map dtype, the conv accumulates in fp32, then ``gelu(acc * s + t)``
with ``s = gamma / sqrt(var + eps)`` and ``t = (bias - mean) * s + beta`` in
fp32, rounded once to the map dtype.

Layout: maps are (N, C, H, W) tensors.  The kernel takes them in
``channels_last`` memory format (physically NHWC, so each tap's K slice is
contiguous) and raises on any other; it returns ``channels_last`` output.
Its weights are a K-major (Cout, 9*Cin) matrix and the folded ``(s, t)``,
prepared once per parameter set (:func:`conv_weights`).

fp32 runs on the tensor cores as 3xTF32: each operand is split into ``hi =
rna_tf32(a)`` and ``lo = rna_tf32(a - hi)`` and the kernel sums ``hi*hi +
hi*lo + lo*hi`` in fp32, an error of order 2^-22 per product where one TF32
product (``hi*hi``) would leave 2^-11.  The weights are split once per
parameter set, the pixels inside the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .prepared import check_no_grad, prepared

_SOURCES = ("conv3x3_bn_gelu.cu",)


def fold_bn(conv_bias, bn_weight, bn_bias, bn_mean, bn_var, eps: float):
    """Inference BN folded with the conv bias: fp32 ``(s, t)`` per channel."""
    s = bn_weight.float() / torch.sqrt(bn_var.float() + eps)
    bias = (conv_bias.float() if conv_bias is not None
            else torch.zeros_like(s))
    t = (bias - bn_mean.float()) * s + bn_bias.float()
    return s, t


def conv3x3_bn_gelu_ref(x: torch.Tensor, weight: torch.Tensor, conv_bias,
                        bn_weight: torch.Tensor, bn_bias: torch.Tensor,
                        bn_mean: torch.Tensor, bn_var: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version; ``weight`` is (Cout, Cin, 3, 3)."""
    s, t = fold_bn(conv_bias, bn_weight, bn_bias, bn_mean, bn_var, eps)
    y = F.conv2d(x.float(), weight.to(x.dtype).float(), padding=1)
    y = y * s[:, None, None] + t[:, None, None]
    return F.gelu(y).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("conv3x3_bn_gelu", _SOURCES)
    fn = lib.conv3x3_bn_gelu_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.conv3x3_bn_gelu_wgmma_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.conv3x3_bn_gelu_wgmma_smem.restype = ctypes.c_int
    return lib


def rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero (``cvt.rna.tf32.f32``), low 13 bits zero; non-finite values pass."""
    bits = (t.float().view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isfinite(t), bits.view(torch.float32), t.float())


def conv_weights(weight: torch.Tensor, conv_bias, bn_weight: torch.Tensor,
                 bn_bias: torch.Tensor, bn_mean: torch.Tensor, bn_var: torch.Tensor,
                 eps: float, dt: torch.dtype):
    """The kernel's operands from the parameters: the K-major weight matrix
    (Cout, 9*Cin) (column ``k = tap*Cin + c``, taps in (ky, kx) row-major
    order) and the fp32 ``(s, t)`` of :func:`fold_bn`, as ``(w, w_lo, s, t)``:
    in bf16 ``w`` in ``dt`` and ``w_lo`` None, in fp32 the matrix's 3xTF32
    halves ``w = rna_tf32(m)``, ``w_lo = rna_tf32(m - w)``.  Made once per
    parameter set and reused until a parameter or statistic changes."""
    params = (weight, conv_bias, bn_weight, bn_bias, bn_mean, bn_var)
    tf32x3 = dt == torch.float32

    def make():
        cout, cin = weight.shape[:2]
        wmat = weight.detach().permute(0, 2, 3, 1).reshape(cout, 9 * cin).to(dt, copy=True)
        s, t = fold_bn(*(None if p is None else p.detach() for p in params[1:]), eps)
        w_lo = None
        if tf32x3:
            hi = rna_tf32(wmat)
            wmat, w_lo = hi, rna_tf32(wmat - hi)
        return wmat, w_lo, s.contiguous(), t.contiguous()

    return prepared(params, ("conv3x3", "tf32x3" if tf32x3 else dt, eps), make)


def tile_n(cout: int, dtype: torch.dtype) -> int:
    """Output channels per block: in bf16 256 where Cout fills it, else 128
    (chosen by chip_smoke.py phase 3b's measurement); in fp32 128, the one
    tile at which the 3xTF32 kernel's step accumulator fits in registers
    beside its fp32 sum."""
    return 256 if dtype == torch.bfloat16 and cout % 256 == 0 else 128


def conv3x3_bn_gelu(x: torch.Tensor, weight: torch.Tensor, conv_bias,
                    bn_weight: torch.Tensor, bn_bias: torch.Tensor,
                    bn_mean: torch.Tensor, bn_var: torch.Tensor,
                    eps: float = 1e-5, *, _tile_n: int = 0) -> torch.Tensor:
    """``gelu(batchnorm(conv3x3(x) + bias))`` with BN running statistics.

    CPU tensors take :func:`conv3x3_bn_gelu_ref`; CUDA tensors launch the
    kernel (``channels_last``; bf16 needs Cin and Cout multiples of 8, fp32
    (3xTF32) Cin a multiple of 4 and Cout of 8; a 16-byte aligned map) and
    raise on anything else.  The kernel has no backward, so on the card a
    call that autograd would record raises; on the CPU the plain version
    carries gradients.  ``_tile_n`` (128 or 256; fp32 has 128 only)
    overrides :func:`tile_n`, for measuring both.
    """
    if x.device.type == "cpu":
        return conv3x3_bn_gelu_ref(x, weight, conv_bias, bn_weight, bn_bias,
                                   bn_mean, bn_var, eps)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_gelu: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3x3_bn_gelu: need a 4-D fp32/bf16 map, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3x3_bn_gelu: the kernel takes NHWC maps "
                         "(channels_last memory format)")
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"conv3x3_bn_gelu: weight {tuple(weight.shape)} does "
                         f"not match Cin={cin}")
    if any(p is not None and p.device != x.device
           for p in (weight, conv_bias, bn_weight, bn_bias, bn_mean, bn_var)):
        raise ValueError("conv3x3_bn_gelu: parameters must be on x's device")
    bf16 = x.dtype == torch.bfloat16
    if cin % (8 if bf16 else 4) or cout % 8 or x.data_ptr() % 16:
        raise ValueError("conv3x3_bn_gelu: bf16 needs Cin, Cout multiples of 8, fp32 Cin a "
                         "multiple of 4 and Cout of 8, both a 16-byte aligned map; got "
                         f"{x.dtype} Cin={cin} Cout={cout}")
    if not bf16 and _tile_n not in (0, 128):
        raise ValueError("conv3x3_bn_gelu: the fp32 (3xTF32) kernel has 128-channel tiles only")
    if (max(x.numel(), n * h * w * cout, 9 * cin * cout) >= 2 ** 31
            or max(h, w) >= 2 ** 15):
        raise ValueError("conv3x3_bn_gelu: map too large for 32-bit offsets")
    params = (weight, conv_bias, bn_weight, bn_bias, bn_mean, bn_var)
    check_no_grad("conv3x3_bn_gelu", x, *(p for p in params if p is not None))
    wmat, w_lo, s, t = conv_weights(weight, conv_bias, bn_weight, bn_bias, bn_mean, bn_var,
                                    eps, x.dtype)
    out = torch.empty((n, cout, h, w), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv3x3_bn_gelu_launch(int(bf16), x.data_ptr(), wmat.data_ptr(),
                                        None if bf16 else w_lo.data_ptr(), s.data_ptr(),
                                        t.data_ptr(), out.data_ptr(), n, h, w, cin, cout,
                                        _tile_n or tile_n(cout, x.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bn_gelu: kernel launch failed (CUDA error {rc})")
    conv3x3_bn_gelu.launches += 1
    return out


conv3x3_bn_gelu.launches = 0
