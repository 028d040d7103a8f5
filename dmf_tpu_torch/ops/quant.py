"""Post-training int8 quantization for the serving path (opt-in).

Counterpart of ``dmf_tpu/ops/quant.py``, with its public names.  Scheme, as
there:

* weights: symmetric per-output-channel int8, quantized once on the host
  (:func:`quantize_kernel_per_channel`, bit-equal to the JAX QuantSet);
* activations: symmetric per-tensor int8, from a static scale calibrated on
  preprocessed volumes (:func:`calibrate_act_scales`) or, without one,
  dynamic (the tensor's abs-max at each call);
* accumulation in int32 (exact), then ``float(acc) * (x_scale * w_scale)``,
  the bias, and a cast to the input's dtype.

The QuantSet is built from fp32 weights, as JAX builds it from its fp32
params whatever the compute dtype: :func:`build_quant_set` refuses another
dtype.  A bf16 model served in int8 takes the QuantSet of its fp32 original
(``make_quantized_fusion_apply(..., weights=)``), or is a quantized copy of
the fp32 model cast after: a :class:`QuantConv2d` keeps its scales and bias
in fp32 through any cast, and the plain versions refuse other scales, as the
kernels do.

What is quantized: every ``nn.Conv2d`` with ``groups == 1``, at least
``min_fan_in`` inputs (kh * kw * Cin) and ``min_out`` outputs, except the SE
blocks' 1x1 convs, which stand for the JAX model's Dense layers
(``dmf_tpu/models/layers.py:187-189``).

Over a mesh's model axis (``parallel/tensor.py``) the models are sharded
first, then quantized, as JAX shards its state before it builds the int8
forward (``dmf_tpu/pipeline/run_fusion.py:130-166``).  A
:class:`~..parallel.tensor.ShardedConv2d` is quantized from its shard: the
weight scheme is per output channel, so its QuantSet entry is bit for bit
rows ``[lo:hi]`` of one process's, and the size test is made on the whole
conv, as JAX tests the global leaf.  Its int8 stand-in
(:class:`ShardedQuantConv2d`) quantizes the whole (replicated) input, whose
scale is then the same on every rank, runs the int8 conv on its rows with
the bias in the dequantizing epilogue, and gathers the channels: the map is
bit-equal to one process's.

Where JAX swaps convs at trace time with a Flax method interceptor, the port
swaps modules: :func:`quantized_copy` deep-copies a model and puts a
:class:`QuantConv2d` in place of each conv of the QuantSet.  The caller's fp
models stay untouched.  A :class:`QuantConv2d` holds its int8 weight (OHWI,
the layout the kernel reads), the fp32 per-channel scale, the static
``x_scale`` (when calibrated) and the bias as buffers, so that
``functional_call`` and ``torch.export`` carry them as arguments.  In the
adapter necks a :class:`QuantConv2d` runs the int8 conv, then eval
BatchNorm, then exact GELU (the JAX adapter's XLA route): kernel 2
(``conv3x3_bn_gelu``) is not launched at a quantized neck.

The kernels: ``int8_conv`` (``csrc/int8_conv.cu``, a warp-specialised
implicit-GEMM conv on ``wgmma`` s8 with a dequantizing epilogue),
``quantize`` (the static route) and ``dynamic_quantize`` (abs-max, scale and
quantize in one cooperative launch; ``csrc/int8_quantize.cu``), through the
``dmf::`` operators of ``ops/library.py``.  Each wrapper below takes the
plain version for CPU tensors and launches its kernel for CUDA tensors,
with no fallback from one to the other.  The plain conv runs in float64 on
the int8 values, which is exact (|acc| <= 127^2 K, far below 2^53), with
cuDNN off (its FFT and Winograd algorithms are not).

Calibration with ``calibration_mc`` draws its dropout masks from the
generator kind serving draws from: a ``torch.Generator`` on the models'
device, or a :class:`~.dropout.SeedStream`.  JAX calibrates on the raw
threefry key while serving draws from rbg-wrapped keys; no mask stream of
the port equals JAX's, so parity with JAX holds with ``calibration_mc=False``.

The serving artifact (``serving.py``) differs from JAX's, whose forward
closes over the QuantSets: here the quantized copies are modules of the
program, and their int8 weights and scales ride as arguments beside the fp
state dicts (:func:`~..serving.serving_variables`), so the artifact stays
weights-free.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# name-keyed set of quantized conv weights:
#   {"backbone.layer1.0.conv1": {"kernel_q": int8 OHWI, "scale": (O,) fp32,
#                                "bias": (O,) fp32 where the conv has one,
#                                "x_scale": () fp32 once calibrated}}
QuantSet = Dict[str, Dict[str, torch.Tensor]]


# ------------------------------------------------------------ plain versions
def _check_fp32(name: str, **scales: Optional[torch.Tensor]) -> None:
    """The kernels take fp32 scales only; the plain versions refuse others
    too, so that no device serves rounded scales."""
    for key, t in scales.items():
        if t is None or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be an fp32 tensor, got "
                             f"{None if t is None else t.dtype}")


def quantize_ref(x: torch.Tensor, scale: torch.Tensor, divide: bool) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` (dynamic, quant.py:84-86) or
    ``clip(round(x * (1 / scale)), -127, 127)`` (static, quant.py:93) in
    fp32, rounded half to even, as int8; ``scale`` an fp32 scalar."""
    _check_fp32("quantize", scale=scale)
    t = x.float() / scale if divide else x.float() * (1.0 / scale)
    return torch.round(t).clamp_(-127, 127).to(torch.int8)


def abs_max_ref(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` in fp32, an fp32 scalar (NaN where ``x`` holds one)."""
    return x.float().abs().amax()


def dynamic_quantize_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_q, scale)``: ``scale = max(max|x|, 1e-12) / 127`` in fp32, NaN
    kept (quant.py:84-85), and ``x_q = quantize_ref(x, scale, True)``.  The
    127 is a tensor on ``x``'s device: torch divides by a Python number as a
    product with its reciprocal on the card."""
    amax = abs_max_ref(x)
    scale = torch.clamp_min(amax, 1e-12) / amax.new_tensor(127.0)
    return quantize_ref(x, scale, True), scale


def int8_conv_ref(xq: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                  x_scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                  stride: Sequence[int], padding: Sequence[int], dilation: Sequence[int],
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 conv of (N, C, H, W) ``xq`` with the OHWI weight ``wq``:
    the int32 accumulators (``out_dtype`` int32) or ``float(acc) * (x_scale
    * w_scale) + bias`` rounded to ``out_dtype`` (quant.py:136-139).  The sum
    runs in float64 with cuDNN off: exact.  The scales are fp32."""
    if out_dtype != torch.int32:
        _check_fp32("int8_conv", w_scale=w_scale, x_scale=x_scale)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.double(), wq.permute(0, 3, 1, 2).double(), None, tuple(stride),
                       tuple(padding), tuple(dilation))
    acc = acc.to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * (x_scale.reshape(()) * w_scale)[None, :, None, None]
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y.to(out_dtype)


# ------------------------------------------------------------------ wrappers
def _checked(name: str, x: torch.Tensor, *tensors: Optional[torch.Tensor]) -> None:
    from .prepared import check_no_grad

    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda":
        check_no_grad(name, x, *tensors)


def quantize(x: torch.Tensor, scale: torch.Tensor, divide: bool = False) -> torch.Tensor:
    """int8 ``x`` at the fp32 scalar ``scale`` (:func:`quantize_ref`): the
    ``quantize`` operator, the plain version on the CPU and
    ``csrc/int8_quantize.cu`` on the card (fp32 or bf16, contiguous or
    channels_last; the int8 copy keeps the memory format)."""
    _checked("quantize", x)
    return torch.ops.dmf.quantize(x.detach(), scale, bool(divide))


def dynamic_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_q, scale)`` at the tensor's own abs-max (:func:`dynamic_quantize_ref`):
    the ``dynamic_quantize`` operator, the plain version on the CPU and one
    launch of ``csrc/int8_quantize.cu`` on the card (fp32 or bf16, contiguous
    or channels_last; the int8 copy keeps the memory format)."""
    _checked("dynamic_quantize", x)
    return torch.ops.dmf.dynamic_quantize(x.detach())


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
              x_scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
              stride: Sequence[int], padding: Sequence[int], dilation: Sequence[int],
              out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 conv (:func:`int8_conv_ref`): the ``int8_conv`` operator,
    the plain version on the CPU and ``csrc/int8_conv.cu`` on the card
    (channels_last int8 maps, the output channels_last)."""
    _checked("int8_conv", xq, bias)
    return torch.ops.dmf.int8_conv(xq, wq, w_scale, x_scale, bias, list(stride),
                                   list(padding), list(dilation), out_dtype)


quantize.launches = 0
dynamic_quantize.launches = 0
int8_conv.launches = 0


def _dynamic_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric dynamic int8: ``(x_q, scale)`` with ``scale =
    max(amax, 1e-12) / 127`` in fp32 (quant.py:76-87)."""
    return dynamic_quantize(x)


def _static_quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``x`` at a calibrated scale, by its fp32 reciprocal (quant.py:90-94)."""
    return quantize(x, scale, divide=False)


# ------------------------------------------------------------------ weights
def quantize_kernel_per_channel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an OIHW conv weight, on the host:
    ``(q, scale)`` with ``q`` int8 in OHWI and ``scale`` (O,) fp32, bit-equal
    to JAX's ``quantize_kernel_per_channel`` of the HWIO kernel (amax over
    (kh, kw, in) in fp32, ``max(amax, 1e-12) / 127``, round half to even)."""
    k = weight.detach().to(device="cpu", dtype=torch.float32)
    amax = k.abs().amax(dim=(1, 2, 3))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.round(k / scale[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
    return q.permute(0, 2, 3, 1).contiguous(), scale


def _sharded(conv: nn.Module) -> bool:
    """Whether ``conv`` is an output-channel shard (imported here: a serving
    process imports the operators of ``ops`` alone)."""
    from ..parallel.tensor import ShardedConv2d

    return isinstance(conv, ShardedConv2d)


def _quantizable(conv: nn.Module) -> bool:
    """An ungrouped ``nn.Conv2d``, or the output-channel shard of one."""
    return (type(conv) is nn.Conv2d and conv.groups == 1) or _sharded(conv)


def _rank_bias(conv: nn.Module) -> Optional[torch.Tensor]:
    """The conv's bias, this rank's channels of it for a sharded conv (whose
    bias is replicated whole)."""
    return conv.channels(conv.bias)[0] if _sharded(conv) else conv.bias


def build_quant_set(model: nn.Module, min_fan_in: int = 256, min_out: int = 32) -> QuantSet:
    """Pre-quantize every conv of ``model`` big enough to win on the tensor
    cores (quant.py:48-73), keyed by module name; ``groups == 1`` only
    (quant.py:152-153).  The weights must be fp32 (JAX's params are); an
    entry also holds the conv's bias in fp32.  A conv sharded over a model
    axis is tested on its whole size and quantized from its shard: its
    entry is this rank's rows of one process's."""
    from ..models.layers import SEBlock

    dense = {id(m) for se in model.modules() if isinstance(se, SEBlock)
             for m in se.fc.modules()}
    out: QuantSet = {}
    for name, conv in model.named_modules():
        if not _quantizable(conv) or id(conv) in dense:
            continue
        _, i, kh, kw = conv.weight.shape
        if kh * kw * i < min_fan_in or conv.out_channels < min_out:
            continue
        if isinstance(conv.padding, str):
            raise ValueError(f"{name}: padding {conv.padding!r} is not explicit")
        if conv.weight.dtype != torch.float32:
            raise ValueError(f"{name}: a {conv.weight.dtype} weight; quantize the fp32 model "
                             f"(a bf16 model's weights are rounded)")
        q, scale = quantize_kernel_per_channel(conv.weight)
        out[name] = {"kernel_q": q, "scale": scale}
        bias = _rank_bias(conv)
        if bias is not None:
            out[name]["bias"] = bias.detach().to("cpu", torch.float32, copy=True)
    return out


def shard_quant_set(qset: QuantSet, model: nn.Module) -> QuantSet:
    """``qset`` with each whole entry of a conv that ``model`` holds sharded
    cut to this rank's rows (``kernel_q``, ``scale`` and ``bias``; the
    per-tensor ``x_scale`` stays); entries already of the shard's size, and
    those of whole convs, as they are.  A QuantSet of a model's fp32
    original, or of one process, then serves the sharded model."""
    out: QuantSet = {}
    for name, e in qset.items():
        conv = model.get_submodule(name)
        if _sharded(conv) and e["kernel_q"].shape[0] == conv.out_channels:
            e = {k: v[conv.lo:conv.hi].clone() if k != "x_scale" else v for k, v in e.items()}
        out[name] = e
    return out


class QuantConv2d(nn.Module):
    """int8 stand-in for an ``nn.Conv2d`` (quant.py:_quant_conv_call): the
    input quantized at the static ``x_scale`` (or dynamically), the int8
    conv, the dequantizing epilogue with the bias, the input's dtype out.
    Buffers, from the QuantSet entry ``q``: ``weight_q`` (O, kh, kw, C)
    int8, ``w_scale`` (O,) fp32, ``x_scale`` () fp32 or None, ``bias`` (O,)
    fp32 or None (``q``'s, else the conv's).  The fp32 buffers stay fp32
    when the module is cast, as JAX's scales and bias params do."""

    _FP32 = ("w_scale", "x_scale", "bias")

    def __init__(self, conv: nn.Conv2d, q: Dict[str, torch.Tensor]):
        super().__init__()
        o, c, kh, kw = conv.weight.shape
        if tuple(q["kernel_q"].shape) != (o, kh, kw, c):
            raise ValueError(f"QuantSet weight {tuple(q['kernel_q'].shape)} for a conv of "
                             f"{(o, kh, kw, c)} (O, kh, kw, C)")
        dev = conv.weight.device
        xs, bias = q.get("x_scale"), q.get("bias", _rank_bias(conv))
        self.register_buffer("weight_q", q["kernel_q"].to(dev))
        self.register_buffer("w_scale", q["scale"].to(dev, torch.float32))
        self.register_buffer("x_scale", None if xs is None else
                             torch.as_tensor(xs, dtype=torch.float32).reshape(()).to(dev))
        self.register_buffer("bias", None if bias is None else
                             bias.detach().to(dev, torch.float32, copy=True))
        self.in_channels, self.out_channels = c, conv.out_channels
        self.kernel_size = (kh, kw)
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation

    def _apply(self, fn, recurse=True):
        # a cast moves the fp32 buffers to the new device only; and
        # ``.to(memory_format=channels_last)`` permutes every 4-D buffer: the
        # kernel reads the weight as contiguous OHWI
        kept = {k: getattr(self, k) for k in self._FP32}
        out = super()._apply(fn, recurse)
        for k, t in kept.items():
            if t is not None:
                setattr(self, k, t.to(getattr(self, k).device))
        self.weight_q = self.weight_q.contiguous()
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:  # the kernels take NHWC maps
            x = x.contiguous(memory_format=torch.channels_last)
        if self.x_scale is not None:
            xs = self.x_scale
            xq = _static_quantize(x, xs)
        else:
            xq, xs = _dynamic_quantize(x)
        return int8_conv(xq, self.weight_q, self.w_scale, xs, self.bias, self.stride,
                         self.padding, self.dilation, x.dtype)


class ShardedQuantConv2d(QuantConv2d):
    """The int8 stand-in of a :class:`~..parallel.tensor.ShardedConv2d`:
    :class:`QuantConv2d`'s buffers hold this rank's rows ``[lo:hi]`` of the
    weight, its scale and the bias (``q`` the shard's QuantSet entry); the
    activation scale is per tensor and whole.  The forward quantizes the
    whole input (the same on every model rank, so is a dynamic scale), runs
    the int8 conv on the shard with the bias in its epilogue, and gathers
    the channels over the model group: bit-equal to one process's conv.
    ``out_channels`` is the whole conv's."""

    def __init__(self, conv: nn.Module, q: Dict[str, torch.Tensor]):
        super().__init__(conv, q)
        self.mesh, self.lo, self.hi = conv.mesh, conv.lo, conv.hi

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.model_gather(super().forward(x), 1)


def _replace(model: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, leaf, new)


def quantized_copy(module: nn.Module, qset: QuantSet) -> nn.Module:
    """A deep copy of ``module`` (its own tensors) with each conv named in
    ``qset`` replaced by a :class:`QuantConv2d` (a :class:`ShardedQuantConv2d`
    for a sharded conv: the copy shares the mesh)."""
    out = copy.deepcopy(module)
    for name, q in qset.items():
        conv = out.get_submodule(name)
        if not _quantizable(conv):
            raise ValueError(f"{name}: not an ungrouped nn.Conv2d ({type(conv).__name__})")
        cls = ShardedQuantConv2d if _sharded(conv) else QuantConv2d
        _replace(out, name, cls(conv, q))
    return out


def quantized_apply(module: nn.Module, qset: QuantSet, *args, **kwargs):
    """``module(*args, **kwargs)`` with every QuantSet conv swapped to int8
    (quant.py:142-165), under ``torch.no_grad()``."""
    with torch.no_grad():
        return quantized_copy(module, qset)(*args, **kwargs)


# -------------------------------------------------------------- calibration
def _percentile(a: torch.Tensor, percentile: float) -> torch.Tensor:
    """``jnp.percentile(a, percentile)`` (linear interpolation, fp32
    positions) of a flat fp32 tensor, by ``kthvalue``: ``torch.quantile``
    refuses inputs above 2^24 elements."""
    n = a.numel()
    q = torch.tensor(percentile, dtype=torch.float32) / 100.0
    pos = q * (torch.tensor(float(n), dtype=torch.float32) - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    k_lo = min(max(int(lo), 0), n - 1) + 1
    k_hi = min(max(int(hi), 0), n - 1) + 1
    v_lo = torch.kthvalue(a, k_lo).values
    v_hi = v_lo if k_hi == k_lo else torch.kthvalue(a, k_hi).values
    return v_lo * w_lo.to(a.device) + v_hi * w_hi.to(a.device)


class _Recorder(nn.Module):
    """A conv that records the abs-max (or ``percentile``) of its inputs, the
    largest over its calls, and runs the conv."""

    def __init__(self, conv: nn.Module, key: str, seen: Dict[str, torch.Tensor],
                 percentile: float):
        super().__init__()
        self.conv, self.key, self.seen, self.percentile = conv, key, seen, percentile

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = x.detach().float().abs()
        amax = a.amax() if self.percentile >= 100.0 else _percentile(a.flatten(),
                                                                     self.percentile)
        prev = self.seen.get(self.key)
        self.seen[self.key] = amax if prev is None else torch.maximum(prev, amax)
        return self.conv(x)


def calibrate_act_scales(module: nn.Module, qset: QuantSet, *args,
                         percentile: float = 100.0, **kwargs):
    """Record a static activation scale for every quantized conv from one fp
    forward ``module(*args, **kwargs)`` on calibration data (quant.py:168-205):
    the per-tensor abs-max (or ``percentile``) of the conv's inputs over all
    its calls, stored as ``x_scale = float32(max(amax, 1e-12) / 127)`` with
    the division in float64.  The forward runs on a copy sharing ``module``'s
    tensors, with a recorder around each conv (the adapter necks on the
    conv / BatchNorm / GELU route).  A sharded conv's input is whole, so
    every model rank records the same scale (up to the rounding of its
    sharded activations).  Returns the forward's outputs."""
    seen: Dict[str, torch.Tensor] = {}
    shared = {id(t): t for t in (*module.parameters(), *module.buffers())}
    probe = copy.deepcopy(module, memo=dict(shared))
    for name in qset:
        _replace(probe, name, _Recorder(probe.get_submodule(name), name, seen, percentile))
    with torch.no_grad():
        out = probe(*args, **kwargs)
    for key, amax in seen.items():
        qset[key]["x_scale"] = torch.tensor(max(float(amax), 1e-12) / 127.0,
                                            dtype=torch.float32)
    return out


# ------------------------------------------------------- the fusion forwards
def make_quantized_fusion_apply(dwi_model: nn.Module, dce_model: nn.Module,
                                fusion_model: nn.Module, calibration=None,
                                calibration_mc: bool = False, calibration_rng=None,
                                weights: Optional[Sequence[nn.Module]] = None,
                                **quant_kw) -> Tuple[Any, Dict[str, QuantSet]]:
    """Quantized mirror of the fusion inference path (quant.py:208-270).

    Pre-quantizes each model's convs (a QuantSet each) and returns
    ``(apply_fn, qsets)``: ``apply_fn(dwi_x, dce_x, mc=False,
    generator=None)`` runs eval-mode int8 inference on NHWC volumes through
    :func:`make_quantized_fusion_fwd`'s copies (built at the first call)
    and returns ``(logits, fused_mask, aux, parts, None)`` (maps NCHW).
    ``weights`` are the fp32 models whose convs are quantized, where the
    models compute in bf16 (JAX quantizes its fp32 params whatever the
    compute dtype); by default the models themselves.  Models sharded over
    a model axis are quantized from their shards; whole ``weights`` of
    sharded models give QuantSets cut to the shards (:func:`shard_quant_set`).
    ``calibration`` is
    ``(dwi_x, dce_x)``, preprocessed NHWC volumes as served, run through the
    models (in their dtype, as JAX calibrates in its compute dtype);
    ``calibration_mc=True`` calibrates with MC dropout on, its masks from
    ``calibration_rng`` (a ``torch.Generator`` on the models' device or a
    ``SeedStream``; default a generator seeded 0), so that inverted
    dropout's 1/(1-p) does not clip at serving.
    """
    from ..evals.predict import to_model

    models = (dwi_model, dce_model, fusion_model)
    qsets = {k: shard_quant_set(build_quant_set(w, **quant_kw), m)
             for k, w, m in zip(("dwi", "dce", "fusion"), weights or models, models)}
    if calibration is not None:
        dwi_x, dce_x = (to_model(x, m) for x, m in zip(calibration, (dwi_model, dce_model)))
        gen = calibration_rng
        if calibration_mc and gen is None:
            gen = torch.Generator(dwi_x.device).manual_seed(0)
        kw = dict(mc=calibration_mc, generator=gen if calibration_mc else None)
        _, d_aux, d_mask = calibrate_act_scales(dwi_model, qsets["dwi"], dwi_x, **kw)
        _, c_aux, c_mask = calibrate_act_scales(dce_model, qsets["dce"], dce_x, **kw)
        calibrate_act_scales(fusion_model, qsets["fusion"], d_aux["raw_feats"],
                             c_aux["raw_feats"], d_mask, c_mask)
    fwd = []

    def apply_fn(dwi_x, dce_x, mc: bool = False, generator=None):
        if not fwd:
            fwd.append(make_quantized_fusion_fwd(*models, qsets))
        (qd, qc), qf = fwd[0].encoders, fwd[0].fusion
        with torch.no_grad():
            _, d_aux, d_mask = qd(to_model(dwi_x, qd), mc=mc, generator=generator)
            _, c_aux, c_mask = qc(to_model(dce_x, qc), mc=mc, generator=generator)
            logits, fused_mask, aux = qf(d_aux["raw_feats"], c_aux["raw_feats"], d_mask, c_mask)
        parts = {"dwi_aux": d_aux, "dce_aux": c_aux, "dwi_mask": d_mask, "dce_mask": c_mask}
        return logits, fused_mask, aux, parts, None

    return apply_fn, qsets


def make_quantized_fusion_fwd(dwi_model: nn.Module, dce_model: nn.Module,
                              fusion_model: nn.Module, qsets: Dict[str, QuantSet]):
    """The per-pass fusion forward on int8 copies of all three models
    (quant.py:273-318), for ``make_fusion_predictor(fwd_override=...)``: its
    hoisted prefix and every pass run the int8 convs."""
    from ..evals.predict import PassForward

    qd, qc, qf = (quantized_copy(m, qsets[k]) for k, m in
                  (("dwi", dwi_model), ("dce", dce_model), ("fusion", fusion_model)))
    return PassForward((qd, qc), (qd, qc), qf,
                       modules={"int8_dwi": qd, "int8_dce": qc, "int8_fusion": qf})


def make_hybrid_fusion_fwd(dwi_model: nn.Module, dce_model: nn.Module,
                           fusion_model: nn.Module, qsets: Dict[str, QuantSet]):
    """int8 deterministic prefix + fp stochastic suffix (quant.py:321-359):
    the hoisted prefix (modality SE, backbone, adapter) runs on int8 copies
    of the encoders, every MC pass on the fp models.  In ``normal``/``tta``,
    which hoist no prefix, it is the fp forward."""
    from ..evals.predict import PassForward

    qd, qc = (quantized_copy(m, qsets[k]) for k, m in (("dwi", dwi_model), ("dce", dce_model)))
    return PassForward((qd, qc), (dwi_model, dce_model), fusion_model,
                       modules={"int8_dwi": qd, "int8_dce": qc})
