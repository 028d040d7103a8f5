"""Benchmark of the port's paths, counterpart of the root ``bench.py``.

    python -m dmf_tpu_torch.bench                          # fusion inference, B=128
    python -m dmf_tpu_torch.bench --mode tta_mc --batch 8 [--encoder vit|hybrid|hybrid-nb]
    python -m dmf_tpu_torch.bench --encoder hybrid-nb --mode tta_mc --batch 2 --mc-chunk 1
    python -m dmf_tpu_torch.bench --int8 | --int8-prefix --mode tta_mc
    python -m dmf_tpu_torch.bench --train [--parallel-folds K]
    python -m dmf_tpu_torch.bench --train-e2e fusion|single [--native-loader]
    python -m dmf_tpu_torch.bench --numerics
    python -m dmf_tpu_torch.bench --quick --device cpu     # toy geometry on the CPU

Each run prints ONE JSON line ``{"metric", "value", "unit", ...}`` under
``bench.py``'s metric names and keys (``--out FILE`` also writes it).  It
runs on the card unless ``--device cpu`` is passed, and raises where no
card is present.  Against ``bench.py``:

* serving computes in bf16 on models cast to bf16, the port's serving route
  (``models/build.py::build_fusion_models(dtype=)``), with the kernels;
  training (``--train``, ``--train-e2e``, the training of ``--numerics``)
  computes in bf16 on fp32 parameters (``models/build.py::forward_in``), as
  ``bench.py``'s Flax modules with ``dtype=bfloat16`` do;
* ``achieved_tflops`` is one untimed call's count of products under
  ``torch.utils.flop_counter.FlopCounterMode`` (the kernels' operators carry
  formulas, ``ops/library.py``), where XLA's cost model also counts
  elementwise work; ``mfu`` divides it by the card's dense peak
  (:data:`PEAK_TFLOPS`), and only for the cards named there;
* ``vs_baseline`` and ``vs_conv_roofline``, ratios to TPU v5e figures, are
  not printed; ``--nyul-stride`` defaults to 1 (exact); ``--dump-hlo`` and
  the XLA compilation cache have no counterpart;
* ``--quick`` sets bench.py's toy geometry, and its batch and steps where
  ``--batch`` and ``--steps`` are not given (bench.py overrides them);
* ``--train`` raises where the last step's loss is not finite.

Timing is ``bench.py``'s: ``--warmup`` calls, then ``--steps`` calls between
two synchronizations of the card, by the host clock.  ``--profile DIR``
writes a Chrome trace of the timed calls (``utils/profiling.py::trace``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .config import Config, default_parameters, resolve_backbone_config
from .data.preprocess import preprocess_fusion_inputs
from .data.synthetic import make_synthetic_arrays
from .evals.predict import PassForward, make_fusion_predictor, to_model
from .losses import get_mask_loss_fn, soft_weighted_focal_loss
from .models.build import build_fusion_models
from .train.fusion import FusionNetwork, make_fusion_train_step
from .train.optim import FusionOptController, build_fusion_group_spec
from .train.state import TrainState
from .utils.profiling import trace

# dense peaks by ``torch.cuda.get_device_name()``, TFLOP/s (TOP/s for int8):
# the H100 SXM5 datasheet's figures without sparsity
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": {"bf16": 989.4, "int8": 1978.9}}
COMPUTE = torch.bfloat16
MC_MODES = ("mc", "tta_mc")
TRAIN_B = 32  # --numerics' training batch, the reference's (bench.py:261)


def build_parser() -> argparse.ArgumentParser:
    """``bench.py``'s flags (bench.py:365-452) without ``--dump-hlo``, plus
    ``--device``."""
    p = argparse.ArgumentParser(prog="python -m dmf_tpu_torch.bench")
    p.add_argument("--batch", type=int, default=None, help="default 128 (--quick: 8)")
    p.add_argument("--steps", type=int, default=None, help="default 20 (--quick: 3)")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--mode", default="normal", choices=["normal", "tta", "mc", "tta_mc"])
    p.add_argument("--encoder", default="resnet",
                   choices=["resnet", "vit", "hybrid", "hybrid-nb"],
                   help="the ResNet-50-backed encoders (default), ViT-B/16-backed, the "
                        "hybrid CNN->Transformer stage on the backbone (256 tokens), or the "
                        "hybrid without a backbone (4096 tokens)")
    p.add_argument("--no-preprocess", action="store_true")
    p.add_argument("--mc-chunk", type=int, default=None,
                   help="MC passes per chunk (bounds activation memory; each pass draws "
                        "its masks from its own pass word, so the ensemble is the same "
                        "at any chunking)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a Chrome trace of the timed calls into DIR")
    p.add_argument("--int8", action="store_true",
                   help="serve on int8 convs (ops/quant.py); prints agreement with fp")
    p.add_argument("--int8-prefix", action="store_true",
                   help="mc/tta_mc only: int8 for the hoisted deterministic prefix, fp for "
                        "every MC pass; prints ensemble agreement with fp")
    p.add_argument("--train-e2e", nargs="?", const="fusion", choices=["fusion", "single"],
                   default=None, help="the fit loop's sustained train-phase step rate")
    p.add_argument("--train-e2e-epochs", type=int, default=3)
    p.add_argument("--native-loader", action="store_true",
                   help="with --train-e2e: the native threaded loader on the host path")
    p.add_argument("--numerics", action="store_true",
                   help="brief bf16 training, then the same weights in bf16 and in fp32 "
                        "(TF32 off): AUC delta, argmax agreement, max prob delta")
    p.add_argument("--numerics-train-steps", type=int, default=300)
    p.add_argument("--numerics-test-n", type=int, default=512)
    p.add_argument("--train", action="store_true",
                   help="the fusion train step's rate on a staged batch")
    p.add_argument("--parallel-folds", type=int, default=1,
                   help="with --train: K folds a step (parallel/multifold.py)")
    p.add_argument("--nyul-stride", type=int, default=1,
                   help="Nyul landmark percentiles from every k-th pixel; k > 1 also "
                        "prints agreement with the exact path")
    p.add_argument("--quick", action="store_true",
                   help="toy geometry for CPU runs: 64^2, narrow encoders without a "
                        "backbone, and the batch and steps 8 and 3 unless given")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="also write the JSON line to FILE")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA one must exist (no fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def bench_config(args) -> Config:
    """The benched geometry (bench.py:502-535): the default config with the
    ``--encoder`` variant at ``--image-size``, or ``--quick``'s toy widths."""
    cfg = default_parameters(batch_size=args.batch)
    if args.native_loader:
        # the native loader is a host-path feature: the split stays on the host
        cfg = cfg.replace(use_native_loader=True, device_data=False)
    base = cfg.dwi_model
    if args.encoder == "vit":
        base = dataclasses.replace(base, backbone_str="vit_base_patch16_224")
    elif args.encoder == "hybrid":
        base = dataclasses.replace(base, use_hybrid_transformer=True)
    elif args.encoder == "hybrid-nb":
        base = dataclasses.replace(base, use_backbone=False, use_hybrid_transformer=True)
    mc = dataclasses.replace(resolve_backbone_config(base), input_size=args.image_size)
    fs = cfg.fusion_model.fusion_specific
    if args.quick:
        mc = dataclasses.replace(mc, channels=(32, 64, 128), use_backbone=False, proj_dim=16)
        fs = dataclasses.replace(fs, dwi_out_channels=128, dce_out_channels=128)
    elif args.encoder == "vit":  # ViT chains carry 768 channels into f3
        fs = dataclasses.replace(fs, dwi_out_channels=768, dce_out_channels=768)
    return cfg.replace(dwi_model=mc, dce_model=mc,
                       fusion_model=dataclasses.replace(mc, fusion_specific=fs))


def volumes(n: int, size: int, dwi_ch: int, dce_ch: int, num_classes: int, seed: int,
            n_test: int = 0) -> Dict[str, np.ndarray]:
    """Class-scaled synthetic blobs (``data/synthetic.py``), as bench.py's
    ``_volumes`` / ``_volumes2``."""
    return make_synthetic_arrays(n_train=n, n_test=n_test, image_size=size,
                                 dwi_channels=dwi_ch, dce_channels=dce_ch,
                                 num_classes=num_classes, mask_size=32, seed=seed)


def build_models(cfg: Config, device: torch.device):
    """The fp32 encoders and fusion head on weights seeded 0."""
    return build_fusion_models(cfg, device, torch.float32,
                               torch.Generator(device).manual_seed(0))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, warmup: int, steps: int, device: torch.device,
          profile: Optional[str] = None):
    """``warmup`` calls, then the seconds of ``steps`` calls between two
    synchronizations (traced into ``profile``), and the last call's output."""
    out = None
    for _ in range(warmup):
        out = fn()
    _sync(device)
    with trace(profile):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        _sync(device)
        dt = time.perf_counter() - t0
    return dt, out


def count_flops(fn: Callable) -> int:
    """The products of one call of ``fn`` (``FlopCounterMode``, with the
    operators' formulas registered first)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .ops.library import register_flop_formulas

    register_flop_formulas()

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def add_rates(result: dict, flops: int, calls: int, dt: float, device: torch.device,
              kind: str) -> None:
    """``achieved_tflops`` over the timed calls and, on a card of
    :data:`PEAK_TFLOPS`, ``mfu`` against its ``kind`` peak."""
    if flops <= 0:
        return
    achieved = flops * calls / dt / 1e12
    result["achieved_tflops"] = round(achieved, 2)
    if device.type == "cuda":
        peak = PEAK_TFLOPS.get(torch.cuda.get_device_name(device), {}).get(kind)
        if peak:
            result["mfu"] = round(achieved / peak, 4)


def _emit(result: dict, out: Optional[str]) -> None:
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")


# ------------------------------------------------------------------- serving
def serving_metric(args) -> str:
    """bench.py's metric name for the serving flags (bench.py:717-725)."""
    metric = ("fusion_inference_throughput" if args.mode == "normal"
              else f"fusion_{args.mode}_inference_throughput")
    if args.int8:
        metric += "_int8"
    if args.int8_prefix:
        metric += "_int8prefix"
    if args.encoder != "resnet":
        metric += "_" + args.encoder.replace("-", "_")
    return metric


def make_preprocess(args, device: torch.device) -> Callable:
    """``preprocess(dwi_raw, dce_raw, stride=None) -> (dx, cx)``: raw NHWC
    volumes to model inputs (bench.py:616-625), or the raw volumes with
    ``--no-preprocess``."""
    S = args.image_size
    adc_map = torch.full((S, S, 1), 0.5, device=device)

    def preprocess(dwi_raw, dce_raw, stride: Optional[int] = None):
        if args.no_preprocess:
            return dwi_raw, dce_raw
        return preprocess_fusion_inputs(dwi_raw, dce_raw, adc_map,
                                        percentile_stride=stride or args.nyul_stride)

    return preprocess


def fp_forward(models) -> PassForward:
    """The fp fusion forward of ``(dwi, dce, fusion)``."""
    return PassForward(models[:2], models[:2], models[2])


@torch.no_grad()
def logits_of(fwd: PassForward, dx, cx) -> torch.Tensor:
    """The fusion apply's logits on NHWC inputs (lean: no reconstruction
    heads or projectors, which the apply's caller never reads)."""
    d, c = fwd.encoders
    return fwd([to_model(dx, d), to_model(cx, c)], lean=True)[0]


def make_infer(cfg: Config, args, models, preprocess: Callable,
               fwd: Optional[PassForward] = None) -> Callable:
    """``infer(dwi_raw, dce_raw)``, the benched call (bench.py:664-689):
    class probabilities in ``normal`` (through ``fwd``, default the fp
    forward), ``(mean, std)`` of ``make_fusion_predictor`` otherwise
    (``fwd`` its override), its MC masks from a generator seeded 0 on every
    call, as bench.py's fixed key."""
    if args.mode == "normal":
        fwd = fwd or fp_forward(models)

        def infer(dwi_raw, dce_raw):
            dx, cx = preprocess(dwi_raw, dce_raw)
            return torch.softmax(logits_of(fwd, dx, cx).float(), dim=-1)

        return infer
    predictor = make_fusion_predictor(cfg, *models, mode=args.mode, fwd_override=fwd,
                                      mc_chunk=args.mc_chunk)
    device = next(models[0].parameters()).device

    def infer(dwi_raw, dce_raw):
        dx, cx = preprocess(dwi_raw, dce_raw)
        mean, std, _ = predictor(dx, cx, torch.Generator(device).manual_seed(0))
        return mean, std

    return infer


def _agreement(a: np.ndarray, b: np.ndarray) -> float:
    return round(float((a.argmax(-1) == b.argmax(-1)).mean()), 4)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def bench_serving(args, cfg: Config, device: torch.device) -> dict:
    """Fusion inference throughput in volumes/s (bench.py:594-809)."""
    S, B, C_dce = args.image_size, args.batch, cfg.dce_channel_num
    weights = build_models(cfg, device)
    models = [copy.deepcopy(m).to(COMPUTE) for m in weights]
    preprocess = make_preprocess(args, device)
    c_dwi = cfg.dwi_channel_num if args.no_preprocess else cfg.dwi_base_channel_num
    quant_fwd = None
    if args.int8 or args.int8_prefix:
        from .ops.quant import (make_hybrid_fusion_fwd, make_quantized_fusion_apply,
                                make_quantized_fusion_fwd)

        # calibrated on preprocessed volumes of a disjoint draw, with MC
        # dropout on for the MC modes; the fp32 weights are quantized
        cal = volumes(4, S, c_dwi, C_dce, cfg.class_num, seed=7)
        calib = preprocess(*(torch.as_tensor(cal[k], device=device) for k in ("dwi", "dce")))
        _, qsets = make_quantized_fusion_apply(*models, calibration=calib,
                                               calibration_mc=args.mode in MC_MODES,
                                               weights=weights)
        make = make_hybrid_fusion_fwd if args.int8_prefix else make_quantized_fusion_fwd
        quant_fwd = make(*models, qsets)
    del weights
    infer = make_infer(cfg, args, models, preprocess, quant_fwd)
    arr = volumes(B, S, c_dwi, C_dce, cfg.class_num, seed=0)
    dwi_raw = torch.as_tensor(arr["dwi"], device=device)
    dce_raw = torch.as_tensor(arr["dce"], device=device)

    flops = count_flops(lambda: infer(dwi_raw, dce_raw))
    dt, _ = timed(lambda: infer(dwi_raw, dce_raw), args.warmup, args.steps, device,
                  args.profile)
    volumes_per_sec = args.steps * B / dt
    result = {"metric": serving_metric(args), "value": round(volumes_per_sec, 2),
              "unit": "volumes/sec/chip"}
    add_rates(result, flops, args.steps, dt, device, "int8" if args.int8 else "bf16")

    if args.nyul_stride > 1 and not args.no_preprocess and args.mode == "normal" \
            and not args.int8:
        # the strided percentiles' probabilities against the exact path's
        p_s = _host(infer(dwi_raw, dce_raw))
        dx, cx = preprocess(dwi_raw, dce_raw, stride=1)
        p_1 = _host(torch.softmax(logits_of(fp_forward(models), dx, cx).float(), dim=-1))
        result["nyul_stride"] = args.nyul_stride
        result["nyul_stride_agreement"] = _agreement(p_s, p_1)
        result["max_prob_err"] = round(float(np.abs(p_s - p_1).max()), 4)
    if args.int8_prefix:
        # against the fp ensemble on the same inputs and the same masks
        dx, cx = preprocess(dwi_raw, dce_raw)
        outs = [predict(dx, cx, torch.Generator(device).manual_seed(0))[:2]
                for predict in (
                    make_fusion_predictor(cfg, *models, mode=args.mode, fwd_override=quant_fwd,
                                          mc_chunk=args.mc_chunk),
                    make_fusion_predictor(cfg, *models, mode=args.mode, mc_chunk=args.mc_chunk))]
        (m_h, s_h), (m_f, s_f) = ([_host(t) for t in o] for o in outs)
        result["hybrid_agreement"] = _agreement(m_h, m_f)
        result["max_prob_err"] = round(float(np.abs(m_h - m_f).max()), 4)
        result["max_std_err"] = round(float(np.abs(s_h - s_f).max()), 4)
    if args.int8:
        # the int8 logits against the fp ones on the same inputs
        dx, cx = preprocess(dwi_raw, dce_raw)
        l_fp = _host(logits_of(fp_forward(models), dx, cx))
        l_q = _host(logits_of(quant_fwd, dx, cx))
        result["int8_agreement"] = _agreement(l_fp, l_q)
        result["max_logit_err"] = round(float(np.abs(l_fp - l_q).max()), 4)
    return result


# ------------------------------------------------------------------ training
def fusion_state(cfg: Config, device: torch.device) -> TrainState:
    """The fusion network's train state on fp32 weights seeded 0."""
    return TrainState.create(FusionNetwork(*build_models(cfg, device)), num_groups=4)


def _focal(logits, targets):
    return soft_weighted_focal_loss(logits, targets, 1.5, None)


def fusion_step(cfg: Config, state: TrainState) -> Callable:
    """The fusion train step in bf16 on fp32 parameters (bench.py:62-68)."""
    spec = build_fusion_group_spec([n for n, _ in state.model.named_parameters()], cfg)
    return make_fusion_train_step(cfg, _focal, get_mask_loss_fn(cfg, "fusion"), spec,
                                  compute_dtype=COMPUTE)


def _staged(arr: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(arr[k], device=device) for k in ("dwi", "dce", "masks", "labels")}


def bench_train(args, cfg: Config, device: torch.device) -> dict:
    """Fusion train steps a second on one staged batch (bench.py:47-131);
    ``--parallel-folds K`` steps K folds a call (``make_multifold_step``)."""
    B, S, K = args.batch, args.image_size, args.parallel_folds
    hp = FusionOptController(cfg).hyperparams()
    batch = dict(_staged(volumes(B, S, cfg.dwi_channel_num, cfg.dce_channel_num,
                                 cfg.class_num, seed=0), device), aux_w=1.0)
    if K <= 1:
        state = fusion_state(cfg, device)
        step, gen = fusion_step(cfg, state), torch.Generator(device).manual_seed(0)

        def run():
            return step(state, batch, gen, hp)
    else:
        from .parallel.multifold import make_multifold_step

        states = [fusion_state(cfg, device) for _ in range(K)]
        step = make_multifold_step(fusion_step(cfg, states[0]))
        gens = [torch.Generator(device).manual_seed(i) for i in range(K)]

        def run():
            return step(states, [batch] * K, gens, hp)

    flops = count_flops(run)
    dt, metrics = timed(run, args.warmup, args.steps, device, args.profile)
    if not torch.isfinite(metrics["loss"]).all():
        raise FloatingPointError(f"--train: the last step's loss is {metrics['loss']}")
    steps_per_sec = args.steps / dt
    result = {
        "metric": ("fusion_training_throughput" if K <= 1
                   else "fusion_multifold_training_throughput"),
        "value": round(steps_per_sec, 3),
        "unit": (f"steps/sec (batch {B})" if K <= 1 else f"steps/sec ({K} folds x batch {B})"),
    }
    add_rates(result, flops, args.steps, dt, device, "bf16")
    return result


def bench_train_e2e(args, cfg: Config, device: torch.device) -> dict:
    """The fit loop's sustained train-phase step rate over the epochs after
    the first (bench.py:134-228): ``fit_fusion`` on processed volumes, or
    ``fit_single`` with ``ModalityProcessor.train_batch`` on raw ones."""
    from .data.modality import ModalityProcessor
    from .train.loop import fit_fusion, fit_single
    from .train.optim import SingleModelOptController

    B, S, epochs = args.batch, args.image_size, args.train_e2e_epochs
    n_train, n_val = 16 * B, max(B // 4, 8)
    suffix = "_native" if args.native_loader else ""
    kw = dict(num_epochs=epochs, min_epochs=epochs, viz_every=0, compute_dtype=COMPUTE)
    with tempfile.TemporaryDirectory(prefix="dmf_e2e_") as workdir:
        t0 = time.perf_counter()
        if args.train_e2e == "fusion":
            arr = volumes(n_train, S, cfg.dwi_channel_num, cfg.dce_channel_num,
                          cfg.class_num, seed=0, n_test=n_val)
            res = fit_fusion(
                cfg, fusion_state(cfg, device),
                train_data={k: arr[k] for k in ("dwi", "dce", "masks", "labels")},
                val_data={"dwi": arr["dwi_test"], "dce": arr["dce_test"],
                          "labels": arr["labels_test"]}, workdir=workdir, **kw)
            metric = "fusion_train_e2e_throughput" + suffix
        else:
            arr = volumes(n_train, S, cfg.dwi_base_channel_num, cfg.dce_channel_num,
                          cfg.class_num, seed=0, n_test=n_val)
            processor = ModalityProcessor(cfg, "dwi", device=device,
                                          adc_map=torch.full((S, S, 1), 0.5, device=device))
            res = fit_single(
                cfg, "dwi", TrainState.create(build_models(cfg, device)[0]),
                train_data={"imgs": arr["dwi"], "masks": arr["masks"], "labels": arr["labels"]},
                val_data={"imgs": arr["dwi_test"], "labels": arr["labels_test"]},
                processor=processor, controller=SingleModelOptController(cfg, "dwi"),
                workdir=workdir, **kw)
            metric = "single_train_e2e_throughput" + suffix
        wall = time.perf_counter() - t0
    steps_per_epoch = -(-n_train // B)
    train_times = [h["train_time"] for h in res.history]
    sustained = (steps_per_epoch * (epochs - 1) / sum(train_times[1:])
                 if epochs > 1 else steps_per_epoch / train_times[0])
    return {
        "metric": metric,
        "value": round(sustained, 3),
        "unit": f"steps/sec (product fit loop, batch {B}, train phase, warm epochs)",
        "wall_steps_per_sec": round(steps_per_epoch * epochs / wall, 3),
        "first_epoch_time_s": round(train_times[0], 1),
        "epochs": epochs,
        "steps_per_epoch": steps_per_epoch,
        "epoch_times_s": [round(t, 2) for t in train_times],
    }


@contextlib.contextmanager
def full_fp32():
    """fp32 products without TF32 in the block, the counterpart of
    ``jax.default_matmul_precision("highest")``; the settings come back after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def bench_numerics(args, cfg: Config, device: torch.device) -> dict:
    """bf16 against fp32 on the same trained weights (bench.py:231-351):
    brief bf16 training on the synthetic blobs, then the test volumes through
    the bf16 serving models and the fp32 ones with TF32 off; the AUC delta,
    argmax agreement and largest probability delta."""
    from .evals.metrics import multiclass_auroc

    S = args.image_size
    n_train = max(TRAIN_B * 4, 128)
    arr = volumes(n_train, S, cfg.dwi_channel_num, cfg.dce_channel_num, cfg.class_num,
                  seed=0, n_test=args.numerics_test_n)
    state = fusion_state(cfg, device)
    step = fusion_step(cfg, state)
    hp = FusionOptController(cfg).hyperparams()
    xs = _staged(arr, device)
    loss = None
    for i in range(args.numerics_train_steps):
        lo = (i * TRAIN_B) % n_train
        batch = dict({k: v[lo:lo + TRAIN_B] for k, v in xs.items()}, aux_w=1.0)
        loss = step(state, batch, torch.Generator(device).manual_seed(1000 + i), hp)["loss"]
    final_loss = float(loss) if loss is not None else float("nan")

    net = state.model
    f32 = fp_forward((net.dwi, net.dce, net.fusion))
    f16 = fp_forward([copy.deepcopy(m).to(COMPUTE) for m in (net.dwi, net.dce, net.fusion)])
    p16, p32 = [], []
    n_test = len(arr["labels_test"])
    for lo in range(0, n_test, args.batch):
        xd, xc = arr["dwi_test"][lo:lo + args.batch], arr["dce_test"][lo:lo + args.batch]
        p16.append(_host(torch.softmax(logits_of(f16, xd, xc).float(), dim=-1)))
        with full_fp32():
            p32.append(_host(torch.softmax(logits_of(f32, xd, xc), dim=-1)))
    p16, p32 = np.concatenate(p16), np.concatenate(p32)
    y = np.asarray(arr["labels_test"])
    auc16 = multiclass_auroc(p16, y, cfg.class_num)
    auc32 = multiclass_auroc(p32, y, cfg.class_num)
    delta = abs(auc16 - auc32)
    return {
        "metric": "bf16_vs_fp32_numerics",
        "value": round(delta, 5),
        "unit": "abs AUC delta (bf16 vs fp32 with TF32 off, same trained weights)",
        "auc_bf16": round(auc16, 5),
        "auc_fp32": round(auc32, 5),
        "argmax_agreement": _agreement(p16, p32),
        "max_prob_delta": round(float(np.abs(p16 - p32).max()), 5),
        "train_steps": args.numerics_train_steps,
        "final_train_loss": round(final_loss, 4),
        "test_n": n_test,
    }


def parse_args(argv=None) -> argparse.Namespace:
    """The arguments of ``argv``, refusing bench.py's conflicts, with
    ``--quick``'s geometry and the default batch and steps filled in."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.int8 and args.int8_prefix:
        parser.error("--int8 and --int8-prefix are mutually exclusive")
    if args.int8_prefix and args.mode not in MC_MODES:
        parser.error("--int8-prefix applies to --mode mc/tta_mc only "
                     "(there is no hoisted prefix elsewhere)")
    if args.quick:
        args.image_size = 64
    args.batch = args.batch or (8 if args.quick else 128)
    args.steps = args.steps or (3 if args.quick else 20)
    return args


def main(argv=None) -> dict:
    """Run the mode ``argv`` names, print its JSON line and return it."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = bench_config(args)
    if args.train:
        result = bench_train(args, cfg, device)
    elif args.numerics:
        result = bench_numerics(args, cfg, device)
    elif args.train_e2e:
        result = bench_train_e2e(args, cfg, device)
    else:
        result = bench_serving(args, cfg, device)
    _emit(result, args.out)
    return result


if __name__ == "__main__":
    main()
