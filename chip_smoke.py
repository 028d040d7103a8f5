"""Smoke run of the PyTorch port (dmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card identity (nvidia-smi name and power limit, torch/triton versions);
  2. kernel build from the sources in this checkout (the three CUDA
     libraries by nvcc in parallel, then the Triton JIT), with ptxas
     registers/spills and the wgmma kernels' dynamic shared memory;
  3. each hand-written kernel vs its plain PyTorch version at the served
     paths' shapes, fp32 (TF32 off) and bf16, with errors beside stated
     tolerances and median times beside the plain version's, the bound and
     the one PyTorch call that computes the same function (where there is
     one): 3a SE epilogue (32^2 maps of tta_mc, 128^2 maps of hybrid-nb),
     3b conv3x3+BN+GELU, 3c flash-attention forward, 3d its backward,
     with, for the two wgmma kernels (3b, 3c bf16), the kernel's own device
     time per call (profiler), its TFLOP/s and share of the bound, and the
     kernel timed in turns with its library yardstick and their ratio;
     3e the DWI z-score, 3f the histogram percentiles (on max-normalised
     synthetic DCE volumes), 3g the standalone SE;
  4. end-to-end parity, card (kernels) vs CPU (plain versions), fp32,
     seeded random weights at full width: 4 the default ResNet-50 models in
     ``tta`` at B=2, 4b the hybrid-transformer no-backbone models
     (``hybrid-nb``) in ``normal`` at B=1; 4c the data preparation
     (``prepare_single_data`` + ``export_processed_splits``, dwi and dce,
     256 + 64 synthetic volumes of 256^2), card vs CPU, with stage times;
  5. serving raw NHWC volumes -> on-card preprocessing -> predictor in bf16,
     3 requests of B=8 each, with launch counters checked per request and
     the preprocessing timed apart from the predictor: 5 the default models
     in ``tta_mc``, 5b ``hybrid-nb`` in ``normal`` then ``tta``;
  6. a profiler breakdown of one more ``tta_mc`` and one ``hybrid-nb``
     ``normal`` request.
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing anything.
"""

import copy
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from dmf_tpu_torch import default_parameters, resolve_backbone_config  # noqa: E402
from dmf_tpu_torch.data.preprocess import (DEFAULT_LANDMARKS, NyulStandardizer,  # noqa: E402
                                           dce_global_max_normalize, nyul_transform_fast,
                                           prep_dwi_adc_maps, preprocess_fusion_inputs)
from dmf_tpu_torch.data.synthetic import make_synthetic_arrays  # noqa: E402
from dmf_tpu_torch.evals.predict import make_fusion_predictor  # noqa: E402
from dmf_tpu_torch.models import build_fusion_models  # noqa: E402
from dmf_tpu_torch.ops import conv3x3 as k2  # noqa: E402
from dmf_tpu_torch.ops import dwi_norm  # noqa: E402
from dmf_tpu_torch.ops import epilogue as k1  # noqa: E402
from dmf_tpu_torch.ops import epilogue_triton  # noqa: E402
from dmf_tpu_torch.ops import flash_attention as fa  # noqa: E402
from dmf_tpu_torch.ops import histogram as hist  # noqa: E402
from dmf_tpu_torch.ops import se as sek  # noqa: E402
from dmf_tpu_torch.ops.cuda_build import BUILD_DIR  # noqa: E402
from dmf_tpu_torch.pipeline import (export_processed_splits, load_processed_split,  # noqa: E402
                                    prepare_single_data)

DEV = torch.device("cuda", 0)
SEED = 0
B_SERVE = 8
REQUESTS = 3
# fp32 sum-order tolerance; bf16: one bf16 ulp (2^-7) after an fp32 sum in
# another order flips a rounding.  Both relative to max(1, max|plain|).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
# main-path geometry at 256^2 inputs: SE epilogue maps at 32^2 (P-1 = 9 lean
# passes x 4 views x B), neck stages (Cin, Cout, side) at 4 views x B
EPI_CHANNELS = (128, 256, 512)
NECKS = (("neck_f1_conv0", 256, 128, 64), ("neck_f1_conv1", 128, 128, 64),
         ("neck_f2_conv0", 512, 128, 32), ("neck_f2_conv1", 128, 128, 32),
         ("neck_f3_conv0", 3072, 256, 32), ("neck_f3_conv1", 256, 256, 32))
# hybrid-nb geometry at 256^2 inputs: SE epilogue maps of block1/block2 at
# 128^2 x 128/256; attention over 64^2 = 4096 tokens, 4 heads of 128
HYB_EPI_CHANNELS = (128, 256)
SEQ, HEAD_DIM, HEADS = 4096, 128, 4
# standalone SE maps (N, side, C) of a tta_mc request at B=8: modality
# attention on the dwi and dce inputs (4 views), fusion_se on the lean chunk
# (9 passes x 4 views) and on the last pass
SE_MAPS = ((32, 256, 14), (32, 256, 6), (288, 32, 128), (32, 32, 128))
LANDMARKS = tuple(float(p) for p in DEFAULT_LANDMARKS)
# data preparation: the synthetic store at full image size
N_TRAIN, N_TEST, IMAGE = 256, 64, 256
# H100 SXM datasheet peaks (dense): the bounds are the larger of bytes over
# the memory rate and operations over the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def log(*a):
    print(*a, flush=True)


def gen(seed=SEED):
    return torch.Generator(device=DEV).manual_seed(seed)


def cuda_time(fn, reps=10, trials=5):
    """Median ms per call over ``trials`` windows of ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def launch_costs(fn, kernels, calls=20):
    """``fn``'s device ms per call in the kernels whose names contain one of
    ``kernels`` (profiler), and its host ms per call to enqueue them (host
    clock over ``calls`` calls, no synchronize inside)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type.name == "CUDA" and any(k in e.key for k in kernels))
    return dev / 5 / 1e3, host


def in_turns(kernel, library, **kw):
    """Median ms of ``kernel`` and ``library`` timed in turns (kernel,
    library, library, kernel), each the mean of its two windows: their
    ratio, not the raw times, is what compares across chip calls."""
    k1, l1 = cuda_time(kernel, **kw), cuda_time(library, **kw)
    l2, k2_ = cuda_time(library, **kw), cuda_time(kernel, **kw)
    return (k1 + k2_) / 2, (l1 + l2) / 2


def device_rate(tag, fn, kernels, flop, bound):
    """Log and return ``fn``'s device ms per call in ``kernels`` (profiler),
    with its TFLOP/s and its share of the bound.  A profiler session at times
    records none of the kernels' launches: it is taken again, up to three
    sessions, and the time is None ("not measured") if none records one."""
    for _ in range(3):
        dev, host = launch_costs(fn, kernels)
        if dev > 0:
            log(f"  {tag}: device {dev:.4f} ms per call (profiler), {flop / dev / 1e9:.1f} "
                f"TFLOP/s, {100 * bound / dev:.1f} % of the bound; host {host:.4f} ms per call "
                f"to enqueue")
            return dev
    log(f"  {tag}: device time not measured (no {'/'.join(kernels)} launch in three "
        f"profiler sessions)")
    return None


def check(name, got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    bound = TOL[dtype] * max(1.0, ref.float().abs().max().item())
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {bound:.3e})")
    if not err <= bound:
        raise AssertionError(f"{name}: error {err} above tolerance {bound}")
    return err


def check_rel(name, got, ref, dtype):
    """Error against TOL[dtype] * max|plain|, for tensors far below 1 in
    magnitude (attention gradients), where max(1, .) would say nothing."""
    err = (got.float() - ref.float()).abs().max().item()
    bound = TOL[dtype] * ref.float().abs().max().item()
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {bound:.3e} = {TOL[dtype]:.3g} x max|plain|)")
    if not err <= bound:
        raise AssertionError(f"{name}: error {err} above tolerance {bound}")
    return err


def expect_value_error(name, fn):
    """The check passes only if ``fn`` raises ValueError."""
    try:
        fn()
    except ValueError as e:
        log(f"  {name}: raises ValueError ({e})")
        return
    raise AssertionError(f"{name}: no ValueError raised")


def cl(t):
    return t.contiguous(memory_format=torch.channels_last)


COUNTERS = {"se_epilogue": (k1.se_epilogue, "launches"),
            "conv3x3_bn_gelu": (k2.conv3x3_bn_gelu, "launches"),
            "flash_attention_fwd": (fa.flash_attention, "launches"),
            "flash_attention_bwd_dq": (fa.flash_attention, "launches_dq"),
            "flash_attention_bwd_dkv": (fa.flash_attention, "launches_dkv"),
            "se_scale": (sek.se_scale, "launches"),
            "dwi_normalize": (dwi_norm.dwi_normalize, "launches"),
            "histogram_percentiles": (hist.histogram_percentiles, "launches")}


def reset_counts():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def hybrid_nb_config(cfg):
    """``bench.py --encoder hybrid-nb`` (bench.py:517-535): the default config
    with the hybrid-transformer encoders and no backbone, at full width."""
    mc = resolve_backbone_config(dataclasses.replace(
        cfg.dwi_model, use_backbone=False, use_hybrid_transformer=True))
    return cfg.replace(dwi_model=mc, dce_model=mc, fusion_model=dataclasses.replace(
        mc, fusion_specific=cfg.fusion_model.fusion_specific))


# ------------------------------------------------------------------ phase 1
def phase_identity():
    log("== phase 1: card identity")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    import triton
    log(f"torch {torch.__version__} cuda {torch.version.cuda} triton {triton.__version__} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


# ------------------------------------------------------------------ phase 2
def phase_build():
    log("== phase 2: kernel build")
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    libs = {"conv3x3_bn_gelu": k2._library, "flash_attention": fa._library,
            "histogram_percentiles": hist._library}
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, together
        for f in [pool.submit(build) for build in libs.values()]:
            f.result()
    log(f"  {' + '.join(libs)} (nvcc, sm_90a, in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        for p in sorted(BUILD_DIR.glob(f"{name}-*/build.log")):
            kernel = ""
            for line in p.read_text().splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1][-60:]
                elif ("registers" in line or "spill" in line or "setmaxnreg" in line
                      or "warning" in line.lower()):
                    log(f"  ptxas {name} {kernel}: {line.strip()}")
    # ptxas reports static shared memory only; the wgmma kernels' is dynamic
    flash_smem, conv_smem = fa._library().flash_fwd_wgmma_smem, \
        k2._library().conv3x3_bn_gelu_wgmma_smem
    log(f"  dynamic shared memory per block: flash_fwd_wgmma D=128 {flash_smem(128)} B, "
        f"D=64 {flash_smem(64)} B; conv3x3_bn_gelu_wgmma 128x256 {conv_smem(256)} B, "
        f"128x128 {conv_smem(128)} B")
    t0 = time.perf_counter()
    x = cl(torch.randn(2, 128, 8, 8, device=DEV))
    w1, w2 = torch.randn(64, 128, device=DEV), torch.randn(128, 64, device=DEV)
    b1, b2 = torch.zeros(64, device=DEV), torch.zeros(128, device=DEV)
    for drop in (0.0, 0.2):
        k1.se_epilogue(x, x, w1, b1, w2, b2, drop_rate=drop, generator=gen())
    torch.cuda.synchronize()
    log(f"  se_epilogue (Triton JIT, fp32): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        sek.se_scale(x.to(dtype), w1, b1, w2, b2)
        for flags in ((True, True), (True, False), (False, False)):
            dwi_norm.dwi_normalize(torch.rand(2, 8, 8, 13, device=DEV).to(dtype), (-3.0, 3.0),
                                   *flags)
    torch.cuda.synchronize()
    log(f"  se_scale + dwi_normalize (Triton JIT, fp32 + bf16): "
        f"{time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------------ phase 3
def epi_inputs(n, c, dtype, g, side=32):
    x = cl(torch.randn(n, c, side, side, device=DEV, generator=g).to(dtype))
    idn = cl(torch.randn(n, c, side, side, device=DEV, generator=g).to(dtype))
    w1 = torch.randn(c // 2, c, device=DEV, generator=g) * c ** -0.5
    w2 = torch.randn(c, c // 2, device=DEV, generator=g) * (c / 2) ** -0.5
    b1 = torch.randn(c // 2, device=DEV, generator=g) * 0.1
    b2 = torch.randn(c, device=DEV, generator=g) * 0.1
    return x, idn, w1, b1, w2, b2


def phase_epilogue(n_passes, n_views):
    n_lean = n_passes * n_views
    log(f"== phase 3a: se_epilogue (Triton) vs plain, N={n_passes}x{n_views} maps of 32x32xC")
    g = gen(1)
    errs, ms, plain_ms, nbytes = [], 0.0, 0.0, 0
    p = 0.2
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        for j, c in enumerate(EPI_CHANNELS):
            args = epi_inputs(n_lean, c, dtype, g)
            tag = f"{str(dtype)[6:]} C={c}"
            out = k1.se_epilogue(*args)
            errs.append(check(f"{tag} drop=0", out, k1.se_epilogue_ref(*args), dtype))
            # the wrapper draws its Philox seed from g_mc; a twin generator on
            # the same seed gives that seed back for the kernel's own mask
            mc_seed = 100 + 10 * i + j
            g_mc = gen(mc_seed)
            out = k1.se_epilogue(*args, drop_rate=p, generator=g_mc)
            keep = epilogue_triton.keep_mask(
                args[0], p, epilogue_triton.draw_seed(gen(mc_seed), DEV))
            errs.append(check(f"{tag} drop={p} (kernel's own mask)", out,
                              k1.se_epilogue_ref(*args, drop_rate=p, keep=keep), dtype))
            n = keep.numel()
            frac = keep.float().mean().item()
            bound = 5 * ((p * (1 - p)) / n) ** 0.5
            log(f"  {tag} keep fraction {frac:.6f} (1-p={1 - p}, 5-sigma bound {bound:.2e})")
            if abs(frac - (1 - p)) > bound:
                raise AssertionError("keep fraction outside binomial bounds")
            # two MC passes are two segments of the folded batch
            rows = keep.permute(0, 2, 3, 1).reshape(n_passes, -1).float()
            a, b = rows[0] - rows[0].mean(), rows[1] - rows[1].mean()
            corr = ((a * b).mean() / (a.std() * b.std())).item()
            cb = 5 / rows.shape[1] ** 0.5
            log(f"  {tag} pass-0/pass-1 mask correlation {corr:+.2e} (bound {cb:.2e})")
            if abs(corr) > cb:
                raise AssertionError("MC pass masks are correlated")
            t_k = cuda_time(lambda: k1.se_epilogue(*args, drop_rate=p, generator=g_mc))
            gp = gen(2)
            t_p = cuda_time(lambda: k1.se_epilogue_ref(*args, drop_rate=p, generator=gp))
            log(f"  {tag} drop={p}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median)")
            if dtype == torch.bfloat16:
                ms += t_k
                plain_ms += t_p
                # least traffic: read x and identity, write out, once each
                nbytes += 3 * args[0].numel() * args[0].element_size()
            del args, out, keep, rows
    torch.cuda.empty_cache()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  bf16 sum over C: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms (bytes)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def phase_epilogue_hybrid():
    log("== phase 3a (hybrid-nb): se_epilogue vs plain at 128x128 maps, drop 0 "
        "(normal: N=8, tta: N=32)")
    g = gen(5)
    for n in (8, 32):
        for dtype in (torch.float32, torch.bfloat16):
            for c in HYB_EPI_CHANNELS:
                args = epi_inputs(n, c, dtype, g, side=128)
                tag = f"{str(dtype)[6:]} N={n} C={c} 128^2"
                check(tag, k1.se_epilogue(*args), k1.se_epilogue_ref(*args), dtype)
                if dtype == torch.bfloat16:
                    t_k = cuda_time(lambda: k1.se_epilogue(*args))
                    t_p = cuda_time(lambda: k1.se_epilogue_ref(*args))
                    bound = 3 * args[0].numel() * 2 / HBM_BYTES_PER_S * 1e3
                    log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                        f"{bound:.4f} ms (bytes) (median)")
                del args
    torch.cuda.empty_cache()


def phase_conv(n):
    log(f"== phase 3b: conv3x3_bn_gelu (CUDA) vs plain, N={n}, random BN running stats")
    g = gen(3)
    errs, ms, plain_ms, lib_ms, flop, devs = [], 0.0, 0.0, 0.0, 0, []
    turns_k = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, cin, cout, side in NECKS:
            x = cl(torch.randn(n, cin, side, side, device=DEV, generator=g).to(dtype))
            w = torch.randn(cout, cin, 3, 3, device=DEV, generator=g) * (9 * cin) ** -0.5
            bias = torch.randn(cout, device=DEV, generator=g) * 0.1
            gamma = torch.rand(cout, device=DEV, generator=g) + 0.5
            beta = torch.randn(cout, device=DEV, generator=g) * 0.1
            mean = torch.randn(cout, device=DEV, generator=g) * 0.1
            var = torch.rand(cout, device=DEV, generator=g) + 0.5
            args = (x, w, bias, gamma, beta, mean, var)
            tag = f"{str(dtype)[6:]} {name} ({side}^2, {cin}->{cout})"
            errs.append(check(tag, k2.conv3x3_bn_gelu(*args), k2.conv3x3_bn_gelu_ref(*args),
                              dtype))
            t_k = cuda_time(lambda: k2.conv3x3_bn_gelu(*args), reps=5)
            t_p = cuda_time(lambda: k2.conv3x3_bn_gelu_ref(*args), reps=5)
            log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median)")
            if dtype == torch.bfloat16:
                ms += t_k
                plain_ms += t_p
                site_flop = 2 * n * side * side * 9 * cin * cout
                flop += site_flop
                bound = site_flop / BF16_FLOP_PER_S * 1e3
                xb, wb = x, w.to(dtype).contiguous(memory_format=torch.channels_last)
                chain = lambda: F.gelu(F.batch_norm(  # noqa: E731
                    F.conv2d(xb, wb, bias.to(dtype), padding=1),
                    mean, var, gamma, beta, False, 0.0, 1e-5))
                t_kt, t_c = in_turns(lambda: k2.conv3x3_bn_gelu(*args), chain, reps=5)
                log(f"  {tag}: in turns kernel {t_kt:.4f} ms, cuDNN bf16 conv+BN+GELU chain "
                    f"{t_c:.4f} ms, ratio {t_kt / t_c:.3f}")
                turns_k += t_kt
                lib_ms += t_c
                devs.append(device_rate(tag, lambda: k2.conv3x3_bn_gelu(*args),
                                        ("conv3x3_bn_gelu_wgmma",), site_flop, bound))
                if cout % 256 == 0:  # the channel tile, chosen by this comparison
                    t256, t128 = in_turns(lambda: k2.conv3x3_bn_gelu(*args, _tile_n=256),
                                          lambda: k2.conv3x3_bn_gelu(*args, _tile_n=128), reps=5)
                    log(f"  {tag}: in turns 128x256 tiles {t256:.4f} ms, 128x128 tiles "
                        f"{t128:.4f} ms (default {k2.tile_n(cout)})")
            del x, w, args
    torch.cuda.empty_cache()
    bound = flop / BF16_FLOP_PER_S * 1e3
    if None in devs:
        device = "device not measured"
    else:
        dev_ms = sum(devs)
        device = (f"device {dev_ms:.4f} ms ({flop / dev_ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * bound / dev_ms:.1f} % of the bound)")
    log(f"  bf16 sum over the six sites: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({flop / 1e9:.1f} GFLOP); {device}; in turns "
        f"kernel {turns_k:.4f} ms vs cuDNN chain {lib_ms:.4f} ms, ratio {turns_k / lib_ms:.3f}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations", "library_ms": lib_ms}


def attn_inputs(bh, dtype, g, n=4):
    return [torch.randn(bh, SEQ, HEAD_DIM, device=DEV, generator=g).to(dtype)
            for _ in range(n)]


def phase_flash_forward():
    log(f"== phase 3c: flash_attention forward (CUDA) vs plain, (B*H, N, D) = "
        f"(32 normal B=8 | 128 tta B=8, {SEQ}, {HEAD_DIM})")
    r = torch.randn(1, 1, 100, HEAD_DIM, device=DEV)
    expect_value_error("unaligned N=100", lambda: fa.flash_attention(r, r, r))
    expect_value_error("fp16", lambda: fa.flash_attention(r.half(), r.half(), r.half()))
    g = gen(6)
    errs, res = [], {}
    # bf16 at D=64 beside D=128: half the products, the same exponentials
    for bh, d, dtype in ((32, HEAD_DIM, torch.float32), (32, HEAD_DIM, torch.bfloat16),
                         (128, HEAD_DIM, torch.float32), (128, HEAD_DIM, torch.bfloat16),
                         (32, 64, torch.bfloat16)):
        scale = d ** -0.5
        q, k, v = (torch.randn(bh, SEQ, d, device=DEV, generator=g).to(dtype) for _ in range(3))
        tag = f"{str(dtype)[6:]} BH={bh} D={d}"
        out, lse = fa.flash_forward(q, k, v, scale)
        ref_out, ref_lse = fa.flash_attention_ref(q, k, v, scale)
        errs.append(check(f"{tag} out", out, ref_out, dtype))
        errs.append(check(f"{tag} lse", lse, ref_lse, dtype))
        del out, lse, ref_out, ref_lse
        t_k = cuda_time(lambda: fa.flash_forward(q, k, v, scale), reps=3, trials=3)
        t_p = cuda_time(lambda: fa.flash_attention_ref(q, k, v, scale), reps=1, trials=3)
        # (B, H, N, D) views: PyTorch's fused backends take 4-D inputs only
        q4, k4, v4 = (t.view(bh // HEADS, HEADS, SEQ, d) for t in (q, k, v))
        t_l = cuda_time(lambda: F.scaled_dot_product_attention(q4, k4, v4), reps=3, trials=3)
        flop = 4 * bh * SEQ * SEQ * d
        bound = flop / BF16_FLOP_PER_S * 1e3
        log(f"  {tag}: kernel {t_k:.4f} ms ({flop / t_k / 1e9:.1f} TFLOP/s), plain "
            f"{t_p:.4f} ms, SDPA {t_l:.4f} ms (median); bf16 bound {bound:.4f} ms "
            f"({flop / 1e12:.3f} TFLOP, {bh * SEQ * SEQ / 1e6:.0f}M exp)")
        if dtype == torch.bfloat16:
            t_kt, t_lt = in_turns(lambda: fa.flash_forward(q, k, v, scale),
                                  lambda: F.scaled_dot_product_attention(q4, k4, v4),
                                  reps=3, trials=3)
            log(f"  {tag}: in turns kernel {t_kt:.4f} ms, SDPA {t_lt:.4f} ms, ratio "
                f"{t_kt / t_lt:.3f}")
            device_rate(tag, lambda: fa.flash_forward(q, k, v, scale), ("flash_fwd_wgmma",),
                        flop, bound)
        res[(bh, d, dtype)] = (t_k, t_p, t_l, bound)
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    t_k, t_p, t_l, bound = res[(32, HEAD_DIM, torch.bfloat16)]
    return {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": "operations", "library_ms": t_l}


def phase_flash_backward():
    bh = 32
    log(f"== phase 3d: flash_attention backward (CUDA dQ, dK/dV) vs autograd through "
        f"the plain version, (B*H, N, D) = ({bh}, {SEQ}, {HEAD_DIM}), seeded cotangent")
    g = gen(7)
    scale = HEAD_DIM ** -0.5
    errs = {"dq": [], "dkv": []}
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = attn_inputs(bh, dtype, g)
        tag = str(dtype)[6:]
        out, lse = fa.flash_forward(q, k, v, scale)
        delta = fa.backward_delta(out, dout)
        dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        ref_out = fa.flash_attention_ref(*leaves, scale)[0]
        ref = torch.autograd.grad(ref_out, leaves, dout, retain_graph=True)
        errs["dq"].append(check_rel(f"{tag} dq", dq, ref[0], dtype))
        errs["dkv"].append(check_rel(f"{tag} dk", dk, ref[1], dtype))
        errs["dkv"].append(check_rel(f"{tag} dv", dv, ref[2], dtype))
        del dq, dk, dv, ref
        t_dq = cuda_time(lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale),
                         reps=3, trials=3)
        t_dkv = cuda_time(lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale),
                          reps=3, trials=3)
        t_pdq = cuda_time(lambda: torch.autograd.grad(ref_out, leaves[0], dout,
                                                      retain_graph=True), reps=1, trials=3)
        t_pdkv = cuda_time(lambda: torch.autograd.grad(ref_out, leaves[1:], dout,
                                                       retain_graph=True), reps=1, trials=3)
        del ref_out
        lib_leaves = [t.detach().clone().view(bh // HEADS, HEADS, SEQ, HEAD_DIM)
                      .requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_leaves)
        lib_dout = dout.view_as(lib_out)
        t_l = cuda_time(lambda: torch.autograd.grad(lib_out, lib_leaves, lib_dout,
                                                    retain_graph=True), reps=3, trials=3)
        b_dq = 6 * bh * SEQ * SEQ * HEAD_DIM / BF16_FLOP_PER_S * 1e3
        b_dkv = 8 * bh * SEQ * SEQ * HEAD_DIM / BF16_FLOP_PER_S * 1e3
        log(f"  {tag}: dQ kernel {t_dq:.4f} ms (plain {t_pdq:.4f}, bf16 bound {b_dq:.4f}); "
            f"dK/dV kernel {t_dkv:.4f} ms (plain {t_pdkv:.4f}, bf16 bound {b_dkv:.4f}); "
            f"SDPA backward (dq, dk, dv in one call) {t_l:.4f} ms (median)")
        res[dtype] = (t_dq, t_pdq, b_dq, t_dkv, t_pdkv, b_dkv, t_l)
        del q, k, v, dout, out, lse, delta, leaves, lib_leaves, lib_out, lib_dout
        torch.cuda.empty_cache()
    t_dq, t_pdq, b_dq, t_dkv, t_pdkv, b_dkv, t_l = res[torch.bfloat16]
    return ({"max_abs_err": max(errs["dq"]), "ms": t_dq, "plain_ms": t_pdq,
             "bound_ms": b_dq, "bound_by": "operations", "library_ms": t_l},
            {"max_abs_err": max(errs["dkv"]), "ms": t_dkv, "plain_ms": t_pdkv,
             "bound_ms": b_dkv, "bound_by": "operations", "library_ms": t_l})


def phase_dwi_norm():
    log(f"== phase 3e: dwi_normalize (Triton) vs plain, (8 served | 256 prepared, "
        f"{IMAGE}, {IMAGE}, 13), raw intensities 10-2010")
    g = gen(8)
    errs, res = [], {}
    for n in (8, 256):
        base = torch.rand(n, IMAGE, IMAGE, 13, device=DEV, generator=g) * 2000.0 + 10.0
        for dtype in (torch.float32, torch.bfloat16):
            img = base.to(dtype)
            # outputs in [0, 1]: fp32 sum order, 1e-6 (a ddof=0 std would be
            # off by ~3.8e-6 at 256^2); bf16 one ulp, 2^-7
            tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
            tag = f"{str(dtype)[6:]} N={n}"
            for flags in ((True, True), (True, False), (False, False)):
                out = dwi_norm.dwi_normalize(img, (-3.0, 3.0), *flags)
                ref = dwi_norm.dwi_normalize_ref(img, (-3.0, 3.0), *flags)
                err = (out.float() - ref.float()).abs().max().item()
                log(f"  {tag} skip_last={flags[0]} zero_last={flags[1]}: max_abs_err "
                    f"{err:.3e} (tolerance {tol:.3e})")
                if not err <= tol:
                    raise AssertionError(f"dwi_normalize {tag} {flags}: error {err} above {tol}")
                if dtype == torch.float32:
                    errs.append(err)
                del out, ref
            t_k = cuda_time(lambda: dwi_norm.dwi_normalize(img, (-3.0, 3.0), True, True))
            t_p = cuda_time(lambda: dwi_norm.dwi_normalize_ref(img, (-3.0, 3.0), True, True),
                            reps=3)
            # least traffic: read the images, write the output, once each
            bound = 2 * img.numel() * img.element_size() / HBM_BYTES_PER_S * 1e3
            log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), bound "
                f"{bound:.4f} ms (bytes, {2 * img.numel() * img.element_size() / 1e6:.1f} MB)")
            dev, host = launch_costs(lambda: dwi_norm.dwi_normalize(img, (-3.0, 3.0), True, True),
                                     ("_partials_kernel", "_merge_kernel", "_normalize_kernel"))
            log(f"  {tag}: device {dev:.4f} ms per call in its 3 kernels (profiler), host "
                f"{host:.4f} ms per call to enqueue them")
            res[(n, dtype)] = (t_k, t_p, bound)
            del img
        del base
        torch.cuda.empty_cache()
    t_k, t_p, bound = res[(8, torch.float32)]  # the served call
    return {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def phase_histogram(dce_norm):
    """``dce_norm``: the max-normalised synthetic DCE volumes on the card."""
    rows = dce_norm.permute(0, 3, 1, 2).reshape(-1, IMAGE * IMAGE).contiguous()
    log(f"== phase 3f: histogram_percentiles (CUDA) vs plain on max-normalised synthetic "
        f"DCE rows, (48 served B=8 | {rows.shape[0]} prepared, {rows.shape[1]}) fp32")
    errs, res = [], {}
    for g_rows in (48, rows.shape[0]):
        flat = rows[:g_rows]
        out = hist.histogram_percentiles(flat, LANDMARKS)
        ref = hist.histogram_percentiles_ref(flat, LANDMARKS)
        span = (flat.max(1).values - flat.min(1).values)[:, None]
        err = (out - ref).abs().max().item()
        err_bins = ((out - ref).abs() / (span / hist.NBINS)).max().item()
        # the same bins and the same in-bin interpolation: within 1e-6 * span
        # (0.004 bins), as the plain version is held to the Pallas kernel;
        # a kernel without the interpolation or a bin off would be ~1 bin out
        tol_bins = 1e-6 * hist.NBINS
        log(f"  G={g_rows}: max_abs_err {err:.3e}, {err_bins:.3e} bins of span/4096 "
            f"(tolerance {tol_bins:.3e} bins = 1e-6 x span)")
        if not err_bins <= tol_bins:
            raise AssertionError(f"histogram_percentiles G={g_rows}: {err_bins} bins apart")
        errs.append(err)
        t_k = cuda_time(lambda: hist.histogram_percentiles(flat, LANDMARKS))
        t_p = cuda_time(lambda: hist.histogram_percentiles_ref(flat, LANDMARKS), reps=3)
        bound = flat.numel() * 4 / HBM_BYTES_PER_S * 1e3  # one read of the rows
        log(f"  G={g_rows}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), bound "
            f"{bound:.4f} ms (bytes, {flat.numel() * 4 / 1e6:.1f} MB)")
        dev, host = launch_costs(lambda: hist.histogram_percentiles(flat, LANDMARKS),
                                 ("histogram_percentiles_kernel",))
        log(f"  G={g_rows}: device {dev:.4f} ms per call (profiler), host {host:.4f} ms "
            f"per call to enqueue it")
        res[g_rows] = (t_k, t_p, bound)
    # the path that carries the kernel: nyul_transform_hist on one B=8 batch,
    # counts set to 0 just before and read just after
    batch = dce_norm[:B_SERVE].contiguous()
    lm = torch.tensor(LANDMARKS, device=DEV)
    scale = torch.linspace(0.0, 1.0, len(LANDMARKS), device=DEV)
    reset_counts()
    via_hist = hist.nyul_transform_hist(batch, LANDMARKS, scale)
    torch.cuda.synchronize()
    launches = counts()["histogram_percentiles"]
    via_fast = nyul_transform_fast(batch, lm, scale)
    diff = (via_hist - via_fast).abs().max().item()
    log(f"  nyul_transform_hist vs nyul_transform_fast (B={B_SERVE}, information only: "
        f"two estimators): max |diff| {diff:.3e}; histogram launches {launches}")
    if launches != 1 or not torch.isfinite(via_hist).all():
        raise AssertionError("nyul_transform_hist did not run through the kernel once")
    t_k, t_p, bound = res[48]
    return {"max_abs_err": max(errs), "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None, "served": False}, launches


def phase_se_scale():
    log("== phase 3g: se_scale (Triton) vs plain SEBlock, (N, side^2, C) = "
        + ", ".join(f"({n}, {s}^2, {c})" for n, s, c in SE_MAPS))
    g = gen(9)
    errs, ms, plain_ms, nbytes = [], 0.0, 0.0, 0
    for n, side, c in SE_MAPS:
        mid = max(c // 2, 1)
        w1 = torch.randn(mid, c, 1, 1, device=DEV, generator=g) * c ** -0.5
        w2 = torch.randn(c, mid, 1, 1, device=DEV, generator=g) * mid ** -0.5
        b1 = torch.randn(mid, device=DEV, generator=g) * 0.1
        b2 = torch.randn(c, device=DEV, generator=g) * 0.1
        base = torch.randn(n, c, side, side, device=DEV, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x = cl(base.to(dtype))
            args = (x, w1, b1, w2, b2)
            tag = f"{str(dtype)[6:]} ({n}, {side}^2, {c})"
            out, s = sek.se_scale(*args)
            ref_out, ref_s = sek.se_scale_ref(*args)
            errs.append(check(f"{tag} out", out, ref_out, dtype))
            errs.append(check(f"{tag} s", s, ref_s, dtype))
            del out, s, ref_out, ref_s
            if dtype == torch.bfloat16:
                t_k = cuda_time(lambda: sek.se_scale(*args))
                t_p = cuda_time(lambda: sek.se_scale_ref(*args))
                b = 2 * x.numel() * x.element_size()
                log(f"  {tag}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), bound "
                    f"{b / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes, {b / 1e6:.1f} MB)")
                dev, host = launch_costs(lambda: sek.se_scale(*args),
                                         ("_pool_partials_kernel", "_mlp_kernel", "_scale_kernel"))
                log(f"  {tag}: device {dev:.4f} ms per call in its 3 kernels (profiler), host "
                    f"{host:.4f} ms per call to enqueue them")
                ms += t_k
                plain_ms += t_p
                nbytes += b
            del x, args
        del base
        torch.cuda.empty_cache()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  bf16 sum over the four calls of a tta_mc request: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


# ------------------------------------------------------------------ phase 4
def card_and_cpu_models(cfg):
    cpu_models = build_fusion_models(cfg, "cpu", torch.float32,
                                     torch.Generator().manual_seed(SEED))
    dev_models = [copy.deepcopy(m).to(DEV).to(memory_format=torch.channels_last)
                  for m in cpu_models]
    return cpu_models, dev_models


def compare_card_cpu(pairs):
    for name, a, b, tol in pairs:
        err = (a.cpu() - b).abs().max().item()
        log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"card-vs-CPU {name} error {err} above {tol}")


def phase_parity(cfg):
    log("== phase 4: end-to-end parity, tta, B=2, fp32: card (kernels) vs CPU (plain)")
    cpu_models, dev_models = card_and_cpu_models(cfg)
    g = torch.Generator().manual_seed(11)
    S = cfg.dwi_model.input_size
    dwi = torch.rand(2, S, S, cfg.dwi_channel_num, generator=g)
    dce = torch.rand(2, S, S, cfg.dce_channel_num, generator=g)
    reset_counts()
    t0 = time.perf_counter()
    mean_d, std_d, aux_d = make_fusion_predictor(cfg, *dev_models, mode="tta")(
        dwi.to(DEV), dce.to(DEV))
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launched = counts()
    t0 = time.perf_counter()
    mean_c, std_c, aux_c = make_fusion_predictor(cfg, *cpu_models, mode="tta")(dwi, dce)
    t_cpu = time.perf_counter() - t0
    log(f"  card {t_dev:.2f} s (launches {launched}), CPU {t_cpu:.2f} s")
    # 3 ResLite SE epilogues x 2 encoders, 6 necks x 2; modality attention x 2
    # and fusion_se: standalone SE
    expect = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 6, "conv3x3_bn_gelu": 12,
                                           "se_scale": 3}
    if launched != expect:
        raise AssertionError(f"tta forward launched {launched}, expected {expect}")
    # ResNet-50 depth in fp32 on two devices: sums in other orders; hold
    # probabilities to 1e-4 absolute and the gate to 1e-4 relative
    compare_card_cpu((("mean", mean_d, mean_c, 1e-4), ("std", std_d, std_c, 1e-4),
                      ("gating_weights", aux_d["gating_weights"],
                       aux_c["gating_weights"], 1e-4)))
    log(f"  mean probs (card) {mean_d.cpu().numpy().round(5).tolist()}")
    del dev_models, cpu_models
    torch.cuda.empty_cache()


# per forward of the hybrid-nb models: 6 transformer blocks x 2 encoders of
# flash attention, 2 SE epilogues (block1, block2) x 2 encoders, no neck
# convs, modality attention x 2 and fusion_se; a served request adds the
# DWI z-score of its preprocessing
HYBRID_EXPECT = dict.fromkeys(COUNTERS, 0) | {"flash_attention_fwd": 12, "se_epilogue": 4,
                                              "se_scale": 3}


def phase_parity_hybrid(hcfg):
    log("== phase 4b: hybrid-nb end-to-end parity, normal, B=1, fp32: card (kernels) "
        "vs CPU (plain)")
    cpu_models, dev_models = card_and_cpu_models(hcfg)
    g = torch.Generator().manual_seed(12)
    S = hcfg.dwi_model.input_size
    dwi = torch.rand(1, S, S, hcfg.dwi_channel_num, generator=g)
    dce = torch.rand(1, S, S, hcfg.dce_channel_num, generator=g)
    reset_counts()
    t0 = time.perf_counter()
    mean_d, _, aux_d = make_fusion_predictor(hcfg, *dev_models, mode="normal")(
        dwi.to(DEV), dce.to(DEV))
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launched = counts()
    t0 = time.perf_counter()
    mean_c, _, aux_c = make_fusion_predictor(hcfg, *cpu_models, mode="normal")(dwi, dce)
    t_cpu = time.perf_counter() - t0
    log(f"  card {t_dev:.2f} s (launches {launched}), CPU {t_cpu:.2f} s")
    if launched != HYBRID_EXPECT:
        raise AssertionError(f"hybrid-nb forward launched {launched}, "
                             f"expected {HYBRID_EXPECT}")
    # 6 transformer blocks in fp32 on two devices, flash (online softmax) on
    # the card vs the materialized softmax on the CPU: 1e-4 absolute
    compare_card_cpu((("mean", mean_d, mean_c, 1e-4),
                      ("gating_weights", aux_d["gating_weights"],
                       aux_c["gating_weights"], 1e-4)))
    log(f"  mean probs (card) {mean_d.cpu().numpy().round(5).tolist()}")
    del dev_models, cpu_models
    torch.cuda.empty_cache()


def synced(fn):
    """``fn()`` and its host seconds, ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_prepare(cfg, raw):
    log(f"== phase 4c: data preparation, card vs CPU: prepare_single_data + "
        f"export_processed_splits, fold 0, {N_TRAIN} + {N_TEST} synthetic volumes of "
        f"{IMAGE}^2, reference_compat={cfg.reference_compat}")
    launches = dict.fromkeys(COUNTERS, 0)
    for method in ("dwi", "dce"):
        store = {"imgs": raw[method], "test_imgs": raw[f"{method}_test"],
                 "labels": raw["labels"], "test_labels": raw["labels_test"],
                 "masks": raw["masks"]}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)  # scratch stores inside the checkout
        with (tempfile.TemporaryDirectory(dir=BUILD_DIR) as d_card,
              tempfile.TemporaryDirectory(dir=BUILD_DIR) as d_cpu):
            c_card, c_cpu = cfg.replace(base_path=d_card), cfg.replace(base_path=d_cpu)
            reset_counts()
            data, t_prep = synced(lambda: prepare_single_data(c_card, method, 0, raw=store,
                                                              device=DEV))
            paths, t_export = synced(lambda: export_processed_splits(c_card, data, gen(31)))
            got = counts()
            log(f"  {method} card: prepare {t_prep:.3f} s, export {t_export:.3f} s, launches "
                + ", ".join(f"{k} {v}" for k, v in got.items() if v))
            expect = dict.fromkeys(COUNTERS, 0) | ({"dwi_normalize": 3} if method == "dwi"
                                                   else {})
            if got != expect:
                raise AssertionError(f"{method} preparation launched {got}, expected {expect}")
            launches = {k: launches[k] + got[k] for k in COUNTERS}
            t0 = time.perf_counter()
            data_c = prepare_single_data(c_cpu, method, 0, raw=store, device="cpu")
            if data_c.nyul is not None:  # the card's estimator: fast, not the CPU's exact one
                data_c.nyul.transform = functools.partial(data_c.nyul.transform, fast=True)
            paths_c = export_processed_splits(c_cpu, data_c, torch.Generator().manual_seed(31))
            log(f"  {method} CPU: prepare + export {time.perf_counter() - t0:.3f} s")
            for split in ("train", "val", "test"):
                a, b = load_processed_split(paths[split]), load_processed_split(paths_c[split])
                if a.keys() != b.keys() or a["imgs"].shape != b["imgs"].shape:
                    raise AssertionError(f"{method} {split}: card and CPU splits differ in form")
                for k in set(a) - {"imgs"}:
                    if not np.array_equal(a[k], b[k]):
                        raise AssertionError(f"{method} {split}: {k} differ")
                imgs = a["imgs"]
                if not np.isfinite(imgs).all() or imgs.min() < 0.0 or imgs.max() > 1.0:
                    raise AssertionError(f"{method} {split}: not finite or outside [0, 1]")
                if split == "train":  # one frozen augmentation: other generators
                    log(f"  {method} train {imgs.shape}: finite, in [0, 1] (card and CPU "
                        f"draw other augmentation streams)")
                    continue
                diff = np.abs(imgs - b["imgs"])
                err = float(diff.max())
                log(f"  {method} {split} {imgs.shape}: card vs CPU max_abs_err {err:.3e} "
                    f"(tolerance 1e-05); by channel {diff.max(axis=(0, 1, 2)).tolist()}")
                if not err <= 1e-5:
                    raise AssertionError(f"{method} {split}: card vs CPU error {err}")
            del data_c
        # stage times on the card, each stage as prepare_single_data and
        # export_processed_splits run it
        splits = data.splits
        if method == "dwi":
            _, t = synced(lambda: prep_dwi_adc_maps(store["imgs"], store["test_imgs"],
                                                    cfg.dwi_bvals_to_use,
                                                    cfg.reference_compat, DEV))
            log(f"  dwi stage ADC maps: {t * 1e3:.2f} ms")
        else:
            _, t = synced(lambda: [dce_global_max_normalize(
                torch.as_tensor(a, device=DEV)).cpu().numpy()
                for a in (store["imgs"], store["test_imgs"])])
            log(f"  dce stage max-normalise (with host-device copies): {t * 1e3:.2f} ms")
            _, t = synced(lambda: NyulStandardizer().fit(splits["train"]["imgs"]))
            log(f"  dce stage Nyul fit (host, numpy): {t * 1e3:.2f} ms")
        procs = data.processors_by_split
        _, t = synced(lambda: procs["train"].train_batch(
            gen(32), splits["train"]["imgs"]).cpu().numpy())
        log(f"  {method} stage train split ({len(splits['train']['imgs'])} volumes, augment + "
            f"normalise): {t * 1e3:.2f} ms")
        n_eval, t_eval = 0, 0.0
        for split in ("val", "test"):
            _, t = synced(lambda: procs[split].eval_split(splits[split]["imgs"]))
            n = len(splits[split]["imgs"])
            log(f"  {method} stage {split} split ({n} volumes, eval_split): {t * 1e3:.2f} ms")
            n_eval, t_eval = n_eval + n, t_eval + t
        log(f"  {method} eval_split: {n_eval / t_eval:.1f} volumes/s (host arrays in and out)")
        del data
    log(f"  launches of the preparation runs: {launches}")
    return launches


# ------------------------------------------------------------------ phase 5
def raw_request(cfg, predict, g_data, g_mc=None):
    """One request: B_SERVE raw NHWC volumes -> preprocessing -> predictor."""
    S = cfg.dwi_model.input_size
    adc_map = torch.full((S, S, 1), 0.5, device=DEV)

    def request():
        """Host seconds of the request; the preprocessing's and the
        predictor's device-stream ms (CUDA events) go to ``split``."""
        dwi_raw = torch.rand(B_SERVE, S, S, cfg.dwi_base_channel_num, device=DEV,
                             generator=g_data) * 1000.0
        dce_raw = torch.rand(B_SERVE, S, S, cfg.dce_channel_num, device=DEV,
                             generator=g_data)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        dx, cx = preprocess_fusion_inputs(dwi_raw, dce_raw, adc_map)
        ev[1].record()
        mean, std, _ = predict(dx, cx, g_mc)
        ev[2].record()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        request.split = (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]))
        return dt, mean, std

    return request


def serve(name, cfg, request, expect, stochastic):
    """Warm-up, then REQUESTS requests with per-request launch counts and the
    correctness gates; the counts are reset just before and read just after."""
    t_warm, _, _ = request()
    log(f"  {name} warm-up request: {t_warm:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lat, pre, pred = [], [], []
    for r in range(REQUESTS):
        before = counts()
        dt, mean, std = request()
        rose = {k: v - before[k] for k, v in counts().items()}
        lat.append(dt)
        pre.append(request.split[0])
        pred.append(request.split[1])
        log(f"  {name} request {r}: {dt * 1e3:.2f} ms, {B_SERVE / dt:.2f} volumes/s "
            f"(preprocessing {request.split[0]:.3f} ms, predictor {request.split[1]:.3f} ms "
            f"by CUDA events), launches " + ", ".join(f"{k} +{v}" for k, v in rose.items() if v))
        if rose != expect:
            raise AssertionError(f"{name} request launched {rose}, expected {expect}")
        if mean.shape != (B_SERVE, cfg.class_num) or not torch.isfinite(mean).all():
            raise AssertionError("probabilities not finite or misshapen")
        if not torch.isfinite(std).all():
            raise AssertionError("std not finite")
        if stochastic and not (std > 0).all():
            raise AssertionError("MC std not strictly positive")
        if (mean.sum(-1) - 1).abs().max().item() > 1e-3:
            raise AssertionError("probabilities do not sum to 1")
    launched = counts()
    med = statistics.median(lat)
    log(f"  {name}: median latency {med * 1e3:.2f} ms, {B_SERVE / med:.2f} volumes/s; "
        f"median preprocessing {statistics.median(pre):.3f} ms, predictor "
        f"{statistics.median(pred):.3f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"  {name} last request mean probs {mean[0].float().cpu().numpy().round(4).tolist()}, "
        f"std {std[0].float().cpu().numpy().round(4).tolist()}")
    return launched


def phase_serve(cfg):
    log(f"== phase 5: serve tta_mc in bf16, {REQUESTS} requests of B={B_SERVE} raw volumes")
    models = build_fusion_models(cfg, DEV, torch.bfloat16, gen(SEED))
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc")
    request = raw_request(cfg, predict, gen(21), gen(22))
    n_suffix = 2  # all lean passes in one chunk (cfg.mc_chunk None) + the full last pass
    # 3 SE epilogues x 2 encoders per suffix; 6 necks x 2; standalone SE:
    # modality attention x 2 in the prefix, fusion_se once per suffix; the
    # DWI z-score once in preprocessing
    expect = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 6 * n_suffix,
                                           "conv3x3_bn_gelu": 12,
                                           "se_scale": 2 + n_suffix, "dwi_normalize": 1}
    log(f"  {cfg.mc_passes} MC passes x 4 views")
    launched = serve("tta_mc", cfg, request, expect, stochastic=True)
    return launched, request


def phase_serve_hybrid(hcfg):
    log(f"== phase 5b: serve hybrid-nb in bf16, normal then tta, {REQUESTS} requests "
        f"of B={B_SERVE} raw volumes each")
    models = build_fusion_models(hcfg, DEV, torch.bfloat16, gen(SEED))
    launched, requests = [], {}
    for mode in ("normal", "tta"):
        predict = make_fusion_predictor(hcfg, *models, mode=mode)
        requests[mode] = raw_request(hcfg, predict, gen(23))
        launched.append(serve(f"hybrid-nb {mode}", hcfg, requests[mode],
                              HYBRID_EXPECT | {"dwi_normalize": 1}, stochastic=False))
    return launched, requests["normal"]


# ------------------------------------------------------------------ phase 6
def phase_profile(name, request):
    log(f"== phase 6: profiler breakdown of one more {name} request (device time by kernel)")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dt, _, _ = request()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events)
    log(f"  {name} request under the profiler {dt * 1e3:.2f} ms; device time "
        f"{total / 1e3:.2f} ms ({100 * (1 - total / 1e3 / (dt * 1e3)):.1f} % idle)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    log("  device time by the host op that launched it:")
    ops = [e for e in prof.key_averages()
           if e.device_type.name == "CPU" and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    log("  host time by op (self CPU time under the profiler):")
    ops = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:10]:
        log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = default_parameters()
    hcfg = hybrid_nb_config(cfg)
    smi = phase_identity()
    phase_build()
    n_views = 4 * B_SERVE
    measured = {"se_epilogue": phase_epilogue(cfg.mc_passes - 1, n_views)}
    phase_epilogue_hybrid()
    measured["conv3x3_bn_gelu"] = phase_conv(n_views)
    measured["flash_attention_fwd"] = phase_flash_forward()
    (measured["flash_attention_bwd_dq"],
     measured["flash_attention_bwd_dkv"]) = phase_flash_backward()
    measured["dwi_normalize"] = phase_dwi_norm()
    t0 = time.perf_counter()
    raw = make_synthetic_arrays(n_train=N_TRAIN, n_test=N_TEST, image_size=IMAGE,
                                mask_size=IMAGE, seed=SEED)
    log(f"== synthetic store: {N_TRAIN} + {N_TEST} volumes of {IMAGE}^2 "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    dce_norm = dce_global_max_normalize(torch.as_tensor(raw["dce"], device=DEV))
    measured["histogram_percentiles"], hist_launches = phase_histogram(dce_norm)
    del dce_norm
    torch.cuda.empty_cache()
    measured["se_scale"] = phase_se_scale()
    phase_parity(cfg)
    phase_parity_hybrid(hcfg)
    prep_launches = phase_prepare(cfg, raw)
    del raw
    # each served path: counts set to 0 just before it and read just after
    tta_mc_launches, request = phase_serve(cfg)
    hybrid_launches, hybrid_request = phase_serve_hybrid(hcfg)
    launches = {k: tta_mc_launches[k] + sum(h[k] for h in hybrid_launches)
                + prep_launches[k] for k in COUNTERS}
    launches["histogram_percentiles"] = hist_launches  # no served path: phase 3f
    log(f"  launches on the served paths and the data preparation: {launches}")
    for name in ("se_epilogue", "conv3x3_bn_gelu", "flash_attention_fwd", "se_scale",
                 "dwi_normalize", "histogram_percentiles"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on its path")
    phase_profile("tta_mc", request)
    phase_profile("hybrid-nb normal", hybrid_request)
    log(f"== total {time.perf_counter() - t_start:.1f} s on {smi}")
    where = {
        "se_epilogue": ("triton", "dmf_tpu_torch/ops/epilogue_triton.py",
                        "dmf_tpu/ops/epilogue_pallas.py:222"),
        "conv3x3_bn_gelu": ("cuda", "dmf_tpu_torch/csrc/conv3x3_bn_gelu.cu",
                            "dmf_tpu/ops/conv3x3_pallas.py:217"),
        "flash_attention_fwd": ("cuda", "dmf_tpu_torch/csrc/flash_attention.cu",
                                "dmf_tpu/ops/flash_attention.py:43"),
        "flash_attention_bwd_dq": ("cuda", "dmf_tpu_torch/csrc/flash_attention.cu",
                                   "dmf_tpu/ops/flash_attention.py:114"),
        "flash_attention_bwd_dkv": ("cuda", "dmf_tpu_torch/csrc/flash_attention.cu",
                                    "dmf_tpu/ops/flash_attention.py:144"),
        "se_scale": ("triton", "dmf_tpu_torch/ops/se_triton.py",
                     "dmf_tpu/ops/se_pallas.py:110"),
        "dwi_normalize": ("triton", "dmf_tpu_torch/ops/dwi_norm_triton.py",
                          "dmf_tpu/ops/preprocess_pallas.py:28"),
        "histogram_percentiles": ("cuda", "dmf_tpu_torch/csrc/histogram_percentiles.cu",
                                  "dmf_tpu/ops/histogram_pallas.py:38"),
    }
    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], **measured[name]}
               for name, (route, source, replaces) in where.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
