"""Smoke run of the PyTorch port (dmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card identity (nvidia-smi name and power limit, torch/triton versions);
  2. kernel build from the sources in this checkout (the two CUDA libraries
     by nvcc in parallel, then the Triton JIT), with ptxas registers/spills;
  3. each hand-written kernel vs its plain PyTorch version at the served
     paths' shapes, fp32 (TF32 off) and bf16, with errors beside stated
     tolerances and median times beside the plain version's, the bound and
     the one PyTorch call that computes the same function (where there is
     one): 3a SE epilogue (32^2 maps of tta_mc, 128^2 maps of hybrid-nb),
     3b conv3x3+BN+GELU, 3c flash-attention forward, 3d its backward;
  4. end-to-end parity, card (kernels) vs CPU (plain versions), fp32,
     seeded random weights at full width: 4 the default ResNet-50 models in
     ``tta`` at B=2, 4b the hybrid-transformer no-backbone models
     (``hybrid-nb``) in ``normal`` at B=1;
  5. serving raw NHWC volumes -> on-card preprocessing -> predictor in bf16,
     3 requests of B=8 each, with launch counters checked per request: 5 the
     default models in ``tta_mc``, 5b ``hybrid-nb`` in ``normal`` then ``tta``;
  6. a profiler breakdown of one more ``tta_mc`` and one ``hybrid-nb``
     ``normal`` request.
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing anything.
"""

import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmf_tpu_torch import default_parameters, resolve_backbone_config  # noqa: E402
from dmf_tpu_torch.data.preprocess import preprocess_fusion_inputs  # noqa: E402
from dmf_tpu_torch.evals.predict import make_fusion_predictor  # noqa: E402
from dmf_tpu_torch.models import build_fusion_models  # noqa: E402
from dmf_tpu_torch.ops import conv3x3 as k2  # noqa: E402
from dmf_tpu_torch.ops import epilogue as k1  # noqa: E402
from dmf_tpu_torch.ops import epilogue_triton  # noqa: E402
from dmf_tpu_torch.ops import flash_attention as fa  # noqa: E402
from dmf_tpu_torch.ops.cuda_build import BUILD_DIR  # noqa: E402

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
            "flash_attention_bwd_dkv": (fa.flash_attention, "launches_dkv")}


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
    libs = {"conv3x3_bn_gelu": k2._library, "flash_attention": fa._library}
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, together
        for f in [pool.submit(build) for build in libs.values()]:
            f.result()
    log(f"  conv3x3_bn_gelu + flash_attention (nvcc, sm_90a, in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        for p in sorted(BUILD_DIR.glob(f"{name}-*/build.log")):
            kernel = ""
            for line in p.read_text().splitlines():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1][-60:]
                elif "registers" in line or "spill" in line:
                    log(f"  ptxas {name} {kernel}: {line.strip()}")
    t0 = time.perf_counter()
    x = cl(torch.randn(2, 128, 8, 8, device=DEV))
    w1, w2 = torch.randn(64, 128, device=DEV), torch.randn(128, 64, device=DEV)
    b1, b2 = torch.zeros(64, device=DEV), torch.zeros(128, device=DEV)
    for drop in (0.0, 0.2):
        k1.se_epilogue(x, x, w1, b1, w2, b2, drop_rate=drop, generator=gen())
    torch.cuda.synchronize()
    log(f"  se_epilogue (Triton JIT, fp32): {time.perf_counter() - t0:.2f} s")


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
    errs, ms, plain_ms, lib_ms, flop = [], 0.0, 0.0, 0.0, 0
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
                xb, wb = x, w.to(dtype).contiguous(memory_format=torch.channels_last)
                t_c = cuda_time(lambda: torch.nn.functional.gelu(
                    torch.nn.functional.batch_norm(
                        torch.nn.functional.conv2d(xb, wb, bias.to(dtype), padding=1),
                        mean, var, gamma, beta, False, 0.0, 1e-5)), reps=5)
                log(f"  {tag}: cuDNN bf16 conv+BN+GELU chain {t_c:.4f} ms (for reference)")
                lib_ms += t_c
                flop += 2 * n * side * side * 9 * cin * cout
            del x, w, args
    torch.cuda.empty_cache()
    bound = flop / BF16_FLOP_PER_S * 1e3
    log(f"  bf16 sum over the six sites: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"cuDNN chain {lib_ms:.4f} ms, bound {bound:.4f} ms ({flop / 1e9:.1f} GFLOP)")
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
    scale = HEAD_DIM ** -0.5
    errs, res = [], {}
    for bh in (32, 128):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(bh, dtype, g, 3)
            tag = f"{str(dtype)[6:]} BH={bh}"
            out, lse = fa.flash_forward(q, k, v, scale)
            ref_out, ref_lse = fa.flash_attention_ref(q, k, v, scale)
            errs.append(check(f"{tag} out", out, ref_out, dtype))
            errs.append(check(f"{tag} lse", lse, ref_lse, dtype))
            del out, lse, ref_out, ref_lse
            t_k = cuda_time(lambda: fa.flash_forward(q, k, v, scale), reps=3, trials=3)
            t_p = cuda_time(lambda: fa.flash_attention_ref(q, k, v, scale), reps=1, trials=3)
            # (B, H, N, D) views: PyTorch's fused backends take 4-D inputs only
            q4, k4, v4 = (t.view(bh // HEADS, HEADS, SEQ, HEAD_DIM) for t in (q, k, v))
            t_l = cuda_time(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                            reps=3, trials=3)
            flop = 4 * bh * SEQ * SEQ * HEAD_DIM
            bound = flop / BF16_FLOP_PER_S * 1e3
            log(f"  {tag}: kernel {t_k:.4f} ms ({flop / t_k / 1e9:.1f} TFLOP/s), plain "
                f"{t_p:.4f} ms, SDPA {t_l:.4f} ms (median); bf16 bound {bound:.4f} ms "
                f"({flop / 1e12:.3f} TFLOP, {bh * SEQ * SEQ / 1e6:.0f}M exp)")
            res[(bh, dtype)] = (t_k, t_p, t_l, bound)
            del q, k, v, q4, k4, v4
            torch.cuda.empty_cache()
    t_k, t_p, t_l, bound = res[(32, torch.bfloat16)]
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
    expect = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 6, "conv3x3_bn_gelu": 12}
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


# per request of the hybrid-nb path: 6 transformer blocks x 2 encoders of
# flash attention, 2 SE blocks (block1, block2) x 2 encoders, no neck convs
HYBRID_EXPECT = dict.fromkeys(COUNTERS, 0) | {"flash_attention_fwd": 12, "se_epilogue": 4}


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


# ------------------------------------------------------------------ phase 5
def raw_request(cfg, predict, g_data, g_mc=None):
    """One request: B_SERVE raw NHWC volumes -> preprocessing -> predictor."""
    S = cfg.dwi_model.input_size
    adc_map = torch.full((S, S, 1), 0.5, device=DEV)

    def request():
        dwi_raw = torch.rand(B_SERVE, S, S, cfg.dwi_base_channel_num, device=DEV,
                             generator=g_data) * 1000.0
        dce_raw = torch.rand(B_SERVE, S, S, cfg.dce_channel_num, device=DEV,
                             generator=g_data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dx, cx = preprocess_fusion_inputs(dwi_raw, dce_raw, adc_map)
        mean, std, _ = predict(dx, cx, g_mc)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, mean, std

    return request


def serve(name, cfg, request, expect, stochastic):
    """Warm-up, then REQUESTS requests with per-request launch counts and the
    correctness gates; the counts are reset just before and read just after."""
    t_warm, _, _ = request()
    log(f"  {name} warm-up request: {t_warm:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lat = []
    for r in range(REQUESTS):
        before = counts()
        dt, mean, std = request()
        rose = {k: v - before[k] for k, v in counts().items()}
        lat.append(dt)
        log(f"  {name} request {r}: {dt * 1e3:.2f} ms, {B_SERVE / dt:.2f} volumes/s, "
            f"launches " + ", ".join(f"{k} +{v}" for k, v in rose.items() if v))
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
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"  {name} last request mean probs {mean[0].float().cpu().numpy().round(4).tolist()}, "
        f"std {std[0].float().cpu().numpy().round(4).tolist()}")
    return launched


def phase_serve(cfg):
    log(f"== phase 5: serve tta_mc in bf16, {REQUESTS} requests of B={B_SERVE} raw volumes")
    models = build_fusion_models(cfg, DEV, torch.bfloat16, gen(SEED))
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc")
    request = raw_request(cfg, predict, gen(21), gen(22))
    n_suffix = 2  # all lean passes in one chunk (cfg.mc_chunk None) + the full last pass
    # 3 SE blocks x 2 encoders per suffix; 6 necks x 2
    expect = dict.fromkeys(COUNTERS, 0) | {"se_epilogue": 6 * n_suffix,
                                           "conv3x3_bn_gelu": 12}
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
        launched.append(serve(f"hybrid-nb {mode}", hcfg, requests[mode], HYBRID_EXPECT,
                              stochastic=False))
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
    phase_parity(cfg)
    phase_parity_hybrid(hcfg)
    # each served path: counts set to 0 just before it and read just after
    tta_mc_launches, request = phase_serve(cfg)
    hybrid_launches, hybrid_request = phase_serve_hybrid(hcfg)
    launches = {k: tta_mc_launches[k] + sum(h[k] for h in hybrid_launches)
                for k in COUNTERS}
    log(f"  launches on the served paths: {launches}")
    for name in ("se_epilogue", "conv3x3_bn_gelu", "flash_attention_fwd"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on its served path")
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
