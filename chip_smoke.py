"""Smoke run of the PyTorch port (dmf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card identity (nvidia-smi name and power limit, torch/triton versions);
  2. kernel build from the sources in this checkout (CUDA via nvcc, Triton JIT);
  3. each hand-written kernel vs its plain PyTorch version at the main path's
     shapes, fp32 (TF32 off) and bf16, with errors beside stated tolerances
     and median times beside the plain version's; dropout mask checks;
  4. end-to-end parity: full-width models on seeded random weights, ``tta``
     mode, B=2, fp32, card (kernels) vs CPU (plain versions);
  5. serving: raw NHWC volumes -> on-card preprocessing -> ``tta_mc`` in bf16,
     3 requests of B=8, with launch counters checked per request;
  6. a profiler breakdown of one more request.
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits non-zero before printing anything.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmf_tpu_torch import default_parameters  # noqa: E402
from dmf_tpu_torch.data.preprocess import preprocess_fusion_inputs  # noqa: E402
from dmf_tpu_torch.evals.predict import make_fusion_predictor  # noqa: E402
from dmf_tpu_torch.models import build_fusion_models  # noqa: E402
from dmf_tpu_torch.ops import conv3x3 as k2  # noqa: E402
from dmf_tpu_torch.ops import epilogue as k1  # noqa: E402
from dmf_tpu_torch.ops import epilogue_triton  # noqa: E402
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


def cl(t):
    return t.contiguous(memory_format=torch.channels_last)


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
    t0 = time.perf_counter()
    k2._library()
    log(f"  conv3x3_bn_gelu (nvcc, sm_90a): {time.perf_counter() - t0:.2f} s")
    for p in sorted(BUILD_DIR.glob("conv3x3_bn_gelu-*/build.log")):
        for line in p.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
    t0 = time.perf_counter()
    x = cl(torch.randn(2, 128, 8, 8, device=DEV))
    w1, w2 = torch.randn(64, 128, device=DEV), torch.randn(128, 64, device=DEV)
    b1, b2 = torch.zeros(64, device=DEV), torch.zeros(128, device=DEV)
    for drop in (0.0, 0.2):
        k1.se_epilogue(x, x, w1, b1, w2, b2, drop_rate=drop, generator=gen())
    torch.cuda.synchronize()
    log(f"  se_epilogue (Triton JIT, fp32): {time.perf_counter() - t0:.2f} s")


# ------------------------------------------------------------------ phase 3
def epi_inputs(n, c, dtype, g):
    x = cl(torch.randn(n, c, 32, 32, device=DEV, generator=g).to(dtype))
    idn = cl(torch.randn(n, c, 32, 32, device=DEV, generator=g).to(dtype))
    w1 = torch.randn(c // 2, c, device=DEV, generator=g) * c ** -0.5
    w2 = torch.randn(c, c // 2, device=DEV, generator=g) * (c / 2) ** -0.5
    b1 = torch.randn(c // 2, device=DEV, generator=g) * 0.1
    b2 = torch.randn(c, device=DEV, generator=g) * 0.1
    return x, idn, w1, b1, w2, b2


def phase_epilogue(n_passes, n_views):
    n_lean = n_passes * n_views
    log(f"== phase 3a: se_epilogue (Triton) vs plain, N={n_passes}x{n_views} maps of 32x32xC")
    g = gen(1)
    errs, ms, plain_ms = [], 0.0, 0.0
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
            del args, out, keep, rows
    torch.cuda.empty_cache()
    return max(errs), ms, plain_ms


def phase_conv(n):
    log(f"== phase 3b: conv3x3_bn_gelu (CUDA) vs plain, N={n}, random BN running stats")
    g = gen(3)
    errs, ms, plain_ms = [], 0.0, 0.0
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
            del x, w, args
    torch.cuda.empty_cache()
    return max(errs), ms, plain_ms


# ------------------------------------------------------------------ phase 4
def phase_parity(cfg):
    log("== phase 4: end-to-end parity, tta, B=2, fp32: card (kernels) vs CPU (plain)")
    cpu_models = build_fusion_models(cfg, "cpu", torch.float32,
                                     torch.Generator().manual_seed(SEED))
    dev_models = []
    for m in cpu_models:
        m2 = copy.deepcopy(m).to(DEV)
        dev_models.append(m2.to(memory_format=torch.channels_last))
    g = torch.Generator().manual_seed(11)
    S = cfg.dwi_model.input_size
    dwi = torch.rand(2, S, S, cfg.dwi_channel_num, generator=g)
    dce = torch.rand(2, S, S, cfg.dce_channel_num, generator=g)
    k1.se_epilogue.launches = k2.conv3x3_bn_gelu.launches = 0
    t0 = time.perf_counter()
    mean_d, std_d, aux_d = make_fusion_predictor(cfg, *dev_models, mode="tta")(
        dwi.to(DEV), dce.to(DEV))
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launched = (k1.se_epilogue.launches, k2.conv3x3_bn_gelu.launches)
    t0 = time.perf_counter()
    mean_c, std_c, aux_c = make_fusion_predictor(cfg, *cpu_models, mode="tta")(dwi, dce)
    t_cpu = time.perf_counter() - t0
    log(f"  card {t_dev:.2f} s (launches se_epilogue={launched[0]}, "
        f"conv3x3_bn_gelu={launched[1]}), CPU {t_cpu:.2f} s")
    if launched != (6, 12):
        raise AssertionError(f"tta forward launched {launched}, expected (6, 12)")
    # ResNet-50 depth in fp32 on two devices: sums in other orders; hold
    # probabilities to 1e-4 absolute and the gate to 1e-4 relative
    for name, a, b, tol in (("mean", mean_d, mean_c, 1e-4), ("std", std_d, std_c, 1e-4),
                            ("gating_weights", aux_d["gating_weights"],
                             aux_c["gating_weights"], 1e-4)):
        err = (a.cpu() - b).abs().max().item()
        log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"card-vs-CPU {name} error {err} above {tol}")
    log(f"  mean probs (card) {mean_d.cpu().numpy().round(5).tolist()}")
    del dev_models, cpu_models
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 5
def phase_serve(cfg):
    log(f"== phase 5: serve tta_mc in bf16, {REQUESTS} requests of B={B_SERVE} raw volumes")
    models = build_fusion_models(cfg, DEV, torch.bfloat16, gen(SEED))
    predict = make_fusion_predictor(cfg, *models, mode="tta_mc")
    S = cfg.dwi_model.input_size
    adc_map = torch.full((S, S, 1), 0.5, device=DEV)
    g_data = gen(21)
    g_mc = gen(22)

    def request():
        dwi_raw = torch.rand(B_SERVE, S, S, cfg.dwi_base_channel_num, device=DEV,
                             generator=g_data) * 1000.0
        dce_raw = torch.rand(B_SERVE, S, S, cfg.dce_channel_num, device=DEV,
                             generator=g_data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dx, cx = preprocess_fusion_inputs(dwi_raw, dce_raw, adc_map)
        mean, std, aux = predict(dx, cx, g_mc)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, mean, std

    t_warm, _, _ = request()
    log(f"  warm-up request: {t_warm:.3f} s")
    passes = cfg.mc_passes
    n_suffix = 2  # all lean passes in one chunk (cfg.mc_chunk None) + the full last pass
    expect = (6 * n_suffix, 12)  # 3 SE blocks x 2 encoders per suffix; 6 necks x 2
    torch.cuda.reset_peak_memory_stats()
    k1.se_epilogue.launches = k2.conv3x3_bn_gelu.launches = 0
    lat = []
    for r in range(REQUESTS):
        before = (k1.se_epilogue.launches, k2.conv3x3_bn_gelu.launches)
        dt, mean, std = request()
        rose = (k1.se_epilogue.launches - before[0], k2.conv3x3_bn_gelu.launches - before[1])
        lat.append(dt)
        log(f"  request {r}: {dt * 1e3:.2f} ms, {B_SERVE / dt:.2f} volumes/s, "
            f"launches se_epilogue +{rose[0]}, conv3x3_bn_gelu +{rose[1]}")
        if rose != expect:
            raise AssertionError(f"request launched {rose}, expected {expect}")
        if mean.shape != (B_SERVE, cfg.class_num) or not torch.isfinite(mean).all():
            raise AssertionError("probabilities not finite or misshapen")
        if not torch.isfinite(std).all() or not (std > 0).all():
            raise AssertionError("MC std not strictly positive")
        if (mean.sum(-1) - 1).abs().max().item() > 1e-3:
            raise AssertionError("probabilities do not sum to 1")
    launches = (k1.se_epilogue.launches, k2.conv3x3_bn_gelu.launches)
    med = statistics.median(lat)
    log(f"  {passes} MC passes x 4 views; median latency {med * 1e3:.2f} ms, "
        f"{B_SERVE / med:.2f} volumes/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"  last request mean probs {mean[0].float().cpu().numpy().round(4).tolist()}, "
        f"std {std[0].float().cpu().numpy().round(4).tolist()}")
    return launches, request


# ------------------------------------------------------------------ phase 6
def phase_profile(request):
    log("== phase 6: profiler breakdown of one more request (device time by kernel)")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dt, _, _ = request()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events)
    log(f"  request under the profiler {dt * 1e3:.2f} ms; device time {total / 1e3:.2f} ms")
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
    smi = phase_identity()
    phase_build()
    n_views = 4 * B_SERVE
    e1, ms1, pms1 = phase_epilogue(cfg.mc_passes - 1, n_views)
    e2, ms2, pms2 = phase_conv(n_views)
    phase_parity(cfg)
    launches, request = phase_serve(cfg)
    phase_profile(request)
    log(f"== total {time.perf_counter() - t_start:.1f} s on {smi}")
    kernels = [
        {"name": "se_epilogue", "route": "triton",
         "source": "dmf_tpu_torch/ops/epilogue_triton.py",
         "replaces": "dmf_tpu/ops/epilogue_pallas.py:222",
         "launches": launches[0], "max_abs_err": e1, "ms": ms1, "plain_ms": pms1},
        {"name": "conv3x3_bn_gelu", "route": "cuda",
         "source": "dmf_tpu_torch/csrc/conv3x3_bn_gelu.cu",
         "replaces": "dmf_tpu/ops/conv3x3_pallas.py:217",
         "launches": launches[1], "max_abs_err": e2, "ms": ms2, "plain_ms": pms2},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
