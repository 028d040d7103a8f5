"""The int8 serving path's convs and requests in two trees, in turns.

    python3 scripts/int8_turns.py OTHER_TREE

OTHER_TREE is another checkout of this repository, for example the parent
commit unpacked by ``git archive`` into the ignored ``dmf_tpu_torch/_build/``.
Each turn is one process on the card, started from a tree's root with this
checkout's ``chip_smoke.py``, copied as ``_chip_smoke_turn.py`` into a
temporary directory of its own, on ``PYTHONPATH`` (so it imports that tree's
``dmf_tpu_torch`` and builds that tree's kernels; nothing is written into
the tree but its own build directory).  A turn builds phase 12's models (the
default config at full width, QuantSets from the fp32 weights, bf16 copies
calibrated with MC dropout), finds the quantized convs of an int8 ``tta_mc``
request at B=8 (``chip_smoke.conv_sites``) and times, by CUDA events, each
distinct shape's ``QuantConv2d`` forward on a bf16 map (the static route: a
quantize and the int8 conv), the int8 conv on an int8 map, the static
quantize alone and the dynamic route's ``quant._dynamic_quantize`` (a name
both trees have, whatever kernels are behind it), each summed over the
request's calls; then 12c's int8 (static scales), int8 with dynamic scales
(the same QuantSets without their static scales) and fp ``tta_mc`` requests
of B=8 raw volumes, in turns, 5 each (median ms).
The turns run other, this, this, other; the script prints each turn's
numbers and the mean of each tree's two.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = "_chip_smoke_turn.py"

TURN = r"""
import copy, json, statistics, torch
import _chip_smoke_turn as c
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
c.phase_identity()
cfg = c.default_parameters()
weights = c.build_fusion_models(cfg, c.DEV, torch.float32, c.gen(c.SEED))
models = [copy.deepcopy(m).to(torch.bfloat16) for m in weights]
S = cfg.dwi_model.input_size


def volumes(g, b):
    return c.preprocess_fusion_inputs(
        torch.rand(b, S, S, cfg.dwi_base_channel_num, device=c.DEV, generator=g) * 1000.0,
        torch.rand(b, S, S, cfg.dce_channel_num, device=c.DEV, generator=g),
        torch.full((S, S, 1), 0.5, device=c.DEV))


_, qsets = c.int8q.make_quantized_fusion_apply(
    *models, calibration=volumes(c.gen(81), c.INT8_CALIB), calibration_mc=True,
    calibration_rng=c.gen(82), weights=weights)
del weights
qfwd = c.int8q.make_quantized_fusion_fwd(*models, qsets)
pred = c.make_fusion_predictor(cfg, *models, mode="tta_mc", fwd_override=qfwd)
dx, cx = volumes(c.gen(83), c.B_SERVE)
sites, mods = c.conv_sites(pred, dx, cx, c.gen(84), qfwd.modules.values())
res = dict.fromkeys(("static_route_ms", "int8_conv_ms", "quantize_ms", "dynamic_quantize_ms"),
                    0.0)
g = c.gen(91)
for key, calls in sites.items():
    n, ch, h, w, o, kh, kw, s, p, d = key
    m = mods[key]
    xb = c.cl((torch.randn(n, ch, h, w, device=c.DEV, generator=g) * (60.0 * m.x_scale))
              .to(torch.bfloat16))
    xq = c.int8_cuda.launch_quantize(xb, m.x_scale, False)
    with torch.no_grad():
        res["static_route_ms"] += c.cuda_time(lambda: m(xb)) * calls
    res["int8_conv_ms"] += c.cuda_time(lambda: c.int8_cuda.launch_int8_conv(
        xq, m.weight_q, m.w_scale, m.x_scale, m.bias, s, p, d, torch.bfloat16)) * calls
    res["quantize_ms"] += c.cuda_time(
        lambda: c.int8_cuda.launch_quantize(xb, m.x_scale, False)) * calls
    with torch.no_grad():
        res["dynamic_quantize_ms"] += c.cuda_time(lambda: c.int8q._dynamic_quantize(xb)) * calls
dfwd = c.int8q.make_quantized_fusion_fwd(*models, {
    k: {name: {kk: v for kk, v in e.items() if kk != "x_scale"} for name, e in qs.items()}
    for k, qs in qsets.items()})
preds = {"int8": pred,
         "int8_dynamic": c.make_fusion_predictor(cfg, *models, mode="tta_mc", fwd_override=dfwd),
         "fp": c.make_fusion_predictor(cfg, *models, mode="tta_mc")}
for p_ in preds.values():  # warm-up
    c.int8_request(cfg, p_, 99)()
lat = {k: [] for k in preds}
for r in range(c.INT8_REQUESTS):
    for name, p_ in preds.items():
        lat[name].append(c.int8_request(cfg, p_, 200 + r)()[0] * 1e3)
res.update({f"{k}_request_ms": statistics.median(v) for k, v in lat.items()})
res["convs_a_request"] = sum(sites.values())
print("TURN " + json.dumps(res), flush=True)
"""


def turn(tree):
    with tempfile.TemporaryDirectory() as probe_dir:
        shutil.copy(os.path.join(HERE, "chip_smoke.py"), os.path.join(probe_dir, PROBE))
        # the probe's directory holds no dmf_tpu_torch: the tree's ('' on
        # sys.path under -c) is the one imported
        env = dict(os.environ, PYTHONPATH=probe_dir)
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
        raise SystemExit(f"turn in {tree} failed ({proc.returncode})")
    return json.loads(next(line for line in proc.stdout.splitlines()
                           if line.startswith("TURN "))[5:])


def main():
    other = os.path.abspath(sys.argv[1])
    trees = {"other": other, "this": HERE}
    got = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        print(f"== turn: {name} ({trees[name]})", flush=True)
        got[name].append(turn(trees[name]))
    means = {name: {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
             for name, runs in got.items()}
    print("TURNS " + json.dumps({"runs": got, "means": means}), flush=True)


if __name__ == "__main__":
    main()
