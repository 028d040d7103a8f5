"""The eager ``tta_mc`` request and its dropout kernels in two trees, in turns.

    python3 scripts/mc_turns.py OTHER_TREE

OTHER_TREE is another checkout of this repository, for example the parent
commit unpacked by ``git archive`` into the ignored ``dmf_tpu_torch/_build/``.
Each turn is one process on the card, started from a tree's root with this
checkout's ``chip_smoke.py``, copied as ``_chip_smoke_turn.py`` into a
temporary directory of its own, on ``PYTHONPATH`` (so it imports that tree's
``dmf_tpu_torch`` and builds that tree's kernels; nothing is written into
the tree but its own build directory).  A turn builds the kernels
(``chip_smoke.phase_build``), then phase 5's request: the default models at
full width in bf16, ``tta_mc`` at B=8 raw volumes (preprocessing and
predictor), 2 warm-up requests and 10 timed (median host ms, and the
predictor's CUDA-event ms); then kernel 1 at the lean chunk's maps (288 x
32^2 x {128, 256, 512}, bf16, dropout 0.2, through ``se_epilogue`` with a
generator, a route both trees have), summed over C, and the keep-mask kernel
on a (288, 256, 32, 32) bf16 map, by CUDA events.  The turns run other,
this, this, other; the script prints each turn's numbers and the mean of
each tree's two.
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
import json, statistics, torch
import _chip_smoke_turn as c
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
c.phase_identity()
c.phase_build()
cfg = c.default_parameters()
models = c.build_fusion_models(cfg, c.DEV, torch.bfloat16, c.gen(c.SEED))
predict = c.make_fusion_predictor(cfg, *models, mode="tta_mc")
request = c.raw_request(cfg, predict, c.gen(21), c.gen(22))
for _ in range(2):
    request()
lat, pred = [], []
for _ in range(10):
    lat.append(request()[0] * 1e3)
    pred.append(request.split[1])
res = {"request_ms": statistics.median(lat), "predictor_ms": statistics.median(pred)}
del models, predict, request
torch.cuda.empty_cache()
n = (cfg.mc_passes - 1) * 4 * c.B_SERVE
g = c.gen(1)
res["kernel1_ms"] = 0.0
for ch in c.EPI_CHANNELS:
    args = c.epi_inputs(n, ch, torch.bfloat16, g)
    g_mc = c.gen(2)
    res["kernel1_ms"] += c.cuda_time(lambda: c.k1.se_epilogue(*args, drop_rate=0.2,
                                                              generator=g_mc))
    del args
x = c.cl(torch.empty(n, 256, 32, 32, device=c.DEV, dtype=torch.bfloat16))
seed = torch.tensor([5], device=c.DEV)
res["keep_mask_ms"] = c.cuda_time(lambda: c.epilogue_cuda.keep_mask(x, 0.2, seed))
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
