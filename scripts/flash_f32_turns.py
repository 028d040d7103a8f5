"""The fp32 flash kernels, a hybrid-nb validation batch and the fp32 stage
backward in two trees, in turns.

    python3 scripts/flash_f32_turns.py OTHER_TREE

OTHER_TREE is another checkout of this repository, for example the parent
commit unpacked by ``git archive`` into the ignored ``dmf_tpu_torch/_build/``.
Each turn is one process on the card, started from a tree's root with this
checkout's ``chip_smoke.py``, copied as ``_chip_smoke_turn.py`` into a
temporary directory of its own, on ``PYTHONPATH`` (so it imports that tree's
``dmf_tpu_torch`` and builds that tree's kernels; nothing is written into
the tree but its own build directory): the fp32 forward ``flash_forward``
and the fp32 backward pair ``flash_bwd_dq`` + ``flash_bwd_dkv`` at (32 |
128, 4096, 128) by CUDA events, ``chip_smoke.phase_hybrid_validation`` (the
full-width hybrid-nb DWI model's validation batch at B=32, fp32, TF32 off:
its peak memory, its time by CUDA events, one profiled batch's device time,
and its logits against the CPU's) and ``chip_smoke.phase_stage_backward``
in fp32 (the full-width hybrid-nb transformer stage: its gradients against
an fp32 plain-route copy at B=2, then its backward at B=8 by CUDA events
with its peak memory and one profiled backward).  The turns run other,
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
import json, torch
import _chip_smoke_turn as c
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
c.phase_identity()
res = {}
g = c.gen(6)
scale = c.HEAD_DIM ** -0.5
for bh in (32, 128):
    q, k, v, dout = (torch.randn(bh, c.SEQ, c.HEAD_DIM, device=c.DEV, generator=g)
                     for _ in range(4))
    res[f"fwd_f32_bh{bh}_ms"] = c.cuda_time(
        lambda: c.fa.flash_forward(q, k, v, scale), reps=3, trials=3)
    out, lse = c.fa.flash_forward(q, k, v, scale)
    delta = c.fa.backward_delta(out, dout)
    res[f"dq_f32_bh{bh}_ms"] = c.cuda_time(
        lambda: c.fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale), reps=3, trials=3)
    res[f"dkv_f32_bh{bh}_ms"] = c.cuda_time(
        lambda: c.fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale), reps=3, trials=3)
    del q, k, v, dout, out, lse, delta
    torch.cuda.empty_cache()
hcfg = c.hybrid_nb_config(c.default_parameters())
launched, times = c.phase_hybrid_validation(hcfg)
res.update(times)
stage = c.phase_stage_backward(hcfg, dtypes=(torch.float32,))[1][torch.float32]
res.update({f"stage_f32_{k}": t for k, t in stage.items()})
print("TURN " + json.dumps(res), flush=True)
"""


def turn(tree):
    with tempfile.TemporaryDirectory() as probe_dir:
        shutil.copy(os.path.join(HERE, "chip_smoke.py"), os.path.join(probe_dir, PROBE))
        # the probe's directory holds no dmf_tpu_torch: the tree's ('' on
        # sys.path under -c) is the one imported
        env = dict(os.environ, PYTHONPATH=probe_dir)
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=tree, env=env,
                              capture_output=True, text=True, timeout=1200)
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
