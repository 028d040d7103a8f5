"""Command line of the port, counterpart of ``dmf_tpu/cli.py`` (the
reference's run.py:121-180 as a real CLI).

Usage:
    python -m dmf_tpu_torch.cli run            # every fold x method on the card
    python -m dmf_tpu_torch.cli run --folds 0 --methods dwi --epochs 5
    python -m dmf_tpu_torch.cli run --fusion \\
        --pretrained-dwi radimagenet_resnet50.pt --pretrained-dce radimagenet_resnet50.pt
    python -m dmf_tpu_torch.cli run --tiny --device cpu --folds 0 --epochs 2
    python -m dmf_tpu_torch.cli debug-suite --fusion
    python -m dmf_tpu_torch.cli export-ckpt --method fusion \\
        --checkpoint results/fusion/fold_0/checkpoints/best.pt --out fold0.ckpt
    python -m dmf_tpu_torch.cli export-serving --mode tta_mc --batch 8 \\
        --checkpoint results/fusion/fold_0/checkpoints/best.pt --out tta_mc_b8.pt2
    python -m dmf_tpu_torch bench --quick --device cpu

The subcommands take the JAX CLI's arguments, plus ``--device`` (default
``cuda``; ``cpu`` only when asked, never as a fallback).  ``run
--parallel-folds`` over several folds trains each modality's folds in one
call (``run_single_model_multifold``), then runs fusion per fold; over one
fold it runs the per-fold loop, as the JAX CLI does (cli.py:157).
``--mesh DATA[xMODEL]`` trains and tests over a mesh of DATA x MODEL ranks,
one process a rank (``python -m torch.distributed.run --nproc-per-node
DATA*MODEL -m dmf_tpu_torch.cli run --mesh DATAxMODEL ...``: NCCL with a
card a rank, gloo with ``--device cpu``); the model axis shards the models
(``parallel/sharding.py``); global rank 0 prints and writes.  ``export-serving``
writes the weights-free ``torch.export`` serving program (``serving.py``) on
``--device``, in place of the JAX CLI's ``--platforms``.  ``bench`` runs
``python -m dmf_tpu_torch.bench`` (``bench.py``'s counterpart, every mode:
``python -m dmf_tpu_torch.bench --help``) in a subprocess with ``--quick``
and ``--device``, as the JAX CLI runs ``bench.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch


def _add_common(p):
    p.add_argument("--config", default=None, help="path to a config JSON")
    p.add_argument("--ref-params", default=None,
                   help="path to the reference's saved parameters dict "
                        "(parameters/parameters.pth, or a JSON dump of the "
                        "same layout); builds the Config via "
                        "from_reference_dict")
    p.add_argument("--base-path", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--min-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--folds", type=int, nargs="*", default=None)
    p.add_argument("--methods", nargs="*", default=None)
    p.add_argument("--fusion", action="store_true",
                   help="run the fusion stage after both encoders "
                        "(the reference's run.py ships it commented out, "
                        "run.py:164-180)")
    p.add_argument("--no-compat", action="store_true",
                   help="disable reference_compat quirks")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--pretrained-dwi", default=None,
                   help="local checkpoint for the DWI backbone, per backbone_str: "
                        "a ResNet-50 (timm, resnet50d or RadImageNet layout) or a "
                        "ViT-B/16 (timm vit_base_patch16_224 or DINO ViT-B/16 "
                        "layout, its position embedding resized to input_size)")
    p.add_argument("--pretrained-dce", default=None,
                   help="the same for the DCE backbone")
    p.add_argument("--debug-training", action="store_true")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly (the reference's "
                        "detect_anomaly, train.py:88)")
    p.add_argument("--tiny", action="store_true",
                   help="shrink the models/geometry for smoke runs "
                        "(CPU-friendly)")
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="device mesh, e.g. '2' (2-way data parallel: launch 2 "
                        "processes with python -m torch.distributed.run "
                        "--nproc-per-node 2) or '2x2' (a 2-way model axis "
                        "too: 4 processes)")
    p.add_argument("--parallel-folds", action="store_true",
                   help="train each modality's folds in one call (one raw "
                        "load and one model build; each fold's results equal "
                        "its sequential run's), then fusion per fold; over "
                        "one fold it runs the per-fold loop")
    p.add_argument("--mc-chunk", type=int, default=None,
                   help="run the MC uncertainty passes in sequential chunks "
                        "of this size (bounds activation memory; the same "
                        "masks and ensemble at any chunking: each pass "
                        "draws from its own pass word; evals/predict.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device the run uses (default cuda; cpu only "
                        "when asked)")


def _device(args) -> torch.device:
    """The requested device; a CUDA one must exist (no fallback to the CPU)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def _load_reference_params(path: str):
    """Build a Config straight from the reference's saved ``parameters``
    artifact: the torch-pickled dict ``parameters_generate.py`` writes to
    ``parameters/parameters.pth`` (parameters_generate.py:303), or a JSON
    dump of the same layout."""
    from .config import from_reference_dict

    if path.endswith(".json"):
        with open(path) as f:
            return from_reference_dict(json.load(f))
    try:
        d = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # the dict holds only python scalars/tuples, but older torch saves
        # may need full unpickling (the user's own artifact)
        d = torch.load(path, map_location="cpu", weights_only=False)
    return from_reference_dict(d)


def load_config(args):
    from .config import Config, default_parameters

    if args.ref_params:
        cfg = _load_reference_params(args.ref_params)
    elif args.config:
        cfg = Config.load(args.config)
    else:
        cfg = default_parameters()
    updates = {}
    if args.base_path:
        updates["base_path"] = args.base_path
    if args.batch_size:
        updates["batch_size"] = args.batch_size
    if args.no_compat:
        updates["reference_compat"] = False
    if args.debug_nans:
        updates["debug_anomaly"] = True
    if args.mc_chunk:
        updates["mc_chunk"] = args.mc_chunk
    if args.mesh:
        part = args.mesh.lower().split("x")
        n_data = int(part[0])
        n_model = int(part[1]) if len(part) > 1 else 1
        updates["parallel"] = dataclasses.replace(cfg.parallel, mesh_shape=(n_data, n_model))
    if args.tiny:
        def shrink(mc):
            return dataclasses.replace(
                mc, channels=(8, 16, 32), input_size=32, use_backbone=False,
                proj_dim=8, transformer_embed_dim=32, transformer_depth=1,
                transformer_heads=2,
            )

        fs = dataclasses.replace(
            cfg.fusion_model.fusion_specific, fusion_channels=16,
            dwi_out_channels=32, dce_out_channels=32,
        )
        updates["dwi_model"] = shrink(cfg.dwi_model)
        updates["dce_model"] = shrink(cfg.dce_model)
        updates["fusion_model"] = dataclasses.replace(
            shrink(cfg.fusion_model), fusion_specific=fs
        )
        updates.setdefault("batch_size", args.batch_size or 8)
    if updates:
        cfg = cfg.replace(**updates)
    return cfg


def cmd_run(args) -> int:
    cfg = load_config(args)
    device = _device(args)
    from .parallel.mesh import mesh_from_config

    # the runs build the same mesh; built here first, so that a mesh that
    # cannot form fails before any work
    mesh = mesh_from_config(cfg, device)
    if mesh is not None:
        device = mesh.device
    # rank 0 alone prints
    say = print if mesh is None or mesh.writer else (lambda *a, **k: None)
    if cfg.debug_anomaly:
        torch.autograd.set_detect_anomaly(True)

    folds = args.folds if args.folds is not None else list(range(cfg.segnum))
    methods = args.methods if args.methods else list(cfg.methods)

    from .pipeline.run_fusion import run_fusion_model
    from .pipeline.run_single import run_single_model, run_single_model_multifold

    def debug_suite(method):
        if args.debug_training:
            from .debug_suite import run_debug_suite_single

            run_debug_suite_single(cfg, method, device=device)

    def pretrained(method):
        return args.pretrained_dwi if method == "dwi" else args.pretrained_dce

    parallel = args.parallel_folds and len(folds) > 1
    per_method = {}
    if parallel:
        # every fold of a modality in one call; fusion, which chains each
        # fold's encoder results, then runs per fold
        for method in methods:
            debug_suite(method)
            say(f"[dmf_tpu_torch] folds {folds} method {method}: fold-parallel "
                  f"training...")
            per_method[method] = run_single_model_multifold(
                cfg, method, folds, num_epochs=args.epochs, min_epochs=args.min_epochs,
                base_dir=args.results_dir, pretrained_path=pretrained(method), device=device)

    summary = {}
    for fold in folds:
        results = {}
        for method in methods:
            if parallel:
                results[method] = per_method[method][fold]
            else:
                debug_suite(method)
                say(f"[dmf_tpu_torch] fold {fold} method {method}: training...")
                results[method] = run_single_model(
                    cfg, method, fold,
                    num_epochs=args.epochs, min_epochs=args.min_epochs,
                    base_dir=args.results_dir, pretrained_path=pretrained(method),
                    device=device,
                )
            say(f"[dmf_tpu_torch] fold {fold} {method} test:",
                  json.dumps(results[method]["test_metrics"], indent=None))
        if args.fusion and "dwi" in results and "dce" in results:
            say(f"[dmf_tpu_torch] fold {fold} fusion: training...")
            fusion_res = run_fusion_model(
                cfg, fold, results["dwi"], results["dce"],
                num_epochs=args.epochs, min_epochs=args.min_epochs,
                base_dir=args.results_dir,
            )
            say(f"[dmf_tpu_torch] fold {fold} fusion test:",
                  json.dumps(fusion_res["test_metrics"], indent=None))
            summary[f"fold{fold}_fusion"] = fusion_res["test_metrics"]
        for m, r in results.items():
            summary[f"fold{fold}_{m}"] = r["test_metrics"]
    say(json.dumps(summary, indent=2))
    return 0


def cmd_debug_suite(args) -> int:
    cfg = load_config(args)
    device = _device(args)
    from .debug_suite import run_debug_suite_fusion, run_debug_suite_single

    methods = args.methods if args.methods else list(cfg.methods)
    ok = True
    for method in methods:
        ok = run_debug_suite_single(cfg, method, device=device) and ok
    if args.fusion:
        ok = run_debug_suite_fusion(cfg, device=device) and ok
    return 0 if ok else 1


def cmd_bench(args) -> int:
    """The default bench (``bench.py``'s counterpart) in a subprocess, as the
    JAX CLI runs ``bench.py`` (cli.py:240-245); its exit code."""
    import os
    import subprocess

    cmd = [sys.executable, "-m", "dmf_tpu_torch.bench", "--device", args.device]
    if args.quick:
        cmd.append("--quick")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    return subprocess.call(cmd, env=dict(os.environ, PYTHONPATH=path))


def cmd_export_ckpt(args) -> int:
    """Reverse migration: a checkpoint of the port -> reference Lightning
    ckpt(s) the genuine torch modules load with ``strict=True``
    (models/weights.py).

    ``--method dwi|dce`` exports one encoder from its ``best.pt``/``last.pt``;
    ``--method fusion`` takes the fusion run's ``best.pt`` and writes
    ``<stem>_{dwi,dce,fusion}.ckpt``.  The config flags
    (``--config``/``--tiny``/...) must describe the geometry the checkpoint
    was trained with.
    """
    cfg = load_config(args)
    device = _device(args)
    from .models.weights import (export_reference_encoder, export_reference_fusion,
                                 save_lightning_ckpt)
    from .pipeline.prepare_single import build_single_model
    from .train.state import TrainState
    from .utils.checkpoint import load_checkpoint

    if args.method in ("dwi", "dce"):
        model, _ = build_single_model(cfg, args.method, device=device)
        state = load_checkpoint(args.checkpoint, TrainState.create(model))
        sd = export_reference_encoder(state.model)
        save_lightning_ckpt(args.out, sd)
        print(f"[dmf_tpu_torch] wrote {args.out} ({len(sd)} tensors)")
        return 0

    # fusion: the fusion network holds the dwi/dce encoders and the head
    from .pipeline.run_fusion import build_fusion_state

    dwi_model, _ = build_single_model(cfg, "dwi", device=device)
    dce_model, _ = build_single_model(cfg, "dce", device=device)
    state = build_fusion_state(cfg, TrainState.create(dwi_model),
                               TrainState.create(dce_model))
    net = load_checkpoint(args.checkpoint, state).model
    stem = args.out[:-len(".ckpt")] if args.out.endswith(".ckpt") else args.out
    exporters = {"dwi": export_reference_encoder,
                 "dce": export_reference_encoder,
                 "fusion": export_reference_fusion}
    for name, export in exporters.items():
        sd = export(getattr(net, name))
        path = f"{stem}_{name}.ckpt"
        save_lightning_ckpt(path, sd)
        print(f"[dmf_tpu_torch] wrote {path} ({len(sd)} tensors)")
    return 0


def cmd_export_serving(args) -> int:
    """Write the fusion serving program as a ``torch.export`` artifact
    (``serving.py``) traced on ``--device`` at ``--batch``, in fp32 as the
    fusion run's checkpoint holds the weights: it runs without the model
    code, and the weights ride as arguments (ship the checkpoint beside it;
    ``serving.checkpoint_variables`` reads it).  ``--checkpoint`` (a fusion
    run's ``best.pt``) gives the traced weights, else seeded random ones of
    the configured geometry.
    """
    cfg = load_config(args)
    device = _device(args)
    from .pipeline.prepare_single import build_single_model
    from .pipeline.run_fusion import build_fusion_state
    from .serving import export_serving, make_serving_fn, serving_variables
    from .train.state import TrainState
    from .utils.checkpoint import load_checkpoint

    dwi_model, _ = build_single_model(cfg, "dwi", device=device)
    dce_model, _ = build_single_model(cfg, "dce", device=device)
    state = build_fusion_state(cfg, TrainState.create(dwi_model),
                               TrainState.create(dce_model))
    if args.checkpoint:
        state = load_checkpoint(args.checkpoint, state)
    net = state.model
    models = (net.dwi, net.dce, net.fusion)
    fn = make_serving_fn(cfg, *models, mode=args.mode, mc_chunk=cfg.mc_chunk)
    B, S = args.batch, cfg.dwi_model.input_size
    example = (serving_variables(*models),
               torch.zeros((B, S, S, cfg.dwi_channel_num), device=device),
               torch.zeros((B, S, S, cfg.dce_channel_num), device=device),
               torch.zeros((), dtype=torch.int64, device=device))
    data = export_serving(fn, example, path=args.out)
    print(f"[dmf_tpu_torch] wrote {args.out} ({len(data)} bytes, mode={args.mode}, "
          f"batch={B}, device={device})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dmf_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="train per-fold x per-method (+fusion)")
    _add_common(p_run)

    p_dbg = sub.add_parser("debug-suite", help="pre-training smoke harness")
    _add_common(p_dbg)

    p_bench = sub.add_parser("bench", help="fusion inference benchmark")
    p_bench.add_argument("--quick", action="store_true")
    p_bench.add_argument("--device", default="cuda",
                         help="torch device the bench uses (default cuda; cpu only when "
                              "asked)")

    p_exp = sub.add_parser(
        "export-ckpt",
        help="export a trained checkpoint of the port to reference Lightning "
             ".ckpt(s) the genuine torch modules load strict",
    )
    _add_common(p_exp)
    p_exp.add_argument("--method", required=True,
                       choices=["dwi", "dce", "fusion"])
    p_exp.add_argument("--checkpoint", required=True,
                       help="a checkpoint of the port (best.pt / last.pt; a "
                            "reference .ckpt also works for single encoders, "
                            "which round-trips it through the loader)")
    p_exp.add_argument("--out", required=True)

    p_srv = sub.add_parser(
        "export-serving",
        help="write the fusion serving program as a weights-free torch.export "
             "artifact that runs without the model code (serving.py)")
    _add_common(p_srv)
    p_srv.add_argument("--checkpoint", default=None,
                       help="a fusion run's checkpoint (best.pt) to trace with (the "
                            "weights still ride as arguments at serving time)")
    p_srv.add_argument("--out", required=True)
    p_srv.add_argument("--mode", default="normal",
                       choices=["normal", "tta", "mc", "tta_mc"])
    p_srv.add_argument("--batch", type=int, default=32,
                       help="served batch size (fixed shapes; export one artifact "
                            "per batch size)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    commands = {"run": cmd_run, "debug-suite": cmd_debug_suite, "bench": cmd_bench,
                "export-ckpt": cmd_export_ckpt, "export-serving": cmd_export_serving}
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
