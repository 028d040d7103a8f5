"""Serving artifacts: the fusion serving program as a weights-free ``torch.export`` program.

Counterpart of ``dmf_tpu/serving.py`` (``make_serving_fn`` :38,
``export_serving`` :87, ``load_serving`` :128).  ``torch.export`` traces the
serving function into an ``ExportedProgram`` that ``torch.export.save``
writes and ``torch.export.load`` reads back in a process WITHOUT the model
code: build once, ship the artifact beside a checkpoint, serve from a
process that imports ``torch`` and ``dmf_tpu_torch.ops.library`` (which
registers the hand-written kernels' operators) and nothing else.

Design, as in JAX:

* Weights are ARGUMENTS, not constants: the artifact holds no parameter or
  buffer, and one artifact serves every checkpoint of its geometry.  The
  models run under ``torch.func.functional_call`` on the state dicts passed
  in.
* The signature is uniform across modes:
  ``(variables, dwi_x, dce_x, seed) -> (mean, std)``, with ``variables``
  ``{"dwi", "dce", "fusion"}`` state dicts, ``dwi_x``/``dce_x`` preprocessed
  NHWC batches, ``seed`` an int64 scalar tensor in ``[0, 2^32)`` on the
  inputs' device, and ``std = 0`` in the deterministic modes.
* Shapes are fixed: export one artifact per served batch size.
* MC dropout takes the seed route (``ops/dropout.py``): every keep mask is
  Philox4x32-10 of the seed, the pass and a counter fixed at trace time, so
  the same seed gives the same masks, the same bits on the CPU and on the
  card, and the eager predictor's masks for that seed at any ``mc_chunk``.

There is no ``platforms`` / ``allow_tpu_kernels`` counterpart.  An artifact
exported on the card holds the kernels' operators and runs them there; the
loading process registers them by importing ``dmf_tpu_torch.ops.library``,
so it needs the same package version (the same-fleet case of
``dmf_tpu/serving.py:96-111``), and it builds the kernels from the sources on
its first request.  An artifact exported on the CPU holds the same
operators, whose CPU implementations are the plain versions.
"""

from __future__ import annotations

import io
from typing import Callable, Dict, Optional, Sequence

import torch

MODES = ("normal", "tta", "mc", "tta_mc")


class _Program(torch.nn.Module):
    """The three models (registered, for ``functional_call``) and the
    predictor that runs them."""

    def __init__(self, dwi_model, dce_model, fusion_model, run: Callable,
                 extra: Optional[Dict[str, torch.nn.Module]] = None):
        super().__init__()
        self.dwi, self.dce, self.fusion = dwi_model, dce_model, fusion_model
        for name, m in (extra or {}).items():
            self.add_module(name, m)
        self._run = run

    def forward(self, dwi_x, dce_x, seed):
        return self._run(dwi_x, dce_x, seed)


def make_serving_fn(cfg, dwi_model, dce_model, fusion_model, mode: str = "normal",
                    mc_chunk: Optional[int] = None,
                    fwd_override: Optional[Callable] = None) -> Callable:
    """The uniform serving function ``(variables, dwi_x, dce_x, seed) ->
    (mean, std)`` over preprocessed inputs; ``mode`` selects plain softmax
    inference or the TTA / MC uncertainty ensemble (``evals/predict.py``),
    ``mc_chunk`` its MC chunking.  ``fwd_override`` plugs in the int8 forward
    (``ops/quant.py``: ``make_quantized_fusion_fwd`` or the int8-prefix
    ``make_hybrid_fusion_fwd``) in any mode.  Its quantized copies become
    modules of the program, so ``variables`` then also holds their state
    dicts (the int8 weights, scales and calibrated ``x_scale`` values) under the
    names of ``fwd_override.modules`` (:func:`serving_variables` with the
    same override): unlike JAX's, whose forward closes over the QuantSets,
    the artifact holds no tensor."""
    if mode not in MODES:
        raise ValueError(f"Unknown serving mode: {mode}")
    from .evals.predict import make_fusion_predictor

    predictor = make_fusion_predictor(cfg, dwi_model, dce_model, fusion_model, mode=mode,
                                      mc_chunk=mc_chunk, fwd_override=fwd_override)
    stochastic = mode in ("mc", "tta_mc")

    def run(dwi_x, dce_x, seed):
        mean, std, _ = predictor(dwi_x, dce_x, seed if stochastic else None)
        return mean, std

    program = _Program(dwi_model, dce_model, fusion_model, run,
                       fwd_override.modules if fwd_override is not None else None)

    def fn(variables: Dict[str, Dict[str, torch.Tensor]], dwi_x, dce_x, seed):
        flat = {f"{m}.{k}": v for m, sd in variables.items() for k, v in sd.items()}
        return torch.func.functional_call(program, flat, (dwi_x, dce_x, seed), strict=True)

    return fn


def serving_variables(dwi_model, dce_model, fusion_model,
                      fwd_override=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The models' state dicts (detached), as the serving function takes them;
    with ``fwd_override`` also those of its quantized copies."""
    named = [("dwi", dwi_model), ("dce", dce_model), ("fusion", fusion_model)]
    if fwd_override is not None:
        named += list(fwd_override.modules.items())
    return {name: {k: v.detach() for k, v in m.state_dict().items()} for name, m in named}


def checkpoint_variables(path: str, device="cuda",
                         dtype: Optional[torch.dtype] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """The serving function's ``variables`` from a fusion run's checkpoint
    (``best.pt``: the fusion network's ``dwi.*`` / ``dce.*`` / ``fusion.*``
    weights), on ``device``, floating tensors cast to ``dtype`` when given.
    Reads the file with ``torch`` alone, as a serving process does."""
    sd = torch.load(path, map_location=device, weights_only=True)["model"]
    out: Dict[str, Dict[str, torch.Tensor]] = {"dwi": {}, "dce": {}, "fusion": {}}
    for key, t in sd.items():
        name, rest = key.split(".", 1)
        out[name][rest] = t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return out


class _Exportable(torch.nn.Module):
    """A module around ``fn`` that holds no parameter: the weights stay
    arguments of the exported program."""

    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, variables, dwi_x, dce_x, seed):
        return self._fn(variables, dwi_x, dce_x, seed)


def export_program(fn: Callable, example_args: Sequence) -> torch.export.ExportedProgram:
    """Trace ``fn`` at ``example_args`` (fixed shapes, dtypes and device)
    into an ``ExportedProgram``; raises if it holds a parameter, a buffer or
    a tensor constant."""
    with torch.no_grad():
        ep = torch.export.export(_Exportable(fn), tuple(example_args))
    ep.example_inputs = None  # else saved with the program: the weights among them
    held = list(ep.state_dict) + list(ep.constants)
    if held:
        raise RuntimeError(f"the serving program holds tensors: {held[:5]}")
    return ep


def export_serving(fn: Callable, example_args: Sequence, path: Optional[str] = None) -> bytes:
    """Trace ``fn`` at ``example_args`` and serialize the program
    (``torch.export.save``); writes it to ``path`` too when given.

    The trace runs on the device of ``example_args``: inputs on the card
    give a program of the card's kernels (export one artifact per served
    batch size).  Returns the artifact's bytes.
    """
    buf = io.BytesIO()
    torch.export.save(export_program(fn, example_args), buf)
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def load_serving(path_or_bytes) -> Callable:
    """Deserialize an artifact into a callable ``(variables, dwi_x, dce_x,
    seed) -> (mean, std)``.

    Needs only ``torch`` and the kernels' operators
    (``dmf_tpu_torch.ops.library``), none of the model code.  The callable
    takes exactly the structure and shapes it was exported with, on the
    device it was exported on.
    """
    from .ops import library  # noqa: F401  (registers the operators)

    src = (io.BytesIO(bytes(path_or_bytes)) if isinstance(path_or_bytes, (bytes, bytearray))
           else path_or_bytes)
    return torch.export.load(src).module()


def operator_nodes(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """The number of nodes of each kernel operator in an exported program's graph."""
    from .ops.library import NAMESPACE, OPERATORS

    found = dict.fromkeys(OPERATORS, 0)
    for node in program.graph.nodes:
        target = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and target.startswith(f"{NAMESPACE}::"):
            found[target.split("::")[1].split(".")[0]] += 1
    return found
