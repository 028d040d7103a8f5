"""Uncertainty-aware inference: TTA, MC dropout and TTA x MC, for the fusion
model and for one single-modality encoder.

Counterpart of ``dmf_tpu/evals/predict.py`` (:31-92, :186-383).  Semantics:

* TTA views: identity, lr-flip, ud-flip, both, folded into the batch;
* MC mode: BatchNorm on running statistics, dropout on (``mc=True``);
* mean and unbiased std over the stacked (pass x view) axis.

The MC passes are a batch dimension: the deterministic prefix (modality SE,
backbone, adapter) runs once and is repeated along the batch for the
suffix.  ``mc_chunk`` passes go through the suffix together (default: all);
passes 0..P-2 are lean (probabilities only) and the last pass, P-1, runs in
full and supplies ``aux``.  The MC modes take one request seed, an int64
Philox key: drawn from the caller's ``torch.Generator``, or given as a seed
tensor (the exported serving program's argument, ``serving.py``).  Every
chunk runs on a :class:`~..ops.dropout.SeedStream` of that seed over its
passes, so each pass draws its masks from its own pass word, as JAX's
predictor draws each pass from its own key (``dmf_tpu/evals/predict.py:349``):
``mc_chunk`` is a memory setting and leaves the masks, and so the ensemble,
unchanged; one seed gives the same masks on the CPU and on the card.  The
public function keeps the JAX layout: NHWC volumes
in, ``(mean, std, aux)`` out, with aux maps returned NHWC.  A pass is a
:class:`PassForward`; ``fwd_override`` swaps in another (the int8 forwards of
``ops/quant.py``), as JAX's ``make_fusion_predictor(fwd_override=)``.

``mesh=`` (``parallel/mesh.py``) serves each request data parallel, the
counterpart of JAX's ``_shard_map_predictor`` (:95-172): every data rank
runs the single-process predictor on its rows of the batch (its kernels
included), and the ``(mean, std, aux)`` are gathered back into the unsharded
layout, the ``(views x B, ...)`` aux leaves view by view.  With more than
one data rank each data rank draws its request seed from a generator of its
own, seeded from a draw of the caller's generator and the rank, as JAX folds
the shard index into its key: each sample's ensemble is a correct MC-dropout
sample whose masks differ from one process's; with one data rank the seed is
the one process draws.
Over a model axis (JAX's GSPMD route, :175-183) the models are sharded in
place by ``parallel/sharding.py::param_spec`` (``parallel/tensor.py``) and
the model ranks of each data rank run its rows together, with the same
masks (a dropout on a shard keeps that shard of the whole mask).  The int8
forwards serve there too, built from the sharded models (their quantized
copies hold :class:`~..ops.quant.ShardedQuantConv2d` shards): the models are
sharded before they are quantized, and a forward that holds a whole int8
conv that the model axis would shard is refused.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..config import Config


def tta_views(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (4B, H, W, C): id, flip W, flip H, flip both."""
    return torch.cat([x, x.flip(2), x.flip(1), x.flip(1, 2)], dim=0)


def _std(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.std(dim=dim, unbiased=True)


def to_model(x: torch.Tensor, like: torch.nn.Module) -> torch.Tensor:
    """NHWC volume (tensor or numpy) -> NCHW map on the model's device in its
    dtype (channels_last on CUDA)."""
    p = next(like.parameters())
    x = torch.as_tensor(x, device=p.device, dtype=p.dtype).permute(0, 3, 1, 2)
    if x.is_cuda:
        return x.contiguous(memory_format=torch.channels_last)
    return x.contiguous()


def _to_nhwc(tree):
    if isinstance(tree, dict):
        return {k: _to_nhwc(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_nhwc(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() == 4:
        return tree.permute(0, 2, 3, 1)
    return tree


def _repeat_prefix(pre, k: int):
    """Repeat an encoder prefix along the batch for ``k`` fused passes (the
    raw input only when there is no backbone: otherwise the suffix starts
    from the adapter's features)."""
    x_in, mod_attn_map, bb = pre

    def rep(t):  # cat keeps the memory format (channels_last on the card)
        return torch.cat([t] * k)

    if bb is None:
        return rep(x_in), mod_attn_map, None
    return None, mod_attn_map, tuple(rep(t) for t in bb)


class PassForward:
    """One pass of the fusion forward: ``fwd(xs, mc, generator, prefixes,
    lean) -> (logits, aux)`` over the encoders ``encoders`` and the head
    ``fusion``, and ``fwd.compute_prefixes(xs)``, the hoisted deterministic
    prefix of each encoder on ``prefix_encoders``.

    The fp predictor's is ``PassForward((dwi, dce), (dwi, dce), fusion)``;
    ``make_fusion_predictor(fwd_override=...)`` takes another, the JAX
    package's ``fusion_fwd`` with its ``compute_prefixes`` (predict.py:263-300):
    ``ops/quant.py``'s int8 forward and its int8-prefix hybrid.  ``modules``
    names the models the forward holds beside the fp three (the serving
    program registers them, so their tensors ride as arguments).
    """

    def __init__(self, prefix_encoders: Sequence[torch.nn.Module],
                 encoders: Sequence[torch.nn.Module], fusion: torch.nn.Module,
                 modules: Optional[Dict[str, torch.nn.Module]] = None):
        self.prefix_encoders = tuple(prefix_encoders)
        self.encoders = tuple(encoders)
        self.fusion = fusion
        self.modules = dict(modules or {})

    def __call__(self, xs, mc: bool = False, generator=None, prefixes=None,
                 lean: bool = False):
        prefixes = prefixes if prefixes is not None else (None,) * len(self.encoders)
        (_, dwi_aux, dwi_mask), (_, dce_aux, dce_mask) = (
            m(x, mc=mc, generator=generator, prefix=p, lean=lean)
            for m, x, p in zip(self.encoders, xs, prefixes))
        logits, _, aux = self.fusion(dwi_aux["raw_feats"], dce_aux["raw_feats"],
                                     dwi_mask, dce_mask, lean=lean)
        return logits, aux

    def compute_prefixes(self, xs):
        return tuple(m(x, prefix_only=True) for m, x in zip(self.prefix_encoders, xs))


def request_seed(generator, device) -> torch.Tensor:
    """The MC request's Philox key on ``device``: one int64 drawn from a
    ``torch.Generator`` (on its own device, then moved), or the int64 seed
    tensor given in its place."""
    from ..ops.epilogue_cuda import draw_seed

    if isinstance(generator, torch.Generator):
        return draw_seed(generator, generator.device).to(device)
    if (not isinstance(generator, torch.Tensor) or generator.dtype != torch.int64
            or generator.numel() != 1):
        raise TypeError("an MC predictor takes a torch.Generator or one int64 seed tensor, "
                        f"got {type(generator).__name__}")
    return generator.to(device)


def _ensemble(encoders, fwd: Callable, prefix: Callable, mode: str, passes: int,
              mc_chunk: Optional[int]) -> Callable:
    """``run(imgs, generator) -> (mean, std, aux)`` over ``encoders`` (one
    NHWC batch each; they set each input's device and dtype), with
    ``fwd(xs, mc, generator, prefixes, lean) -> (logits, aux)`` a pass and
    ``prefix(xs)`` the encoders' hoisted prefixes.  In the MC modes every
    pass's dropout draws from a :class:`~..ops.dropout.SeedStream` of the
    request seed (:func:`request_seed`) and its pass index, whatever the
    chunk it runs in."""
    from ..ops.dropout import SeedStream

    def inputs(imgs, views):
        return [to_model(tta_views(x) if views else x, m) for x, m in zip(imgs, encoders)]

    @torch.no_grad()
    def run(imgs, generator: Optional[torch.Generator]):
        B = imgs[0].shape[0]
        none = (None,) * len(encoders)
        if mode == "normal":
            logits, aux = fwd(inputs(imgs, False))
            probs = torch.softmax(logits.float(), dim=-1)
            return probs, torch.zeros_like(probs), _to_nhwc(aux)
        if mode == "tta":
            logits, aux = fwd(inputs(imgs, True))
            probs = torch.softmax(logits.float(), dim=-1).reshape(4, B, -1)
            return probs.mean(0), _std(probs, 0), _to_nhwc(aux)
        if mode in ("mc", "tta_mc"):
            if generator is None:
                raise ValueError(f"mode {mode!r} needs a generator")
            # the prefix holds no dropout: run it once for every pass
            xs = inputs(imgs, mode == "tta_mc")
            seed = request_seed(generator, xs[0].device)
            pre = prefix(xs)
            n_lean = passes - 1
            chunk = max(1, n_lean if mc_chunk is None else min(mc_chunk, n_lean))
            probs = []
            for start in range(0, n_lean, chunk):
                k = min(chunk, n_lean - start)
                pre_k = tuple(_repeat_prefix(p, k) for p in pre)
                stream = SeedStream(seed, first_pass=start, passes=k)
                logits, _ = fwd(none, mc=True, generator=stream, prefixes=pre_k, lean=True)
                probs.append(torch.softmax(logits.float(), dim=-1))
            logits, aux = fwd(none, mc=True, generator=SeedStream(seed, first_pass=n_lean),
                              prefixes=pre)
            probs.append(torch.softmax(logits.float(), dim=-1))
            probs = torch.cat(probs).reshape(passes * (probs[-1].shape[0] // B), B, -1)
            return probs.mean(0), _std(probs, 0), _to_nhwc(aux)
        raise ValueError(f"Unknown predict mode: {mode}")

    return run


def _rank_generator(generator, mesh) -> Optional[torch.Generator]:
    """This data rank's MC generator, from which the predictor draws the
    rank's request seed: seeded from one draw of the caller's ``generator``
    (which every rank advances alike) and the data rank, so the model ranks
    of a data rank draw the same seed; the caller's own where the data axis
    has one rank."""
    if generator is None or mesh.n_data == 1:
        return generator
    if not isinstance(generator, torch.Generator):
        raise TypeError("a mesh predictor draws its masks from a torch.Generator, got "
                        f"{type(generator).__name__}")
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    return torch.Generator(generator.device).manual_seed(
        (seed * mesh.n_data + mesh.rank) % 2 ** 63)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _mesh_predictor(run: Callable, mesh, n_views: int) -> Callable:
    """``run(imgs, generator)`` served over the mesh: this data rank's rows
    of each input, its own generator, the outputs gathered back over the
    data axis (a rank without rows runs the first row and gathers none)."""

    def predict(imgs, generator):
        B = imgs[0].shape[0]
        rows = mesh.rows(B)
        n = rows.stop - rows.start
        local = [torch.as_tensor(x)[rows if n else slice(0, 1)] for x in imgs]
        mean, std, aux = run(local, _rank_generator(generator, mesh))
        nl = mean.shape[0]

        def gather(a):
            if not isinstance(a, torch.Tensor) or a.dim() == 0:
                return a  # the same on every rank
            if n_views > 1 and a.shape[0] == n_views * nl:
                a = a.reshape(n_views, nl, *a.shape[1:])
                return mesh.gather_rows(a[:, :n], B, dim=1).reshape(n_views * B, *a.shape[2:])
            if a.shape[0] == nl:
                return mesh.gather_rows(a[:n], B)
            return a

        return gather(mean), gather(std), _map_tree(gather, aux)

    return predict


def _views(mode: str) -> int:
    return 4 if mode in ("tta", "tta_mc") else 1


def _place(models, mesh, fwd: Optional[PassForward] = None) -> None:
    """Shard ``models`` in place over ``mesh``'s model axis (identical whole
    weights on every rank; layers already sharded stay).  ``fwd``'s models
    are not sharded here: a whole :class:`~..ops.quant.QuantConv2d` that
    ``param_spec`` would shard (by its name and whole weight shape) raises,
    as it would run unsharded on every rank."""
    if mesh is None or mesh.n_model == 1:
        return
    from ..ops.quant import QuantConv2d, ShardedQuantConv2d
    from ..parallel.sharding import param_spec
    from ..parallel.tensor import tensor_parallel

    held = () if fwd is None else (*fwd.prefix_encoders, *fwd.encoders, fwd.fusion,
                                   *fwd.modules.values())
    for model in {id(m): m for m in held}.values():
        for name, m in model.named_modules():
            if isinstance(m, QuantConv2d) and not isinstance(m, ShardedQuantConv2d):
                shape = (m.out_channels, m.in_channels, *m.kernel_size)
                if param_spec(f"{name}.weight", torch.empty(shape, device="meta"),
                              mesh.n_model) is not None:
                    raise ValueError(
                        f"fwd_override holds a whole int8 conv {name} {shape} that the "
                        f"{mesh.n_model}-way model axis shards: shard the models first "
                        f"(parallel/tensor.py::tensor_parallel), then quantize them")
    for m in models:
        tensor_parallel(m, mesh)


def make_fusion_predictor(cfg: Config, dwi_model, dce_model, fusion_model,
                          mode: Optional[str] = None,
                          mc_passes: Optional[int] = None,
                          mc_chunk: Optional[int] = None,
                          fwd_override: Optional[PassForward] = None,
                          mesh=None) -> Callable:
    """Returns ``predict(dwi_imgs, dce_imgs, generator=None) -> (mean, std, aux)``.

    ``dwi_imgs``/``dce_imgs`` are NHWC.  ``generator`` (a
    ``torch.Generator``, or one int64 seed tensor) gives the request seed of
    every dropout draw and is required in ``mc``/``tta_mc``.
    ``mc_chunk`` defaults to ``cfg.mc_chunk``.  ``fwd_override`` (a
    :class:`PassForward`, e.g. ``ops/quant.py``'s ``make_quantized_fusion_fwd``
    or ``make_hybrid_fusion_fwd``) replaces the per-pass forward and the
    hoisted prefix.  ``mesh`` serves each request over a mesh (the
    module's docstring; over a model axis the models are sharded in place,
    and an int8 ``fwd_override`` must be built from the sharded models);
    every rank passes the whole batch and the same generator state.
    """
    if fwd_override is not None and not isinstance(fwd_override, PassForward):
        raise TypeError(f"fwd_override must be a PassForward (ops/quant.py's int8 forwards "
                        f"make one), got {type(fwd_override).__name__}")
    _place((dwi_model, dce_model, fusion_model), mesh, fwd_override)
    fwd = fwd_override or PassForward((dwi_model, dce_model), (dwi_model, dce_model),
                                      fusion_model)
    mode = mode or cfg.test_mode
    run = _ensemble((dwi_model, dce_model), fwd, fwd.compute_prefixes, mode,
                    mc_passes if mc_passes is not None else cfg.mc_passes,
                    cfg.mc_chunk if mc_chunk is None else mc_chunk)
    if mesh is not None:
        run = _mesh_predictor(run, mesh, _views(mode))

    def predict(dwi_imgs, dce_imgs, generator: Optional[torch.Generator] = None):
        return run((dwi_imgs, dce_imgs), generator)

    return predict


def make_single_predictor(cfg: Config, model, mode: Optional[str] = None,
                          mc_passes: Optional[int] = None,
                          mc_chunk: Optional[int] = None, mesh=None) -> Callable:
    """Returns ``predict(imgs, generator=None) -> (mean, std, aux)`` for one
    encoder (predict.py:186-262), with the prefix split and lean passes of the
    fusion predictor; ``imgs`` NHWC, ``generator`` and ``mesh`` as there."""
    def fwd(xs, mc=False, generator=None, prefixes=None, lean=False):
        p = prefixes[0] if prefixes is not None else None
        return model(xs[0], mc=mc, generator=generator, prefix=p, lean=lean)[:2]

    _place((model,), mesh)
    mode = mode or cfg.test_mode
    run = _ensemble((model,), fwd, lambda xs: (model(xs[0], prefix_only=True),),
                    mode, mc_passes if mc_passes is not None else cfg.mc_passes,
                    cfg.mc_chunk if mc_chunk is None else mc_chunk)
    if mesh is not None:
        run = _mesh_predictor(run, mesh, _views(mode))

    def predict(imgs, generator: Optional[torch.Generator] = None):
        return run((imgs,), generator)

    return predict
