"""Uncertainty-aware inference: TTA, MC dropout and TTA x MC, for the fusion
model and for one single-modality encoder.

Counterpart of ``dmf_tpu/evals/predict.py`` (:31-92, :186-383).  Semantics:

* TTA views: identity, lr-flip, ud-flip, both, folded into the batch;
* MC mode: BatchNorm on running statistics, dropout on (``mc=True``);
* mean and unbiased std over the stacked (pass x view) axis.

The MC passes are a batch dimension: the deterministic prefix (modality SE,
backbone, adapter) runs once and is repeated along the batch for the
suffix.  ``mc_chunk`` passes go through the suffix together (default: all);
passes 0..P-2 are lean (probabilities only) and the last pass runs in full
and supplies ``aux``.  The public function keeps the JAX layout: NHWC volumes
in, ``(mean, std, aux)`` out, with aux maps returned NHWC.
"""

from __future__ import annotations

from typing import Callable, Optional

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


def _ensemble(encoders, head: Callable, mode: str, passes: int,
              mc_chunk: Optional[int]) -> Callable:
    """``run(imgs, generator) -> (mean, std, aux)`` over ``encoders`` (one
    NHWC batch each), with ``head(outs, lean) -> (logits, aux)`` on their
    ``(logits, aux, mask)`` outputs."""

    def fwd(xs, mc=False, generator=None, prefixes=None, lean=False):
        prefixes = prefixes if prefixes is not None else (None,) * len(encoders)
        outs = [m(x, mc=mc, generator=generator, prefix=p, lean=lean)
                for m, x, p in zip(encoders, xs, prefixes)]
        return head(outs, lean)

    def inputs(imgs, views):
        return [to_model(tta_views(x) if views else x, m) for x, m in zip(imgs, encoders)]

    @torch.no_grad()
    def run(imgs, generator: Optional[torch.Generator]):
        B = imgs[0].shape[0]
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
            xs = inputs(imgs, mode == "tta_mc")
            # the prefix holds no dropout: run it once for every pass
            pre = tuple(m(x, prefix_only=True) for m, x in zip(encoders, xs))
            n_lean = passes - 1
            chunk = max(1, n_lean if mc_chunk is None else min(mc_chunk, n_lean))
            probs = []
            for start in range(0, n_lean, chunk):
                pre_k = tuple(_repeat_prefix(p, min(chunk, n_lean - start)) for p in pre)
                logits, _ = fwd((None,) * len(encoders), mc=True, generator=generator,
                                prefixes=pre_k, lean=True)
                probs.append(torch.softmax(logits.float(), dim=-1))
            logits, aux = fwd((None,) * len(encoders), mc=True, generator=generator,
                              prefixes=pre)
            probs.append(torch.softmax(logits.float(), dim=-1))
            probs = torch.cat(probs).reshape(passes * (probs[-1].shape[0] // B), B, -1)
            return probs.mean(0), _std(probs, 0), _to_nhwc(aux)
        raise ValueError(f"Unknown predict mode: {mode}")

    return run


def make_fusion_predictor(cfg: Config, dwi_model, dce_model, fusion_model,
                          mode: Optional[str] = None,
                          mc_passes: Optional[int] = None,
                          mc_chunk: Optional[int] = None) -> Callable:
    """Returns ``predict(dwi_imgs, dce_imgs, generator=None) -> (mean, std, aux)``.

    ``dwi_imgs``/``dce_imgs`` are NHWC.  ``generator`` (on the models'
    device) drives every dropout draw and is required in ``mc``/``tta_mc``.
    ``mc_chunk`` defaults to ``cfg.mc_chunk``.
    """

    def head(outs, lean):
        (_, dwi_aux, dwi_mask), (_, dce_aux, dce_mask) = outs
        logits, _, aux = fusion_model(dwi_aux["raw_feats"], dce_aux["raw_feats"],
                                      dwi_mask, dce_mask, lean=lean)
        return logits, aux

    run = _ensemble((dwi_model, dce_model), head, mode or cfg.test_mode,
                    mc_passes if mc_passes is not None else cfg.mc_passes,
                    cfg.mc_chunk if mc_chunk is None else mc_chunk)

    def predict(dwi_imgs, dce_imgs, generator: Optional[torch.Generator] = None):
        return run((dwi_imgs, dce_imgs), generator)

    return predict


def make_single_predictor(cfg: Config, model, mode: Optional[str] = None,
                          mc_passes: Optional[int] = None,
                          mc_chunk: Optional[int] = None) -> Callable:
    """Returns ``predict(imgs, generator=None) -> (mean, std, aux)`` for one
    encoder (predict.py:186-262), with the prefix split and lean passes of the
    fusion predictor; ``imgs`` NHWC, ``generator`` as there."""
    run = _ensemble((model,), lambda outs, lean: outs[0][:2], mode or cfg.test_mode,
                    mc_passes if mc_passes is not None else cfg.mc_passes,
                    cfg.mc_chunk if mc_chunk is None else mc_chunk)

    def predict(imgs, generator: Optional[torch.Generator] = None):
        return run((imgs,), generator)

    return predict
