"""Uncertainty-aware fusion inference: TTA, MC dropout and TTA x MC.

Counterpart of ``dmf_tpu/evals/predict.py`` (:31-92, :263-383).  Semantics:

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


def _to_model(x: torch.Tensor, like: torch.nn.Module) -> torch.Tensor:
    """NHWC volume -> NCHW map in the model's dtype (channels_last on CUDA)."""
    p = next(like.parameters())
    x = x.to(device=p.device, dtype=p.dtype).permute(0, 3, 1, 2)
    if x.is_cuda:
        return x.contiguous(memory_format=torch.channels_last)
    return x.contiguous()


def _to_nhwc(tree):
    if isinstance(tree, dict):
        return {k: _to_nhwc(v) for k, v in tree.items()}
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


def make_fusion_predictor(cfg: Config, dwi_model, dce_model, fusion_model,
                          mode: Optional[str] = None,
                          mc_passes: Optional[int] = None,
                          mc_chunk: Optional[int] = None) -> Callable:
    """Returns ``predict(dwi_imgs, dce_imgs, generator=None) -> (mean, std, aux)``.

    ``dwi_imgs``/``dce_imgs`` are NHWC.  ``generator`` (on the models'
    device) drives every dropout draw and is required in ``mc``/``tta_mc``.
    ``mc_chunk`` defaults to ``cfg.mc_chunk``.
    """
    mode = mode or cfg.test_mode
    passes = mc_passes if mc_passes is not None else cfg.mc_passes
    if mc_chunk is None:
        mc_chunk = cfg.mc_chunk

    def fwd(x_dwi, x_dce, mc=False, generator=None, prefixes=None, lean=False):
        pre_d, pre_c = prefixes if prefixes is not None else (None, None)
        _, dwi_aux, dwi_mask = dwi_model(x_dwi, mc=mc, generator=generator,
                                         prefix=pre_d, lean=lean)
        _, dce_aux, dce_mask = dce_model(x_dce, mc=mc, generator=generator,
                                         prefix=pre_c, lean=lean)
        logits, _, aux = fusion_model(dwi_aux["raw_feats"], dce_aux["raw_feats"],
                                      dwi_mask, dce_mask, lean=lean)
        return logits, aux

    @torch.no_grad()
    def predict(dwi_imgs, dce_imgs, generator: Optional[torch.Generator] = None):
        B = dwi_imgs.shape[0]
        if mode == "normal":
            logits, aux = fwd(_to_model(dwi_imgs, dwi_model),
                              _to_model(dce_imgs, dce_model))
            probs = torch.softmax(logits.float(), dim=-1)
            return probs, torch.zeros_like(probs), _to_nhwc(aux)
        if mode == "tta":
            logits, aux = fwd(_to_model(tta_views(dwi_imgs), dwi_model),
                              _to_model(tta_views(dce_imgs), dce_model))
            probs = torch.softmax(logits.float(), dim=-1).reshape(4, B, -1)
            return probs.mean(0), _std(probs, 0), _to_nhwc(aux)
        if mode in ("mc", "tta_mc"):
            if generator is None:
                raise ValueError(f"mode {mode!r} needs a generator")
            if mode == "tta_mc":
                dwi_imgs, dce_imgs = tta_views(dwi_imgs), tta_views(dce_imgs)
            x_dwi = _to_model(dwi_imgs, dwi_model)
            x_dce = _to_model(dce_imgs, dce_model)
            # the prefix holds no dropout: run it once for every pass
            pre = (dwi_model(x_dwi, prefix_only=True),
                   dce_model(x_dce, prefix_only=True))
            n_lean = passes - 1
            chunk = max(1, n_lean if mc_chunk is None else min(mc_chunk, n_lean))
            probs = []
            for start in range(0, n_lean, chunk):
                pre_k = tuple(_repeat_prefix(p, min(chunk, n_lean - start))
                              for p in pre)
                logits, _ = fwd(None, None, mc=True, generator=generator,
                                prefixes=pre_k, lean=True)
                probs.append(torch.softmax(logits.float(), dim=-1))
            logits, aux = fwd(None, None, mc=True, generator=generator,
                              prefixes=pre)
            probs.append(torch.softmax(logits.float(), dim=-1))
            probs = torch.cat(probs).reshape(passes * (probs[-1].shape[0] // B), B, -1)
            return probs.mean(0), _std(probs, 0), _to_nhwc(aux)
        raise ValueError(f"Unknown predict mode: {mode}")

    return predict
