"""Pre-training debug/verification harness, counterpart of
``dmf_tpu/debug_suite.py`` (the reference's runtime smoke suite,
debug_suite.py:7-215, gated by ``debug_training``, run_training.py:77-87).

Eight checks on a synthetic batch: forward shapes, a finite train loss,
the feature-norm regularizer's magnitude, MC-dropout variance, TTA
sensitivity, TTA-MC >= MC variance, the TTA dispatch against a manual
average over views, computable metrics; and the fusion variant (a stub in
the reference, debug_suite.py:218-219).  The models are shrunk to channels
(8, 16, 32) at 64^2 inputs; their weights come from a CPU generator seeded
with ``seed`` whatever ``device`` is, and the dropout draws from a generator
on ``device``.  On the card the predictors run kernels 1 and 6.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import Config, ModelConfig
from .evals.metrics import classification_report
from .evals.predict import make_fusion_predictor, make_single_predictor, to_model, tta_views
from .losses import get_classification_loss_fn, get_mask_loss_fn
from .models.build import init_weights
from .models.encoder import Encoder
from .models.fusion import FusionModel
from .train.single import compute_single_losses


def _check(ok: bool, name: str, detail: str = "") -> bool:
    status = "PASS" if ok else "FAIL"
    print(f"  [{status}] {name}" + (f" — {detail}" if detail else ""))
    return ok


def _debug_model_cfg(cfg: Config, method: str) -> ModelConfig:
    """Shrink the model for the smoke test so it runs in seconds anywhere
    (the reference runs the full model on a synthetic batch; on the CPU that
    takes minutes; the invariants do not depend on width)."""
    mc = cfg.model_config(method)
    if mc.use_backbone:
        mc = dataclasses.replace(mc, use_backbone=False)
    return dataclasses.replace(
        mc, channels=(8, 16, 32), input_size=64, proj_dim=8,
        transformer_embed_dim=32, transformer_depth=1, transformer_heads=2,
    )


def _placed(model: torch.nn.Module, seed: int, device) -> torch.nn.Module:
    """Seeded weights drawn on the CPU, then the model on ``device``
    (``channels_last`` on the card, the layout the kernels take)."""
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    if torch.device(device).type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model.eval()


def debug_encoder(cfg: Config, method: str, seed: int = 0, device="cuda") -> Encoder:
    """The shrunken encoder of :func:`run_debug_suite_single`."""
    return _placed(Encoder(method, _debug_model_cfg(cfg, method), cfg.channel_num(method),
                           cfg.class_num), seed, device)


def debug_fusion_models(cfg: Config, seed: int = 0, device="cuda"
                        ) -> Tuple[Encoder, Encoder, FusionModel]:
    """The shrunken ``(dwi, dce, fusion)`` models of :func:`run_debug_suite_fusion`."""
    dwi = debug_encoder(cfg, "dwi", seed, device)
    dce = debug_encoder(cfg, "dce", seed + 1, device)
    fs = dataclasses.replace(cfg.fusion_model.fusion_specific, fusion_channels=16,
                             dwi_out_channels=dwi.config.channels[-1],
                             dce_out_channels=dce.config.channels[-1])
    fusion = FusionModel(dataclasses.replace(dwi.config, fusion_specific=fs), cfg.class_num,
                         dwi_channels=dwi.config.channels[-1],
                         dce_channels=dce.config.channels[-1], feature_size=dwi.feature_size,
                         with_masks=dwi.mask_stage is not None and dce.mask_stage is not None)
    return dwi, dce, _placed(fusion, seed + 2, device)


@torch.no_grad()
def run_debug_suite_single(cfg: Config, method: str, seed: int = 0, device="cuda") -> bool:
    print(f"[debug-suite] single model, method={method}")
    model = debug_encoder(cfg, method, seed, device)
    mc = model.config
    chan = cfg.channel_num(method)

    rng = np.random.RandomState(seed)
    B, S = 2, mc.input_size
    x = torch.as_tensor(rng.rand(B, S, S, chan).astype(np.float32), device=device)
    masks = torch.as_tensor(
        (rng.rand(B, *mc.mask.mask_target_size, 1) > 0.5).astype(np.float32), device=device)
    labels = torch.as_tensor(rng.randint(0, cfg.class_num, B), device=device)

    ok = True

    # 1. forward shapes (debug_suite.py:30-33)
    logits, aux, mask_pred = model(to_model(x, model))
    ok &= _check(tuple(logits.shape) == (B, cfg.class_num), "forward logits shape",
                 str(tuple(logits.shape)))
    ok &= _check(
        mask_pred is not None and tuple(mask_pred.shape[-2:]) == tuple(mc.mask.mask_target_size),
        "mask prediction shape", str(None if mask_pred is None else tuple(mask_pred.shape)),
    )

    # 2. shared-step loss finite (debug_suite.py:35-38)
    labels_np = labels.cpu().numpy()
    clf = get_classification_loss_fn(cfg, labels_np, method)
    mask_fn = get_mask_loss_fn(cfg, method)
    smcfg = cfg.replace(**{f"{method}_model": mc}) if method in ("dwi", "dce") else cfg
    loss, metrics = compute_single_losses(
        smcfg, method, clf, mask_fn, logits, aux, mask_pred, to_model(x, model),
        to_model(masks, model), labels, 1.0, is_train=True,
    )
    ok &= _check(bool(torch.isfinite(loss)), "train loss finite", f"{float(loss):.4f}")

    # 3. regularizer magnitudes (debug_suite.py:40-127)
    feat_norm = float(metrics.get("feat_norm_loss", 0.0))
    ok &= _check(0.0 <= feat_norm < 1e4, "feat-norm regularizer magnitude",
                 f"{feat_norm:.4f}")

    # 4. MC-dropout variance (debug_suite.py:140-153)
    mc_pred = make_single_predictor(cfg, model, mode="mc", mc_passes=8)
    _, std_mc, _ = mc_pred(x, torch.Generator(device).manual_seed(seed + 7))
    mc_var = float(std_mc.mean())
    ok &= _check(mc_var > 1e-8, "MC dropout produces variance",
                 f"mean std {mc_var:.3e} (dropout may NOT be active if 0)")

    # 5. TTA changes predictions (debug_suite.py:157-166)
    mn, _, _ = make_single_predictor(cfg, model, mode="normal")(x)
    mt, _, _ = make_single_predictor(cfg, model, mode="tta")(x)
    diff = float((mn - mt).abs().max())
    ok &= _check(diff > 1e-7, "TTA changes predictions", f"max diff {diff:.3e}")

    # 6. TTA-MC variance vs MC (debug_suite.py:170-177)
    tta_mc = make_single_predictor(cfg, model, mode="tta_mc", mc_passes=8)
    _, std_tm, _ = tta_mc(x, torch.Generator(device).manual_seed(seed + 7))
    tm_var = float(std_tm.mean())
    ok &= _check(tm_var >= 0.5 * mc_var, "TTA-MC variance >= MC variance",
                 f"{tm_var:.3e} vs {mc_var:.3e}")

    # 7. predict-path cross-consistency (debug_suite.py:182-199): the tta
    # dispatch must agree with a manual average over views
    views_logits, _, _ = model(to_model(tta_views(x), model))
    manual = torch.softmax(views_logits.float(), dim=-1).reshape(4, B, -1).mean(0)
    cross = float((manual - mt).abs().max())
    ok &= _check(cross < 1e-3, "predict paths consistent", f"max diff {cross:.3e}")

    # 8. metrics computable (debug_suite.py:203-213)
    rep = classification_report(mt.cpu().numpy(), labels_np, cfg.class_num, "dbg_")
    ok &= _check(all(np.isfinite(v) for v in rep.values()), "metrics compute")

    print(f"[debug-suite] single {method}: {'ALL PASS' if ok else 'FAILURES'}")
    return bool(ok)


@torch.no_grad()
def run_debug_suite_fusion(cfg: Config, seed: int = 0, device="cuda") -> bool:
    """Fusion smoke suite (the reference left this as a stub)."""
    print("[debug-suite] fusion model")
    dwi, dce, fusion = debug_fusion_models(cfg, seed, device)

    rng = np.random.RandomState(seed)
    B, S = 4, dwi.config.input_size
    xd = torch.as_tensor(rng.rand(B, S, S, cfg.dwi_channel_num).astype(np.float32),
                         device=device)
    xc = torch.as_tensor(rng.rand(B, S, S, cfg.dce_channel_num).astype(np.float32),
                         device=device)
    _, dwi_aux, dwi_m = dwi(to_model(xd, dwi))
    _, dce_aux, dce_m = dce(to_model(xc, dce))

    ok = True
    logits, fused_mask, aux = fusion(dwi_aux["raw_feats"], dce_aux["raw_feats"], dwi_m, dce_m)
    ok &= _check(tuple(logits.shape) == (B, cfg.class_num), "fusion logits shape")
    ok &= _check(
        tuple(fused_mask.shape[-2:]) == tuple(fusion.config.mask.mask_target_size),
        "fused mask shape",
    )
    gw = aux["gating_weights"]
    ok &= _check(bool(torch.allclose(gw.sum(dim=1), torch.ones_like(gw[:, 0]), atol=1e-5)),
                 "gating weights sum to 1", str(gw.mean(dim=0).cpu().numpy()))

    predictor = make_fusion_predictor(cfg, dwi, dce, fusion, mode="tta_mc", mc_passes=4)
    m, s, _ = predictor(xd, xc, torch.Generator(device).manual_seed(seed + 3))
    ok &= _check(bool(torch.isfinite(m).all()), "fusion TTA-MC finite")
    ok &= _check(float(s.mean()) > 1e-8, "fusion MC variance present",
                 f"{float(s.mean()):.3e}")

    print(f"[debug-suite] fusion: {'ALL PASS' if ok else 'FAILURES'}")
    return bool(ok)
