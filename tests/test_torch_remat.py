"""Rematerialised ResLite blocks (``ModelConfig.remat``), fp32 on the CPU.

* On the port's own route, one and three train steps with remat on and off
  from the same weights, batches and generator seeds, ResLite dropout 0.2:
  the loss, every gradient, the parameters after the steps, the AdamW
  moments, the BatchNorm running statistics and the dropout generator's
  state afterwards are bit-equal; remat keeps fewer tensors for the
  backward.  The same for one fusion train step with remat on both
  encoders.
* One remat trajectory against JAX: ``tests/test_torch_train.py``'s
  six-step case without a backbone with ``remat=True`` on both sides (JAX
  wraps ``ResLiteBlock`` in ``nn.remat``), losses and gradient norms to rel
  1e-3, then the BatchNorm statistics.  Dropout is 0 there: the two
  packages' random streams differ.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import BACKBONE_LAYERS, assert_close, port_config, tiny_cfg
from test_torch_train import batches, cfg_for, port_keyed, run_jax, run_port, volumes

from dmf_tpu.models.ref_ckpt import export_reference_encoder
from dmf_tpu_torch.losses import get_classification_loss_fn, get_mask_loss_fn
from dmf_tpu_torch.models import encoder as pencoder
from dmf_tpu_torch.pipeline import build_fusion_state, build_single_model
from dmf_tpu_torch.train import optim as poptim
from dmf_tpu_torch.train.fusion import make_fusion_train_step
from dmf_tpu_torch.train.single import compute_single_losses, make_single_train_step
from dmf_tpu_torch.train.state import TrainState

from test_torch_helpers import jax_encoder, resnet_layers

B, STEPS = 4, 3


def remat_cfg(remat, use_backbone):
    cfg = port_config(tiny_cfg(dropout=0.2, use_backbone=use_backbone)).replace(
        batch_size=B, foundation_model_unfreeze_timer=0)
    return cfg.replace(**{f"{m}_model": dataclasses.replace(cfg.model_config(m), remat=remat)
                          for m in ("dwi", "dce")})


def encoder(remat, use_backbone):
    return build_single_model(remat_cfg(remat, use_backbone), "dwi", device="cpu",
                              backbone_layers=BACKBONE_LAYERS)


def dwi_batch(seed):
    imgs, masks, labels = volumes(seed)
    return {"imgs": torch.from_numpy(imgs), "masks": torch.from_numpy(masks),
            "labels": torch.from_numpy(labels), "aux_w": 0.5}


def buffers(model):
    return {k: t for k, t in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def assert_same(a, b, what):
    """Two dicts of tensors equal key for key, bit for bit."""
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def forward_grads(model, cfg, batch, gen):
    """The train-mode loss of ``batch`` and every parameter's gradient; the
    number of tensors autograd kept for the backward beside them."""
    packed = []

    def pack(t):
        packed.append(t.shape)
        return t

    x = batch["imgs"].permute(0, 3, 1, 2)
    masks = batch["masks"].permute(0, 3, 1, 2)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, aux, mask_pred = model(x, train=True, generator=gen)
        loss, _ = compute_single_losses(
            cfg, "dwi", get_classification_loss_fn(cfg, batch["labels"].numpy(), "dwi"),
            get_mask_loss_fn(cfg, "dwi"), logits, aux, mask_pred, x, masks,
            batch["labels"].long(), batch["aux_w"], is_train=True)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: g for k, g in zip(params, grads) if g is not None}
    return loss.detach(), grads, len(packed)


@pytest.mark.parametrize("use_backbone", [False, True], ids=["no_backbone", "backbone"])
def test_remat_train_steps_bit_equal(use_backbone):
    runs = {}
    for remat in (False, True):
        model, cfg = encoder(remat, use_backbone)
        gen = torch.Generator().manual_seed(7)
        loss, grads, n_saved = forward_grads(model, cfg, dwi_batch(1), gen)
        after_one = (buffers(model), gen.get_state())
        state = TrainState.create(model)
        spec = poptim.build_group_spec([n for n, _ in model.named_parameters()],
                                       use_backbone)
        clf = get_classification_loss_fn(cfg, np.arange(8) % 4, "dwi")
        step = make_single_train_step(cfg, "dwi", clf, get_mask_loss_fn(cfg, "dwi"), spec)
        ctrl = poptim.SingleModelOptController(cfg, "dwi")
        ctrl.on_epoch_start(0)
        metrics = [step(state, dwi_batch(2 + i), gen, ctrl.hyperparams())
                   for i in range(STEPS)]
        runs[remat] = dict(loss=loss, grads=grads, n_saved=n_saved, after_one=after_one,
                           metrics=metrics, params=dict(model.named_parameters()),
                           buffers=buffers(model), gen=gen.get_state(), state=state)
    plain, remat = runs[False], runs[True]
    assert torch.equal(plain["loss"], remat["loss"])
    assert_same(plain["grads"], remat["grads"], "gradients")
    assert len(plain["grads"]) > 10
    # one forward and backward: statistics updated once, the same draws
    assert_same(plain["after_one"][0], remat["after_one"][0], "BN statistics after one")
    assert torch.equal(plain["after_one"][1], remat["after_one"][1])
    assert remat["n_saved"] < plain["n_saved"]
    for i, (a, b) in enumerate(zip(plain["metrics"], remat["metrics"])):
        assert_same(a, b, f"step {i} metrics")
    assert_same(plain["params"], remat["params"], "parameters")
    assert_same(plain["buffers"], remat["buffers"], "BN statistics")
    assert torch.equal(plain["gen"], remat["gen"])
    ps, rs = plain["state"], remat["state"]
    assert_same(ps.opt_state.mu, rs.opt_state.mu, "AdamW mu")
    assert_same(ps.opt_state.nu, rs.opt_state.nu, "AdamW nu")
    assert ps.step == rs.step == STEPS


def test_remat_fusion_step_bit_equal():
    r = np.random.RandomState(3)
    batch = {"dwi": torch.from_numpy(r.rand(B, 32, 32, 14).astype(np.float32)),
             "dce": torch.from_numpy(r.rand(B, 32, 32, 6).astype(np.float32)),
             "masks": torch.from_numpy((r.rand(B, 32, 32, 1) > 0.7).astype(np.float32)),
             "labels": torch.from_numpy(r.randint(0, 4, B)), "aux_w": 0.5}
    runs = {}
    for remat in (False, True):
        cfg = remat_cfg(remat, False).replace(unfreeze_timer=0)
        dwi, cfg = build_single_model(cfg, "dwi", device="cpu")
        dce, cfg = build_single_model(cfg, "dce", device="cpu")
        state = build_fusion_state(cfg, TrainState.create(dwi), TrainState.create(dce))
        spec = poptim.build_fusion_group_spec([n for n, _ in state.model.named_parameters()],
                                              cfg)
        step = make_fusion_train_step(cfg, get_classification_loss_fn(
            cfg, batch["labels"].numpy(), "fusion"), get_mask_loss_fn(cfg, "fusion"), spec)
        ctrl = poptim.FusionOptController(cfg)
        ctrl.on_epoch_start(3)  # every group trainable
        gen = torch.Generator().manual_seed(11)
        metrics = step(state, batch, gen, ctrl.hyperparams())
        runs[remat] = (metrics, dict(state.model.named_parameters()),
                       buffers(state.model), gen.get_state())
    (m0, p0, b0, g0), (m1, p1, b1, g1) = runs[False], runs[True]
    assert cfg.dwi_model.remat and cfg.dce_model.remat
    assert_same(m0, m1, "metrics")
    assert_same(p0, p1, "parameters")
    assert_same(b0, b1, "BN statistics")
    assert torch.equal(g0, g1)


def test_remat_eval_route_not_checkpointed(monkeypatch):
    """Under ``torch.no_grad()`` and with ``train=False`` no block is
    checkpointed; a train forward under autograd checkpoints three."""
    calls = []
    real = pencoder.remat_block
    monkeypatch.setattr(pencoder, "remat_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model, _ = encoder(True, False)
    x = torch.rand(2, 14, 32, 32, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        model(x, train=True, generator=g)
        model(x, mc=True, generator=g)
    model(x)
    assert calls == []
    model(x, train=True, generator=g)
    assert len(calls) == 3


def test_remat_trajectory_matches_jax():
    """``test_torch_train.py``'s no-backbone trajectory (6 steps across two
    epochs) with remat on in both packages."""
    jcfg = cfg_for(False)
    jcfg = jcfg.replace(dwi_model=dataclasses.replace(jcfg.dwi_model, remat=True))
    data = batches()
    x = volumes(0)[0]
    jm, v = jax_encoder(jcfg.dwi_model, 14, x, seed=4)
    train_labels = np.concatenate([b["labels"] for b in data])
    jstate, jrec = run_jax(jcfg, jm, v, data, train_labels)
    pstate, prec = run_port(jcfg, v, data, train_labels)
    assert pstate.model.config.remat
    keys = ["loss", "clf_loss", "mask_loss", "recon_loss", "mimic_loss", "grad_norm"]
    keys += [k for k in jrec[0] if k.startswith("grad_norm_")]
    for k in keys:
        np.testing.assert_allclose([r[k] for r in prec], [r[k] for r in jrec], rtol=1e-3,
                                   err_msg=k)
    with resnet_layers(BACKBONE_LAYERS):
        final = port_keyed(export_reference_encoder(jax.device_get(jstate.variables)))
    stats = buffers(pstate.model)
    assert stats
    for k, t in stats.items():
        assert_close(t, final[k], rtol=1e-3, what=k)
