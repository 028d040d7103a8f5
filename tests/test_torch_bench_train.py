"""The bf16-compute train route (``models/build.py::forward_in``, taken by
``dmf_tpu_torch/bench.py``'s ``--train``, ``--train-e2e`` and ``--numerics``)
against the JAX package's train steps on bf16 Flax modules (``dtype=
bfloat16``, fp32 parameters: bench.py:537-557), one step each at toy
geometry on the same weights and batch, dropout 0:

* the loss terms and the gradient norm within 2e-2 relative: bf16 products
  in both, rounded in different orders (ROADMAP 3.4 measured 1.53e-2 on
  bf16 gradients);
* every parameter, BatchNorm statistic and AdamW moment fp32 after the
  step; the port's fp32 step from the same state gives another loss.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_helpers import fusion_stack, jax_encoder, port_config, port_encoder, tiny_cfg

from dmf_tpu.losses import get_classification_loss_fn as j_clf, get_mask_loss_fn as j_mask
from dmf_tpu.train import FusionOptController as JFusionCtrl, TrainState as JState
from dmf_tpu.train import SingleModelOptController as JSingleCtrl, adamw_init as j_adamw_init
from dmf_tpu.train import build_group_spec as j_group_spec
from dmf_tpu.train import fusion as jfusion, single as jsingle

from dmf_tpu_torch.losses import get_classification_loss_fn as p_clf, get_mask_loss_fn as p_mask
from dmf_tpu_torch.train import fusion as pfusion, optim as poptim, single as psingle
from dmf_tpu_torch.train.state import TrainState as PState

BF16_RTOL = 2e-2


def train_batch(seed, n=4, size=32):
    r = np.random.RandomState(seed)
    return {"dwi": r.rand(n, size, size, 14).astype(np.float32),
            "dce": r.rand(n, size, size, 6).astype(np.float32),
            "masks": (r.rand(n, 32, 32, 1) > 0.7).astype(np.float32),
            "labels": r.randint(0, 4, size=n).astype(np.int64)}


def bf16(module):
    return module.clone(dtype=jnp.bfloat16)


def assert_fp32_state(state):
    model = state.model
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers() if b.is_floating_point()} == {torch.float32}
    opt = state.opt_state
    assert {t.dtype for t in (*opt.mu.values(), *opt.nu.values())} == {torch.float32}


def test_bf16_fusion_step_matches_jax():
    """One fusion train step in bf16 on fp32 parameters against
    ``make_fusion_train_step`` on bf16 Flax modules (dropout 0, the same
    weights and batch); the port's fp32 step beside it differs by more than
    the rounding it replaces."""
    cfg = tiny_cfg(dropout=0.0, use_backbone=False).replace(batch_size=4)
    pcfg = port_config(cfg)
    b = train_batch(0)
    (jd, jc, jf), jvars, pmods = fusion_stack(cfg, b["dwi"], b["dce"])
    params = {m: jax.tree.map(jnp.asarray, v["params"]) for m, v in zip(pfusion.PARTS, jvars)}
    stats = {m: jax.tree.map(jnp.asarray, v["batch_stats"])
             for m, v in zip(pfusion.PARTS, jvars)}
    jstate = JState(params=params, batch_stats=stats, opt_state=j_adamw_init(params),
                    step=jnp.zeros((), jnp.int32))
    spec = jfusion.build_fusion_group_spec(params, cfg)
    jstep = jfusion.make_fusion_train_step(cfg, bf16(jd), bf16(jc), bf16(jf),
                                           j_clf(cfg, b["labels"], "fusion"),
                                           j_mask(cfg, "fusion"), spec, donate=False)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    batch["labels"] = batch["labels"].astype(jnp.int32)
    batch["aux_w"] = jnp.asarray(1.0, jnp.float32)
    _, jm = jstep(jstate, batch, jax.random.PRNGKey(0), JFusionCtrl(cfg).hyperparams())

    net = pfusion.FusionNetwork(*pmods)
    pspec = poptim.build_fusion_group_spec([n for n, _ in net.named_parameters()], pcfg)
    metrics = {}
    for dtype in (torch.bfloat16, None):
        state = PState.create(copy.deepcopy(net), num_groups=4)
        step = pfusion.make_fusion_train_step(pcfg, p_clf(pcfg, b["labels"], "fusion"),
                                              p_mask(pcfg, "fusion"), pspec, compute_dtype=dtype)
        m = step(state, dict({k: torch.from_numpy(v) for k, v in b.items()}, aux_w=1.0), None,
                 poptim.FusionOptController(pcfg).hyperparams())
        metrics[dtype] = {k: float(v) for k, v in m.items()}
        assert_fp32_state(state)
    for k in ("loss", "clf_loss", "mask_loss", "recon_loss", "grad_norm"):
        np.testing.assert_allclose(metrics[torch.bfloat16][k], float(jm[k]), rtol=BF16_RTOL,
                                   err_msg=k)
    assert metrics[torch.bfloat16]["loss"] != metrics[None]["loss"]


def test_bf16_single_step_matches_jax():
    """The DWI encoder's train step in bf16 on fp32 parameters against
    ``make_single_train_step`` on a bf16 Flax encoder."""
    cfg = tiny_cfg(dropout=0.0, use_backbone=False).replace(batch_size=4)
    pcfg = port_config(cfg)
    b = train_batch(1)
    jm, v = jax_encoder(cfg.dwi_model, 14, b["dwi"], seed=4)
    jstate = JState.create(jax.tree.map(jnp.asarray, v))
    jspec = j_group_spec(jstate.params, False, True)
    jstep = jsingle.make_single_train_step(cfg, "dwi", bf16(jm), j_clf(cfg, b["labels"], "dwi"),
                                           j_mask(cfg, "dwi"), jspec, donate=False)
    _, jmet = jstep(jstate, {"imgs": jnp.asarray(b["dwi"]), "masks": jnp.asarray(b["masks"]),
                             "labels": jnp.asarray(b["labels"], jnp.int32),
                             "aux_w": jnp.asarray(1.0, jnp.float32)},
                    jax.random.PRNGKey(0), JSingleCtrl(cfg, "dwi").hyperparams())
    enc, _ = port_encoder(cfg.dwi_model, 14, v)
    state = PState.create(enc)
    pspec = poptim.build_group_spec([n for n, _ in enc.named_parameters()], False)
    step = psingle.make_single_train_step(pcfg, "dwi", p_clf(pcfg, b["labels"], "dwi"),
                                          p_mask(pcfg, "dwi"), pspec,
                                          compute_dtype=torch.bfloat16)
    m = step(state, {"imgs": torch.from_numpy(b["dwi"]), "masks": torch.from_numpy(b["masks"]),
                     "labels": torch.from_numpy(b["labels"]), "aux_w": 1.0}, None,
             poptim.SingleModelOptController(pcfg, "dwi").hyperparams())
    assert_fp32_state(state)
    for k in ("loss", "clf_loss", "mask_loss", "recon_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jmet[k]), rtol=BF16_RTOL, err_msg=k)
