"""The port's losses and loss selectors vs the JAX package's, fp32 on the CPU.

Each loss gets the same numpy inputs from a seed: NHWC arrays for the JAX
function, the same arrays as NCHW tensors for the port's.  Tolerance: rel
1e-5 of the JAX value (fp32 sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (the shared torch thread count)
from test_torch_helpers import nchw, port_config

from dmf_tpu import losses as jl
from dmf_tpu.config import default_parameters
from dmf_tpu_torch import losses as pl

RTOL = 1e-5


def close(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=RTOL, atol=RTOL * 1e-2)


def rng(seed):
    return np.random.RandomState(seed)


def logits_labels(seed, b=6, c=4):
    r = rng(seed)
    return (r.standard_normal((b, c)).astype(np.float32) * 2,
            r.randint(0, c, size=b).astype(np.int64))


def maps(seed, *shape):
    return rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- classification
def test_label_smoothing():
    _, y = logits_labels(0)
    close(pl.label_smoothing(torch.from_numpy(y), 4, 0.1),
          jl.label_smoothing(jnp.asarray(y), 4, 0.1))


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_soft_focal_losses(soft, weighted):
    z, y = logits_labels(1)
    t_np = (np.array(jl.label_smoothing(jnp.asarray(y), 4, 0.1)) if soft else y)
    w = np.array(jl.compute_class_weights(jnp.asarray(y), 4)) if weighted else None
    if weighted:
        port = pl.soft_weighted_focal_loss(torch.from_numpy(z), torch.from_numpy(t_np),
                                           2.0, torch.from_numpy(w))
        ref = jl.soft_weighted_focal_loss(jnp.asarray(z), jnp.asarray(t_np), 2.0,
                                          jnp.asarray(w))
    else:
        port = pl.soft_focal_loss(torch.from_numpy(z), torch.from_numpy(t_np), 1.5)
        ref = jl.soft_focal_loss(jnp.asarray(z), jnp.asarray(t_np), 1.5)
    close(port, ref)


def test_hard_focal_losses():
    z, y = logits_labels(2)
    w = np.asarray([0.5, 1.0, 2.0, 1.5], np.float32)
    close(pl.focal_loss(torch.from_numpy(z), torch.from_numpy(y), 0.7, 2.0),
          jl.focal_loss(jnp.asarray(z), jnp.asarray(y), 0.7, 2.0))
    close(pl.weighted_focal_loss(torch.from_numpy(z), torch.from_numpy(y),
                                 torch.from_numpy(w)),
          jl.weighted_focal_loss(jnp.asarray(z), jnp.asarray(y), jnp.asarray(w)))


def test_class_weights():
    y = np.array([0, 0, 1, 3, 3, 3, 3], np.int64)  # class 2 absent
    close(pl.compute_class_weights(y, 4), jl.compute_class_weights(jnp.asarray(y), 4))


# ---------------------------------------------------------------- mask
@pytest.mark.parametrize("name", ["soft_dice_loss", "dice_bce_loss"])
def test_mask_losses(name):
    z = maps(3, 4, 8, 8, 1)
    t = (rng(4).rand(4, 8, 8, 1) > 0.6).astype(np.float32)
    close(getattr(pl, name)(nchw(z), nchw(t)), getattr(jl, name)(jnp.asarray(z), jnp.asarray(t)))


def test_safe_mask_loss_resizes_the_target():
    z = maps(5, 2, 8, 8, 1)
    t = (rng(6).rand(2, 16, 16, 1) > 0.5).astype(np.float32)
    close(pl.safe_mask_loss(nchw(z), nchw(t), pl.soft_dice_loss),
          jl.safe_mask_loss(jnp.asarray(z), jnp.asarray(t), jl.soft_dice_loss))


# ---------------------------------------------------------------- aux
def test_charbonnier_and_recon_image():
    a, b = maps(7, 2, 8, 8, 3), rng(8).rand(2, 8, 8, 3).astype(np.float32)
    close(pl.charbonnier_loss(nchw(a), nchw(b)), jl.charbonnier_loss(jnp.asarray(a), jnp.asarray(b)))
    close(pl.recon_image_loss(nchw(a), nchw(b)), jl.recon_image_loss(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("channels", [1, 14])
def test_single_model_recon_loss(channels):
    """A sum over heads, each upsampled to the input, against the input's
    channel mean for one-channel heads; a missing head is skipped."""
    inputs = rng(9).rand(2, 32, 32, 14).astype(np.float32)
    heads = [maps(10, 2, 16, 16, channels), None, maps(11, 2, 8, 8, channels)]
    close(pl.single_model_recon_loss([None if h is None else nchw(h) for h in heads],
                                     nchw(inputs)),
          jl.single_model_recon_loss([None if h is None else jnp.asarray(h) for h in heads],
                                     jnp.asarray(inputs)))


def test_recon_list_loss():
    img = rng(12).rand(2, 16, 16, 3).astype(np.float32)
    heads = [maps(13, 2, 8, 8, 1), maps(14, 2, 4, 4, 3), None]
    close(pl.compute_recon_list_loss([None if h is None else nchw(h) for h in heads], nchw(img)),
          jl.compute_recon_list_loss([None if h is None else jnp.asarray(h) for h in heads],
                                     jnp.asarray(img)))
    assert float(pl.compute_recon_list_loss(None, nchw(img))) == 0.0


def test_proj_cosine_and_mimic():
    a, b = maps(15, 2, 4, 4, 8), maps(16, 2, 4, 4, 8)
    close(pl.proj_cosine_loss(nchw(a), nchw(b)), jl.proj_cosine_loss(jnp.asarray(a), jnp.asarray(b)))
    close(pl.mimic_feat_loss(nchw(a), nchw(b)), jl.mimic_feat_loss(jnp.asarray(a), jnp.asarray(b)))


def test_mimic_detaches_the_teacher():
    s = nchw(maps(17, 2, 4, 4, 8)).requires_grad_()
    t = nchw(maps(18, 2, 4, 4, 8)).requires_grad_()
    pl.mimic_feat_loss(s, t).backward()
    assert s.grad is not None and t.grad is None


def test_regularizers():
    feats = [maps(19, 2, 8, 8, 4), maps(20, 2, 4, 4, 8)]
    p1, p2 = maps(21, 2, 8, 8, 6), maps(22, 2, 4, 4, 6)
    attn = rng(23).rand(2, 8, 8, 1).astype(np.float32)
    jaux = {"raw_feats": [jnp.asarray(f) for f in feats], "mask_attn_map": jnp.asarray(attn),
            "proj_pairs": [jnp.asarray(p1), None, jnp.asarray(p2), None]}
    paux = {"raw_feats": [nchw(f) for f in feats], "mask_attn_map": nchw(attn),
            "proj_pairs": [nchw(p1), None, nchw(p2), None]}
    for name in ("compute_feat_norm_loss", "compute_attn_energy_loss",
                 "compute_feature_consistency_loss"):
        close(getattr(pl, name)(paux), getattr(jl, name)(jaux))
        assert float(getattr(pl, name)({})) == 0.0


# ---------------------------------------------------------------- selectors
@pytest.mark.parametrize("code", ["fl", "wfl"])
def test_classification_selector(code):
    jcfg = default_parameters()
    jcfg = jcfg.replace(dwi_model=dataclasses.replace(
        jcfg.dwi_model, classification_loss=dataclasses.replace(
            jcfg.dwi_model.classification_loss, loss_code=code)))
    z, y = logits_labels(24, b=12)
    train_labels = np.array([0, 1, 1, 2, 3, 3, 3, 0, 2, 2, 2, 2])
    port = pl.get_classification_loss_fn(port_config(jcfg), train_labels, "dwi")
    ref = jl.get_classification_loss_fn(jcfg, train_labels, "dwi")
    close(port(torch.from_numpy(z), torch.from_numpy(y)), ref(jnp.asarray(z), jnp.asarray(y)))
    with pytest.raises(ValueError, match="classification_loss_code"):
        bad = jcfg.replace(dwi_model=dataclasses.replace(
            jcfg.dwi_model, classification_loss=dataclasses.replace(
                jcfg.dwi_model.classification_loss, loss_code="xx")))
        pl.get_classification_loss_fn(port_config(bad), train_labels, "dwi")


@pytest.mark.parametrize("kind", ["dice", "dice_bce", "off"])
def test_mask_selector(kind):
    jcfg = default_parameters()
    mask = dataclasses.replace(jcfg.dwi_model.mask, enabled=kind != "off",
                               mask_loss_type="dice" if kind == "off" else kind)
    jcfg = jcfg.replace(dwi_model=dataclasses.replace(jcfg.dwi_model, mask=mask))
    port = pl.get_mask_loss_fn(port_config(jcfg), "dwi")
    ref = jl.get_mask_loss_fn(jcfg, "dwi")
    assert (port is None) == (ref is None) == (kind == "off")
    if port is not None:
        z = maps(25, 2, 8, 8, 1)
        t = (rng(26).rand(2, 8, 8, 1) > 0.5).astype(np.float32)
        close(port(nchw(z), nchw(t)), ref(jnp.asarray(z), jnp.asarray(t)))


@pytest.mark.parametrize("recon", [True, False])
def test_recon_selector(recon):
    jcfg = default_parameters()
    jcfg = jcfg.replace(dwi_model=dataclasses.replace(jcfg.dwi_model, recon_enabled=recon))
    port = pl.get_recon_loss_fn(port_config(jcfg), "dwi")
    ref = jl.get_recon_loss_fn(jcfg, "dwi")
    assert (port is None) == (ref is None) == (not recon)
    if port is not None:
        a, b = maps(27, 2, 4, 4, 1), maps(28, 2, 4, 4, 1)
        close(port(nchw(a), nchw(b)), ref(jnp.asarray(a), jnp.asarray(b)))
