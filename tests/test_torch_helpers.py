"""Shared helpers for the JAX-vs-port parity tests (``test_torch_*.py``).

Both packages get the same weights: JAX variables are randomized from a
numpy seed, turned into the reference torch layout by
``dmf_tpu.models.ref_ckpt.export_reference_*`` and loaded into the port with
``load_reference_state_dict``.  Inputs are numpy arrays from a seed.  All
comparisons run fp32 (bf16 on XLA:CPU is not stable across compilations).
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dmf_tpu.config import default_parameters, resolve_backbone_config
from dmf_tpu.models.backbones import importers
from dmf_tpu_torch import config as pconfig

# torch's CPU exp runs MKL's vector math.  Its AVX-512 and AVX2 code paths
# are not reproducible on a multi-core host: in about one process of six
# (never with the process pinned to one core) whole chunks of a tensor came
# out with exps off by up to 1.5e-4 relative (a logsumexp of 256 scores ~4e-5
# off against a float64 numpy one), and two calls on the same input differed.
# MKL's compatible (SSE2) path gave the same, accurate bits in every process.
# MKL reads this at its first call (torch.set_num_threads below is one).
os.environ.setdefault("MKL_CBWR", "COMPATIBLE")
# several pytest workers share the host: every test_torch_* file that
# imports this module runs with a torch pool of 2 threads
torch.set_num_threads(2)

# fp32 parity: |port - jax| <= RTOL * max(1, max|jax|) elementwise, i.e. a
# relative error of 1e-4 against the tensor's own scale (ROADMAP: forward
# rel <= 1e-4).  Flax norms compute E[x^2]-E[x]^2 where torch subtracts the
# mean first, which stays well inside this at these magnitudes.
RTOL = 1e-4

BACKBONE_LAYERS = (1, 1, 1, 1)


def assert_close(port, ref, rtol=RTOL, what=""):
    port = np.asarray(port.detach().cpu().numpy() if isinstance(port, torch.Tensor)
                      else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, f"{what}: shape {port.shape} vs {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def nchw(a):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def randomize(variables, seed):
    """Well-conditioned random values for every leaf (BN var > 0, scales
    near 1), so parity exercises real weight content and the BN fold."""
    rng = np.random.RandomState(seed)

    def f(path, leaf):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        arr = 0.1 * rng.standard_normal(np.shape(leaf)).astype(np.float32)
        if name == "var":
            arr = np.abs(arr) + 0.5
        elif name == "scale":
            arr = arr + 1.0
        return arr

    return jax.tree_util.tree_map_with_path(f, variables)


def init_shapes(model, *args):
    """The variables' shapes, traced without running ``model.init`` (which
    runs op by op on the CPU); :func:`randomize` needs only the shapes."""
    return jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0),
                                              "dropout": jax.random.PRNGKey(1)},
                                             *args, train=False))


@contextlib.contextmanager
def resnet_layers(layers):
    """Let the numpy ResNet exporter walk a shallow test backbone."""
    old = importers._RESNET_LAYERS
    importers._RESNET_LAYERS = tuple(layers)
    try:
        yield
    finally:
        importers._RESNET_LAYERS = old


def tiny_cfg(dropout=0.2, use_backbone=True, mc_passes=3):
    """Toy geometry: 32^2 inputs, narrow widths, a (1,1,1,1) ResNet-50."""
    cfg = default_parameters(mc_passes=mc_passes)
    mc = dataclasses.replace(cfg.dwi_model, input_size=32, channels=(8, 16, 32),
                             proj_dim=8, dropout=dropout, use_backbone=use_backbone)
    mc = resolve_backbone_config(mc)
    fs = dataclasses.replace(cfg.fusion_model.fusion_specific, fusion_channels=16,
                             dwi_out_channels=32, dce_out_channels=32)
    return cfg.replace(dwi_model=mc, dce_model=mc,
                       fusion_model=dataclasses.replace(mc, fusion_specific=fs))


def port_config(cfg):
    """The port's twin of a JAX ``Config`` (or of one of its dataclasses),
    through the JAX package's ``to_dict`` and the port's ``from_dict``."""
    if type(cfg).__name__ == "Config":
        return pconfig.Config.from_dict(cfg.to_dict())
    return pconfig._from_dict(getattr(pconfig, type(cfg).__name__),
                              dataclasses.asdict(cfg))


def hybrid_cfg(use_backbone=False, dropout=0.0, mc_passes=3):
    """Toy ``hybrid-nb`` geometry (``bench.py --encoder hybrid-nb`` cut down):
    32^2 inputs, narrow widths, a 2-block transformer of embed 32 / 2 heads
    on f2 (16^2 -> 8^2 = 64 tokens), fusion at f3 8^2 x 32."""
    cfg = default_parameters(mc_passes=mc_passes)
    mc = dataclasses.replace(cfg.dwi_model, input_size=32, channels=(8, 16, 32),
                             proj_dim=8, dropout=dropout, use_backbone=use_backbone,
                             use_hybrid_transformer=True, transformer_embed_dim=32,
                             transformer_heads=2, transformer_depth=2)
    mc = resolve_backbone_config(mc)
    fs = dataclasses.replace(cfg.fusion_model.fusion_specific, fusion_channels=16,
                             dwi_out_channels=32, dce_out_channels=32)
    return cfg.replace(dwi_model=mc, dce_model=mc,
                       fusion_model=dataclasses.replace(mc, fusion_specific=fs))


def jax_encoder(mc, channel_num, x, num_classes=4, seed=0):
    """A JAX Encoder (with a shallow backbone when configured) and random
    variables for it."""
    from dmf_tpu.models import Encoder
    from dmf_tpu.models.backbones.resnet import ResNetFeatures

    backbone = (ResNetFeatures(in_channels=channel_num, layers=BACKBONE_LAYERS)
                if mc.use_backbone else None)
    model = Encoder(method="dwi", config=mc, channel_num=channel_num,
                    num_classes=num_classes, backbone=backbone)
    return model, randomize(init_shapes(model, jnp.asarray(x)), seed)


def port_encoder(mc, channel_num, variables, num_classes=4):
    from dmf_tpu.models.ref_ckpt import export_reference_encoder
    from dmf_tpu_torch.models import Encoder, load_reference_state_dict

    enc = Encoder("dwi", port_config(mc), channel_num, num_classes,
                  backbone_layers=BACKBONE_LAYERS)
    with resnet_layers(BACKBONE_LAYERS):
        sd = export_reference_encoder(variables)
    report = load_reference_state_dict(enc, sd)
    return enc, report


def jax_fusion(cfg, feats_dwi, feats_dce, m_dwi, m_dce, seed=5):
    from dmf_tpu.models import FusionModel

    model = FusionModel(config=cfg.fusion_model, num_classes=cfg.class_num)
    return model, randomize(init_shapes(model, feats_dwi, feats_dce, m_dwi, m_dce), seed)


def port_fusion(cfg, variables, feature_size):
    from dmf_tpu.models.ref_ckpt import export_reference_fusion
    from dmf_tpu_torch.models import FusionModel, load_reference_state_dict

    cfg = port_config(cfg)
    fus = FusionModel(cfg.fusion_model, cfg.class_num,
                      dwi_channels=cfg.dwi_model.channels[-1],
                      dce_channels=cfg.dce_model.channels[-1],
                      feature_size=feature_size)
    report = load_reference_state_dict(fus, export_reference_fusion(variables))
    return fus, report


def volumes(seed, b=2, size=32, c_dwi=14, c_dce=6):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, size, size, c_dwi).astype(np.float32),
            rng.rand(b, size, size, c_dce).astype(np.float32))


def fusion_stack(cfg, xd, xc, seeds=(1, 2, 3)):
    """JAX encoders (DWI 14, DCE 6 channels) and fusion head on random
    variables from ``seeds``, and the port's twins on the same weights:
    ``((jd, jc, jf), (vd, vc, vf), (pd, pc, pf))``."""
    jd, vd = jax_encoder(cfg.dwi_model, xd.shape[-1], xd, seed=seeds[0])
    jc, vc = jax_encoder(cfg.dce_model, xc.shape[-1], xc, seed=seeds[1])
    outs = [jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         jax.eval_shape(lambda v, x, m=m: m.apply(v, x, train=False), v,
                                        jnp.asarray(x)))
            for m, v, x in ((jd, vd, xd), (jc, vc, xc))]
    (_, ad, md), (_, ac, mc_) = outs
    jf, vf = jax_fusion(cfg, ad["raw_feats"], ac["raw_feats"], md, mc_, seed=seeds[2])
    pd, _ = port_encoder(cfg.dwi_model, xd.shape[-1], vd)
    pc, _ = port_encoder(cfg.dce_model, xc.shape[-1], vc)
    pf, _ = port_fusion(cfg, vf, pd.feature_size)
    return (jd, jc, jf), (vd, vc, vf), (pd, pc, pf)
