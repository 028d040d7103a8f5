"""The port's ViT-B/16 / DINO slice vs the JAX package, fp32 on the CPU.

Toy width: a ViT of embed 48, 12 blocks (so that the adapter's
[0-2] / [3-6] / [7-11] chains exist) and 4 heads on 64^2 inputs (a 4 x 4
token grid), encoder channels (32, 32, 32).  Weights go JAX variables ->
``dmf_tpu.models.ref_ckpt.export_reference_*`` -> the port's
``load_reference_state_dict``; pretrained imports start from seeded
checkpoints in timm's layout on the 224 grid (1 + 14^2 positions, 3 input
channels), as no timm or DINO weights are in the repository.

Tolerances: ``jax.image.resize``'s bicubic against the port's numpy copy to
rel 1e-6 (the contraction's sum order differs; the resampling weights are
bit-equal); the imports otherwise bit-equal; ``ViTFeatures`` rel 1e-5; the
encoder and the fusion predictor ``RTOL`` (rel 1e-4); the train-step
trajectory rel 1e-3, as ``test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_close, init_shapes, jax_fusion, nchw, nhwc,
                                port_config, port_fusion, randomize)
from test_torch_train import STEPS_PER_EPOCH, port_keyed, run_jax, run_port

from dmf_tpu.config import default_parameters, resolve_backbone_config
from dmf_tpu.evals.predict import make_fusion_predictor as jax_fusion_predictor
from dmf_tpu.evals.predict import make_single_predictor as jax_single_predictor
from dmf_tpu.models import Encoder as JaxEncoder
from dmf_tpu.models.backbones import importers as jimp
from dmf_tpu.models.backbones.vit import ViTFeatures as JaxViT
from dmf_tpu.models.ref_ckpt import export_reference_encoder as jax_export
from dmf_tpu.models.ref_ckpt import import_reference_encoder as jax_import
from dmf_tpu.train import build_group_spec as jax_group_spec
from dmf_tpu_torch import config as pconfig
from dmf_tpu_torch.evals.predict import make_fusion_predictor, make_single_predictor
from dmf_tpu_torch.models import Encoder, init_weights, load_reference_state_dict
from dmf_tpu_torch.models.adapter import token_map
from dmf_tpu_torch.models.backbones import ViTFeatures, ViTSize, build_backbone
from dmf_tpu_torch.models.backbones import importers as pimp
from dmf_tpu_torch.models.weights import export_reference_encoder
from dmf_tpu_torch.pipeline.prepare_single import build_single_model
from dmf_tpu_torch.train import optim as poptim

SIZE = ViTSize(48, 12, 4)
IMG = 64
GRID = IMG // 16
CHANNELS = 14
VIT_NAMES = ("vit_base_patch16_224", "dino_vitbase16_pretrain")


def vit_cfg(name="dino_vitbase16_pretrain", dropout=0.0, mc_passes=3):
    """The ViT-backed config at toy widths: the backbone-derived fields
    (chains, no block downsampling, ``transformer_backbone``) resolved, then
    the encoder channels narrowed from the derived 768."""
    cfg = default_parameters(mc_passes=mc_passes)
    mc = dataclasses.replace(cfg.dwi_model, input_size=IMG, proj_dim=8, dropout=dropout,
                             backbone_str=name)
    mc = dataclasses.replace(resolve_backbone_config(mc), channels=(32, 32, 32))
    fs = dataclasses.replace(cfg.fusion_model.fusion_specific, fusion_channels=16,
                             dwi_out_channels=32, dce_out_channels=32)
    return cfg.replace(dwi_model=mc, dce_model=mc,
                       fusion_model=dataclasses.replace(mc, fusion_specific=fs))


def jax_vit_encoder(mc, channel_num, x, seed):
    backbone = JaxViT(in_channels=channel_num, img_size=IMG, embed_dim=SIZE.embed_dim,
                      depth=SIZE.depth, num_heads=SIZE.num_heads)
    model = JaxEncoder(method="dwi", config=mc, channel_num=channel_num, num_classes=4,
                       backbone=backbone)
    return model, randomize(init_shapes(model, jnp.asarray(x)), seed)


def port_vit_encoder(mc, channel_num, variables):
    enc = Encoder("dwi", port_config(mc), channel_num, 4, backbone_layers=SIZE)
    return enc, load_reference_state_dict(enc, jax_export(variables))


def timm_checkpoint(seed, width=SIZE.embed_dim, depth=SIZE.depth, grid=14, in_ch=3):
    """A seeded ViT checkpoint in timm's layout, with timm's final norm and
    head, which the import ignores."""
    r = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy((0.05 * r.standard_normal(shape)).astype(np.float32))

    sd = {"patch_embed.proj.weight": t(width, in_ch, 16, 16),
          "patch_embed.proj.bias": t(width), "cls_token": t(1, 1, width),
          "pos_embed": t(1, 1 + grid * grid, width),
          "norm.weight": t(width), "norm.bias": t(width), "head.weight": t(1000, width),
          "head.bias": t(1000)}
    for i in range(depth):
        pre = f"blocks.{i}."
        for name, shape in (("norm1", (width,)), ("norm2", (width,))):
            sd[pre + name + ".weight"] = 1.0 + t(*shape)
            sd[pre + name + ".bias"] = t(*shape)
        for name, (o, n) in (("attn.qkv", (3 * width, width)), ("attn.proj", (width, width)),
                             ("mlp.fc1", (4 * width, width)), ("mlp.fc2", (width, 4 * width))):
            sd[pre + name + ".weight"] = t(o, n)
            sd[pre + name + ".bias"] = t(o)
    return sd


# ---------------------------------------------------------------- the import
@pytest.mark.parametrize("grid,new", [(14, 16), (14, 4)], ids=["224-to-256", "shrink"])
def test_resize_pos_embed_matches_jax(grid, new):
    """Growing (the real 224 -> 256 import) and shrinking (toy sizes, where
    jax.image antialiases by widening the kernel)."""
    pos = np.random.RandomState(grid + new).standard_normal(
        (1, 1 + grid * grid, 24)).astype(np.float32)
    ours = pimp.resize_pos_embed(pos, new)
    theirs = jimp.resize_pos_embed(pos, new)
    assert ours.shape == theirs.shape == (1, 1 + new * new, 24)
    np.testing.assert_array_equal(ours[:, 0], pos[:, 0])
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6 * np.abs(theirs).max())
    # not torch's bicubic (a = -0.75, clamped edges)
    grid_t = torch.from_numpy(pos[:, 1:].reshape(1, grid, grid, 24)).permute(0, 3, 1, 2)
    torch_bicubic = torch.nn.functional.interpolate(grid_t, size=(new, new), mode="bicubic",
                                                    align_corners=False)
    assert np.abs(torch_bicubic.permute(0, 2, 3, 1).reshape(1, -1, 24).numpy()
                  - theirs[:, 1:]).max() > 1e-3


@pytest.mark.parametrize("in_ch", [14, 6])
@pytest.mark.parametrize("advanced", [True, False])
def test_import_vit_base_matches_jax(in_ch, advanced):
    """Every tensor bit-equal to JAX's import (through its ``export_vit_base``
    back to timm's layout), the position embedding resized 14 -> 16 to rel
    1e-6; the result loads strictly into the module."""
    sd = timm_checkpoint(1)
    ours = pimp.import_vit_base(sd, in_ch, img_size=256, use_advanced_adapt=advanced)
    jparams, jstats = jimp.import_vit_base({k: v.numpy() for k, v in sd.items()}, in_ch,
                                           img_size=256, use_advanced_adapt=advanced)
    theirs = jimp.export_vit_base(jparams)
    assert jstats == {} and set(ours) == set(theirs)
    for k, v in ours.items():
        if k == "pos_embed":
            np.testing.assert_allclose(v.numpy(), theirs[k], rtol=0,
                                       atol=1e-6 * np.abs(theirs[k]).max())
        else:
            np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    assert ours["patch_embed.proj.weight"].shape == (SIZE.embed_dim, in_ch, 16, 16)
    assert ours["pos_embed"].shape == (1, 257, SIZE.embed_dim)
    ViTFeatures(in_ch, 256, 16, SIZE).load_state_dict(ours, strict=True)


def test_import_rejects_a_checkpoint_that_does_not_fit():
    sd = timm_checkpoint(2)
    del sd["blocks.3.mlp.fc1.bias"]
    with pytest.raises(KeyError, match="blocks.3.mlp.fc1.bias"):
        pimp.import_vit_base(sd, 6, depth=12)
    sd = timm_checkpoint(2)
    sd["blocks.0.attn.proj.weight"] = sd["blocks.0.attn.proj.weight"][:, :5]
    with pytest.raises(ValueError, match="shape"):
        pimp.import_vit_base(sd, 6)


# ---------------------------------------------------------------- the modules
def test_vit_features_matches_jax():
    """All 12 token outputs (cls stripped), rel 1e-5."""
    x = np.random.RandomState(0).rand(2, IMG, IMG, 6).astype(np.float32)
    jm = JaxViT(in_channels=6, img_size=IMG, embed_dim=SIZE.embed_dim, depth=SIZE.depth,
                num_heads=SIZE.num_heads)
    v = randomize(init_shapes(jm, jnp.asarray(x)), 2)
    pm = ViTFeatures(6, IMG, 16, SIZE)
    pm.load_state_dict({k: torch.from_numpy(a) for k, a in
                        jimp.export_vit_base(v["params"]).items()}, strict=True)
    refs = jm.apply(v, jnp.asarray(x), train=False)
    outs = pm(nchw(x))
    assert len(outs) == 12 and pm.output_dims == (48,) * 12 and pm.reductions == (16,) * 12
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o.shape == (2, GRID * GRID, SIZE.embed_dim)
        assert_close(o, r, rtol=1e-5, what=f"block {i}")


def test_token_map_puts_token_at_the_jax_pixel():
    """Token r*s + c lands at pixel (r, c), as JAX's (B, N, C) -> (B, s, s, C)."""
    tokens = torch.arange(2 * 16 * 3, dtype=torch.float32).reshape(2, 16, 3)
    ref = np.asarray(jnp.asarray(tokens.numpy()).reshape(2, 4, 4, 3))
    out = token_map(tokens)
    assert out.shape == (2, 3, 4, 4)
    np.testing.assert_array_equal(nhwc(out), ref)
    assert out.is_contiguous(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def encoder_pair():
    cfg = vit_cfg()
    x = np.random.RandomState(4).rand(2, IMG, IMG, CHANNELS).astype(np.float32)
    jm, v = jax_vit_encoder(cfg.dwi_model, CHANNELS, x, seed=3)
    pm, report = port_vit_encoder(cfg.dwi_model, CHANNELS, v)
    return cfg, x, jm, v, pm, report


def test_encoder_matches_jax(encoder_pair):
    """Logits, mask and features at f1-f3 (4 x 4 maps: the token grid, no
    block downsampling); the strict loader drops only the reference-only keys."""
    cfg, x, jm, v, pm, report = encoder_pair
    logits, aux, mask = jm.apply(v, jnp.asarray(x), train=False)
    plog, paux, pmask = pm(nchw(x))
    assert_close(plog, logits, what="logits")
    assert_close(nhwc(pmask), mask, what="mask")
    for i, f in enumerate(aux["raw_feats"]):
        assert paux["raw_feats"][i].shape[-2:] == (GRID, GRID)
        assert_close(nhwc(paux["raw_feats"][i]), f, what=f"raw_feats.{i}")
    assert pm.feature_size == GRID
    assert {"backbone.pos_embed", "backbone.cls_token"} <= set(report["loaded"])
    assert all(k.startswith(("backbone_adapter.backbone.", "mask_head.down_", "f1_to_f2",
                             "f2_to_f3")) for k in report["dropped"])


@pytest.mark.parametrize("mode", ["normal", "tta"])
def test_single_predictor_matches_jax(encoder_pair, mode):
    cfg, x, jm, v, pm, _ = encoder_pair
    mean_j, std_j, aux_j = jax_single_predictor(cfg, jm, mode=mode)(v, jnp.asarray(x),
                                                                    jax.random.PRNGKey(0))
    mean, std, aux = make_single_predictor(port_config(cfg), pm, mode=mode)(
        torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert_close(mean, mean_j, what="mean")
    assert_close(std, std_j, what="std")
    for ours, theirs in zip(aux["raw_feats"], aux_j["raw_feats"]):
        assert_close(ours, theirs, what="raw_feats")


def test_export_is_bit_equal_to_jax(encoder_pair):
    """The reference-layout export: the backbone under both paths, its
    position embedding at the module's grid, no BatchNorm statistics."""
    _, _, _, v, pm, _ = encoder_pair
    ours, theirs = export_reference_encoder(pm), jax_export(v)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    for prefix in ("backbone._orig_mod.", "backbone_adapter.backbone._orig_mod."):
        assert ours[prefix + "pos_embed"].shape == (1, 1 + GRID * GRID, SIZE.embed_dim)
        assert not any(k.startswith(prefix) and "running" in k for k in ours)


def test_reference_load_resizes_the_position_embedding(encoder_pair):
    """A reference checkpoint whose backbone is on the 224 grid at 3
    channels loads into the 64^2, 14-channel encoder as JAX's
    ``import_reference_encoder`` takes it: the position embedding resized
    (rel 1e-6), the patch embedding adapted (bit-equal)."""
    cfg, x, jm, v, pm, _ = encoder_pair
    sd = dict(jax_export(v))
    ckpt = timm_checkpoint(5)
    for prefix in ("backbone._orig_mod.", "backbone_adapter.backbone._orig_mod."):
        for k, t in ckpt.items():
            if prefix + k in sd:
                sd[prefix + k] = t.numpy()
    jvars = jax_import(sd, v, backbone_in_channels=CHANNELS)
    enc, _ = port_vit_encoder(cfg.dwi_model, CHANNELS, v)
    load_reference_state_dict(enc, sd)
    jbb = jimp.export_vit_base(jvars["params"]["backbone"])
    for k, t in enc.backbone.state_dict().items():
        if k == "pos_embed":
            assert t.shape == (1, 1 + GRID * GRID, SIZE.embed_dim)
            np.testing.assert_allclose(t.numpy(), jbb[k], rtol=0,
                                       atol=1e-6 * np.abs(jbb[k]).max())
        else:
            np.testing.assert_array_equal(t.numpy(), jbb[k], err_msg=k)
    extra = dict(sd, **{"backbone._orig_mod.blocks.12.norm1.weight": np.ones(48, np.float32)})
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(enc, extra)


@pytest.fixture(scope="module")
def fusion_pair():
    cfg = vit_cfg()
    r = np.random.RandomState(7)
    xd = r.rand(2, IMG, IMG, 14).astype(np.float32)
    xc = r.rand(2, IMG, IMG, 6).astype(np.float32)
    jd, vd = jax_vit_encoder(cfg.dwi_model, 14, xd, seed=11)
    jc, vc = jax_vit_encoder(cfg.dce_model, 6, xc, seed=12)
    _, ad, md = jd.apply(vd, jnp.asarray(xd), train=False)
    _, ac, mc_ = jc.apply(vc, jnp.asarray(xc), train=False)
    jf, vf = jax_fusion(cfg, ad["raw_feats"], ac["raw_feats"], md, mc_, seed=13)
    pd, _ = port_vit_encoder(cfg.dwi_model, 14, vd)
    pc, _ = port_vit_encoder(cfg.dce_model, 6, vc)
    pf, _ = port_fusion(cfg, vf, pd.feature_size)
    return cfg, (xd, xc), (jd, jc, jf), (vd, vc, vf), (pd, pc, pf)


def test_fusion_predictor_tta_matches_jax(fusion_pair):
    """The ViT-backed fusion predictor in ``tta`` (four flips of both
    modalities through both ViT encoders and the fusion head)."""
    cfg, (xd, xc), jmods, jvars, pmods = fusion_pair
    jmean, jstd, jaux = jax_fusion_predictor(cfg, *jmods, mode="tta")(
        *jvars, jnp.asarray(xd), jnp.asarray(xc), jax.random.PRNGKey(0))
    mean, std, aux = make_fusion_predictor(port_config(cfg), *pmods, mode="tta")(
        torch.from_numpy(xd), torch.from_numpy(xc))
    assert_close(mean, jmean, what="mean")
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=0, atol=1e-5)
    assert set(aux) == set(jaux)
    for k, val in jaux.items():
        assert_close(aux[k], val, what=k)


# ---------------------------------------------------------------- training
def vit_batches():
    out = []
    for i in range(2 * STEPS_PER_EPOCH):
        r = np.random.RandomState(20 + i)
        out.append({"imgs": r.rand(4, IMG, IMG, CHANNELS).astype(np.float32),
                    "masks": (r.rand(4, 32, 32, 1) > 0.7).astype(np.float32),
                    "labels": r.randint(0, 4, size=4).astype(np.int64)})
    return out


@pytest.fixture(scope="module")
def trajectories():
    jcfg = vit_cfg().replace(foundation_model_unfreeze_timer=1, batch_size=4)
    data = vit_batches()
    jm, v = jax_vit_encoder(jcfg.dwi_model, CHANNELS, data[0]["imgs"], seed=8)
    labels = np.concatenate([b["labels"] for b in data])
    jstate, jrec = run_jax(jcfg, jm, v, data, labels)
    enc, _ = port_vit_encoder(jcfg.dwi_model, CHANNELS, v)
    pstate, prec = run_port(jcfg, v, data, labels, enc=enc)
    start, final = (port_keyed(jax_export(t)) for t in (v, jstate.variables))
    return jcfg, v, jrec, pstate, prec, start, final


def test_train_trajectory_matches_jax(trajectories):
    """Six steps, three with the backbone group frozen and three after its
    unfreeze: losses and per-group gradient norms to rel 1e-3 per step."""
    _, _, jrec, pstate, prec, _, _ = trajectories
    keys = ["loss", "clf_loss", "mask_loss", "recon_loss", "mimic_loss", "grad_norm"]
    keys += [k for k in jrec[0] if k.startswith("grad_norm_")]
    for k in keys:
        np.testing.assert_allclose([r[k] for r in prec], [r[k] for r in jrec], rtol=1e-3,
                                   err_msg=k)
    assert pstate.opt_state.count.tolist() == [STEPS_PER_EPOCH, 2 * STEPS_PER_EPOCH,
                                               2 * STEPS_PER_EPOCH]


def test_vit_parameters_are_in_the_backbone_group(trajectories):
    """Every ViT parameter, the 3-D ``pos_embed`` and ``cls_token`` too, is
    in group 0 in both packages: unchanged while frozen, then moved."""
    jcfg, v, _, pstate, _, start, final = trajectories
    spec = poptim.build_group_spec([n for n, _ in pstate.model.named_parameters()], True)
    jspec = jax_group_spec(v["params"], True, True)
    assert set(jax.tree.leaves(jspec.group_ids["backbone"])) == {0}
    vit = [n for n in spec.group_ids if n.startswith("backbone.")]
    assert len(vit) == 4 + 12 * 12 and {spec.group_ids[n] for n in vit} == {0}
    diff = upd = 0.0
    for name in vit:
        ours = pstate.model.state_dict()[name].numpy().astype(np.float64)
        assert not np.array_equal(ours, start[name]), name
        diff += ((ours - final[name]) ** 2).sum()
        upd += ((final[name] - start[name].astype(np.float64)) ** 2).sum()
    # the group's update against JAX's in L2, as test_torch_train's
    # test_params_after_steps_match_jax holds each group
    assert np.sqrt(diff / upd) < 5e-2, np.sqrt(diff / upd)


# ---------------------------------------------------------------- builds
@pytest.mark.parametrize("name", VIT_NAMES)
def test_registry_builds_the_vit_names(name, tmp_path):
    """Both names build a ViT: narrow for the tests, and from a timm
    checkpoint on the 224 grid (the import resized, loaded after the
    seeded draw, bit-equal to ``import_vit_base``)."""
    cfg = pconfig.default_parameters()
    mc = dataclasses.replace(cfg.dwi_model, backbone_str=name, input_size=IMG)
    net = build_backbone(mc, 6, layers=SIZE)
    assert isinstance(net, ViTFeatures) and len(net.blocks) == 12
    path = tmp_path / "vit.pth"
    ckpt = timm_checkpoint(3)
    torch.save({"model": ckpt}, path)
    cfg = cfg.replace(dwi_model=mc)
    model, resolved = build_single_model(cfg, "dwi", pretrained_path=str(path), device="cpu",
                                         backbone_layers=SIZE)
    assert resolved.dwi_model.transformer_backbone
    assert resolved.dwi_model.channels == (768, 768, 768)
    ref = pimp.import_vit_base(ckpt, cfg.dwi_channel_num, img_size=IMG,
                               use_advanced_adapt=mc.use_advanced_adapt)
    for k, t in model.backbone.state_dict().items():
        assert torch.equal(t, ref[k]), k
    assert model.feature_size == GRID


@pytest.mark.parametrize("name", ["uni2-h", "uni2h"])
def test_uni2h_still_raises(name):
    mc = dataclasses.replace(pconfig.default_parameters().dwi_model, backbone_str=name)
    with pytest.raises(NotImplementedError, match="UNI2-h"):
        build_backbone(mc, 6)


def test_fresh_vit_draws_the_jax_initialisers():
    """Dense and conv kernels from lecun_normal (truncated at 2 sigma,
    variance 1 / fan_in), pos_embed from normal(0.02), cls_token zero,
    LayerNorms identity; the rest of the encoder keeps the reference rules
    (neck conv U(+-sqrt(1/fan_in)))."""
    enc = Encoder("dwi", port_config(vit_cfg().dwi_model), CHANNELS, 4,
                  backbone_layers=ViTSize(64, 12, 4))
    init_weights(enc, torch.Generator().manual_seed(0))
    enc.requires_grad_(False)
    vit = enc.backbone
    lecun = jax.nn.initializers.lecun_normal()
    for w in (vit.blocks[0].mlp.fc1.weight, vit.blocks[5].attn.qkv.weight,
              vit.patch_embed.proj.weight):
        fan_in = w[0].numel()
        ref = np.asarray(lecun(jax.random.PRNGKey(0), (fan_in, w.shape[0])))
        std = w.std().item()
        assert abs(std / ref.std() - 1) < 0.03 and abs(std * np.sqrt(fan_in) - 1) < 0.03
        assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    assert all(float(b.attn.qkv.bias.abs().sum()) == 0 for b in vit.blocks)
    assert abs(vit.pos_embed.std().item() / 0.02 - 1) < 0.05
    assert float(vit.cls_token.abs().sum()) == 0
    assert torch.equal(vit.blocks[3].norm1.weight, torch.ones(64))
    neck = enc.backbone_adapter.necks["f1"][0].weight
    bound = 1.0 / np.sqrt(neck[0].numel())
    assert neck.abs().max().item() <= bound and neck.abs().max().item() > 0.9 * bound
