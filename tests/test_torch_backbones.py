"""Pretrained backbones and the reference-layout export: the port against the
JAX package, bit for bit, on the CPU.

* the first-conv adaptations and the RadImageNet key remap on random OIHW
  weights and key sets;
* ``import_resnet50`` on full-depth ResNet-50 checkpoints drawn from a
  numpy seed (timm resnet50 and resnet50d layouts, the Lab-Rasool one through
  the remap; simple and advanced adaptation) against JAX's import read back
  through ``export_resnet50``: numpy only, no XLA compile;
* truncated checkpoints and the tensor-count guard raise in both packages;
* ``build_single_model(..., pretrained_path=)`` and ``build_backbone`` load
  the import from a file; the ViT and DINO names raise;
* ``export_reference_encoder`` / ``export_reference_fusion`` against JAX's
  exporters on the weights of ``fusion_stack`` (fillers included), and the
  Lightning file round trip.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import (BACKBONE_LAYERS, fusion_stack, port_config, resnet_layers,
                                tiny_cfg, volumes)

from dmf_tpu.models import ref_ckpt
from dmf_tpu.models.backbones import importers as jimp
from dmf_tpu_torch import default_parameters
from dmf_tpu_torch.models import (Encoder, FusionModel, export_reference_encoder,
                                  export_reference_fusion, load_lightning_ckpt,
                                  load_reference_state_dict, save_lightning_ckpt)
from dmf_tpu_torch.models.backbones import ResNetFeatures, build_backbone
from dmf_tpu_torch.models.backbones import importers as pimp
from dmf_tpu_torch.pipeline import build_single_model

RASOOL_STAGES = {"conv1.": "0.", "bn1.": "1.", "layer1.": "4.", "layer2.": "5.",
                 "layer3.": "6.", "layer4.": "7."}


def timm_checkpoint(deep_stem, seed, counters=False):
    """A timm-layout ResNet-50 (resnet50d with ``deep_stem``) state dict of
    numpy arrays drawn from ``seed``, with timm's ``fc`` head; BatchNorm
    variances positive.  ``counters`` adds the ``num_batches_tracked``
    buffers a torch save carries."""
    rng = np.random.RandomState(seed)
    shapes = ResNetFeatures(3, deep_stem=deep_stem, avg_down=deep_stem,
                            device="meta").state_dict()
    sd = {}
    for k, t in shapes.items():
        if k.endswith("num_batches_tracked"):
            if counters:
                sd[k] = np.asarray(rng.randint(0, 1000), np.int64)
            continue
        arr = 0.1 * rng.standard_normal(tuple(t.shape)).astype(np.float32)
        sd[k] = np.abs(arr) + 0.5 if k.endswith("running_var") else arr
    sd["fc.weight"] = rng.standard_normal((1000, 2048)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def rasool_layout(sd):
    """The Lab-Rasool layout of a timm state dict: a ``backbone.`` prefix,
    the stem as ``0.``/``1.``, the stages as ``4.``-``7.``, and an ``fc.``
    head (foundation_model.py:180-218 maps it back)."""
    out = {}
    for k, v in sd.items():
        for timm, rasool in RASOOL_STAGES.items():
            if k.startswith(timm):
                k = rasool + k[len(timm):]
                break
        out["backbone." + k] = v
    return out


@pytest.fixture(scope="module")
def checkpoints():
    plain = timm_checkpoint(False, 0)
    return {"resnet50": plain, "resnet50d": timm_checkpoint(True, 1, counters=True),
            "radimagenet": rasool_layout(plain)}


def jax_import(sd, layout, in_channels, advanced):
    if layout == "radimagenet":
        sd = jimp.map_rasool_to_timm_keys(sd)
    deep = layout == "resnet50d"
    params, stats = jimp.import_resnet50(sd, in_channels, use_advanced_adapt=advanced,
                                         deep_stem=deep)
    return jimp.export_resnet50(params, stats, deep_stem=deep)


def port_import(sd, layout, in_channels, advanced):
    if layout == "radimagenet":
        sd = pimp.map_rasool_to_timm_keys(sd)
    return pimp.import_resnet50(sd, in_channels, use_advanced_adapt=advanced,
                                deep_stem=layout == "resnet50d")


def assert_bit_equal(port, ref):
    """Same keys; each tensor the same dtype, shape and bits."""
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        p = port[k].numpy() if isinstance(port[k], torch.Tensor) else np.asarray(port[k])
        v = np.asarray(v)
        assert p.dtype == v.dtype and p.shape == v.shape, k
        assert np.array_equal(p, v), k


@pytest.mark.parametrize("adapt", ["adapt_first_conv", "advanced_adapt_first_conv"])
@pytest.mark.parametrize("cin", [3, 1])
@pytest.mark.parametrize("cout", [14, 6])
def test_adapt_first_conv_matches_jax(adapt, cin, cout):
    w = np.random.RandomState(cin * 100 + cout).standard_normal((64, cin, 7, 7)).astype(
        np.float32)
    ours, theirs = getattr(pimp, adapt)(w, cout), getattr(jimp, adapt)(w, cout)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == (64, cout, 7, 7)
    assert np.array_equal(ours, theirs)
    assert getattr(pimp, adapt)(w, cin) is w  # already the right width


def test_rasool_remap_matches_jax(checkpoints):
    sd = checkpoints["radimagenet"]
    ours, theirs = pimp.map_rasool_to_timm_keys(sd), jimp.map_rasool_to_timm_keys(sd)
    assert list(ours) == list(theirs)
    assert set(ours) == set(checkpoints["resnet50"]) - {"fc.weight", "fc.bias"}


@pytest.mark.parametrize("advanced", [True, False], ids=["advanced", "simple"])
@pytest.mark.parametrize("layout,in_channels", [("resnet50", 14), ("resnet50d", 6),
                                                ("radimagenet", 14)])
def test_import_resnet50_matches_jax(checkpoints, layout, in_channels, advanced):
    sd = checkpoints[layout]
    ours = port_import(sd, layout, in_channels, advanced)
    theirs = jax_import(sd, layout, in_channels, advanced)
    if layout == "resnet50d":
        # JAX drops the counters (its export writes 0); the port keeps them
        counters = [k for k in ours if k.endswith("num_batches_tracked")]
        assert counters and all(int(ours[k]) == int(sd[k]) for k in counters)
        ours = {k: (torch.zeros((), dtype=torch.int64) if k in counters else v)
                for k, v in ours.items()}
    assert_bit_equal(ours, theirs)
    stem = "conv1.0.weight" if layout == "resnet50d" else "conv1.weight"
    assert ours[stem].shape[1] == in_channels
    # the module takes the import as it is
    net = ResNetFeatures(in_channels, deep_stem=layout == "resnet50d",
                         avg_down=layout == "resnet50d")
    net.load_state_dict(ours)


def test_truncated_checkpoint_raises_in_both(checkpoints):
    sd = checkpoints["resnet50"]
    cut = {k: v for k, v in sd.items() if not k.startswith("layer4.")}
    with pytest.raises(KeyError):
        jimp.import_resnet50(cut, 14)
    with pytest.raises(KeyError):
        pimp.import_resnet50(cut, 14)
    # the tensor-count guard counts what JAX counts (conv weights and the four
    # BatchNorm arrays, no counters): the same count passes and one more raises
    n = sum(1 for k in sd if not k.startswith("fc.") and not k.endswith("num_batches_tracked"))
    for imp in (jimp.import_resnet50, pimp.import_resnet50):
        imp(sd, 14, min_tensors=n)
        with pytest.raises(RuntimeError, match="few tensors"):
            imp(sd, 14, min_tensors=n + 1)
    bad = dict(sd, **{"layer1.0.conv2.weight": sd["layer1.0.conv2.weight"][:, :32]})
    with pytest.raises(ValueError, match="shape mismatch"):
        pimp.import_resnet50(bad, 14)


def save_checkpoint(path, sd):
    """A file as a training script writes one: tensors under ``state_dict``
    beside a numpy scalar, which only a full unpickling reads."""
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "epoch": np.int64(90)}, path)
    return str(path)


@pytest.mark.parametrize("method", ["dwi", "dce"])
def test_build_single_model_loads_the_import(checkpoints, tmp_path, method):
    path = save_checkpoint(tmp_path / "rasool.pth", checkpoints["radimagenet"])
    cfg = default_parameters()  # radimagenet, advanced adaptation
    model, _ = build_single_model(cfg, method, pretrained_path=path, device="cpu")
    plain, _ = build_single_model(cfg, method, device="cpu")
    chan = cfg.channel_num(method)
    expect = jax_import(checkpoints["radimagenet"], "radimagenet", chan,
                        cfg.model_config(method).use_advanced_adapt)
    assert_bit_equal(model.backbone.state_dict(), expect)
    # the seeded draw of everything else is the build's without a checkpoint
    rest = plain.state_dict()
    for k, v in model.state_dict().items():
        if not k.startswith("backbone."):
            assert torch.equal(v, rest[k]), k


def test_build_backbone_resnet50d_from_file(checkpoints, tmp_path):
    path = save_checkpoint(tmp_path / "resnet50d.pth", checkpoints["resnet50d"])
    mc = dataclasses.replace(default_parameters().dwi_model, backbone_str="resnet50d",
                             use_advanced_adapt=False)
    net = build_backbone(mc, 6, pretrained_path=path)
    assert_bit_equal(net.state_dict(), port_import(checkpoints["resnet50d"], "resnet50d", 6,
                                                   False))
    assert isinstance(net.conv1, torch.nn.Sequential)


@pytest.mark.parametrize("name", ["vit_base_patch16_224", "dino_vitbase16_pretrain"])
def test_vit_backbones_raise(name):
    """The ViT names raised NotImplementedError until the ViT/DINO backbone
    was ported (ROADMAP 1.9); now ``build_single_model`` builds the
    full-width ViT-B/16 encoder for both (test_torch_vit.py holds it
    against JAX)."""
    from dmf_tpu_torch.models.backbones import ViTFeatures

    cfg = default_parameters()
    cfg = cfg.replace(dwi_model=dataclasses.replace(cfg.dwi_model, backbone_str=name))
    model, resolved = build_single_model(cfg, "dwi", device="cpu")
    vit = model.backbone
    assert isinstance(vit, ViTFeatures) and len(vit.blocks) == 12
    assert vit.pos_embed.shape == (1, 257, 768) and vit.blocks[0].attn.num_heads == 12
    assert resolved.dwi_model.channels == (768, 768, 768) and model.feature_size == 16


@pytest.fixture(scope="module", params=[True, False], ids=["backbone", "no_backbone"])
def stack(request):
    cfg = tiny_cfg(use_backbone=request.param)
    xd, xc = volumes(0)
    _, variables, ports = fusion_stack(cfg, xd, xc)
    return cfg, variables, ports


def test_export_matches_jax(stack):
    """The port's exports of the fusion stack's models are JAX's exports of the
    same weights, key for key and bit for bit, the seeded fillers included."""
    _, (vd, vc, vf), (pd, pc, pf) = stack
    with resnet_layers(BACKBONE_LAYERS):
        pairs = [(export_reference_encoder(pd, seed=3), ref_ckpt.export_reference_encoder(vd, 3)),
                 (export_reference_encoder(pc), ref_ckpt.export_reference_encoder(vc)),
                 (export_reference_fusion(pf, seed=2), ref_ckpt.export_reference_fusion(vf, 2))]
    for ours, theirs in pairs:
        assert_bit_equal(ours, theirs)
    ours = pairs[0][0]
    if any(k.startswith("backbone.") for k in ours):
        assert any(k.startswith("backbone._orig_mod.") for k in ours)
        assert any(k.startswith("backbone_adapter.backbone._orig_mod.") for k in ours)


def test_lightning_round_trip(stack, tmp_path):
    """save -> load -> a fresh model of other weights, strictly: every tensor
    the exported one."""
    cfg, _, (pd, _, pf) = stack
    pcfg = port_config(cfg)
    for name, model, export, fresh in (
            ("enc", pd, export_reference_encoder,
             Encoder("dwi", pcfg.dwi_model, 14, 4, backbone_layers=BACKBONE_LAYERS)),
            ("fusion", pf, export_reference_fusion,
             FusionModel(pcfg.fusion_model, 4, dwi_channels=32, dce_channels=32,
                         feature_size=pd.feature_size))):
        path = str(tmp_path / f"{name}.ckpt")
        save_lightning_ckpt(path, export(model))
        raw = torch.load(path, weights_only=True)["state_dict"]
        assert all(k.startswith("model.") for k in raw)
        report = load_reference_state_dict(fresh, load_lightning_ckpt(path))
        assert all(k.startswith(("backbone_adapter.backbone.", "mask_head.down_", "f1_to_f2.",
                                 "f2_to_f3.")) for k in report["dropped"])
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
