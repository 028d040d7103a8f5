"""The port's ``parallel/sharding.py::param_spec`` against the JAX package's
``dmf_tpu/parallel/sharding.py::param_spec`` over a 2-way model axis, for
every parameter of the toy fusion network (with and without a ResNet
backbone), the toy ``hybrid-nb`` encoder and the toy ViT-backed encoder.

Each port parameter is traced to its JAX leaves by value: every JAX leaf is
filled once with its leaf number and once with its elements' flat indices,
exported through ``dmf_tpu.models.ref_ckpt.export_reference_*`` and loaded
into the port with ``load_reference_state_dict``.  A port parameter is then
sharded exactly where its JAX leaves are, and each rank's shard holds:

* the elements of JAX's shard of each leaf (the same axis, the same rows),
  the cross-attention's packed ``in_proj`` included (JAX's contiguous split
  of each of ``q_proj``/``k_proj``/``v_proj``);
* for a packed ``attn.qkv`` (one JAX leaf, whose contiguous split GSPMD
  reshards), the JAX leaf's output axis too, and the q, k and v rows of
  whole heads: the rank's own heads.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_helpers import (BACKBONE_LAYERS, hybrid_cfg, init_shapes, jax_encoder,
                                port_config, resnet_layers, tiny_cfg)
from test_torch_vit import CHANNELS, IMG, SIZE, jax_vit_encoder, vit_cfg

from dmf_tpu.models import FusionModel as JaxFusion
from dmf_tpu.models.ref_ckpt import export_reference_encoder, export_reference_fusion
from dmf_tpu.parallel.sharding import param_spec as jax_param_spec
from dmf_tpu_torch.models import Encoder, FusionModel, load_reference_state_dict
from dmf_tpu_torch.parallel.sharding import param_spec, state_shardings
from dmf_tpu_torch.parallel.tensor import ShardSpec, shard_index
from dmf_tpu_torch.train import TrainState

M = 2  # the model axis


BASE = 1_000_000  # leaf numbers from here: no exporter default reaches it


def filled(variables, how):
    """``variables`` with every leaf filled with its leaf number (``BASE +
    1``, ``BASE + 2``, ...) or with its elements' flat indices."""
    count = [0]

    def fill(path, leaf):
        count[0] += 1
        shape = tuple(leaf.shape)
        if how == "leaf":
            return np.full(shape, BASE + count[0], np.float32)
        return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)

    return jax.tree_util.tree_map_with_path(fill, variables)


def traced(variables, export, build):
    """``{port parameter name: (leaf numbers, flat indices)}`` of a port
    model built by ``build()`` and loaded from ``export(filled(...))``, and
    the JAX leaves by number: ``{number: (params path, leaf)}`` (``None``
    for a ``batch_stats`` leaf)."""
    leaves = {}
    for k, (path, leaf) in enumerate(jax.tree_util.tree_leaves_with_path(variables)):
        leaves[BASE + k + 1] = (path[1:], leaf) if path[0].key == "params" else None
    out = {}
    models = []
    for how in ("leaf", "index"):
        model = build()
        load_reference_state_dict(model, export(filled(variables, how)))
        models.append(dict(model.named_parameters()))
    for name, ids in models[0].items():
        out[name] = (ids.detach().numpy().astype(np.int64),
                     models[1][name].detach().numpy().astype(np.int64))
    return out, leaves, models[0]


def jax_shard_coords(spec, leaf):
    """The leaf's axis sharded by a JAX spec, or ``None``."""
    axes = [i for i, a in enumerate(tuple(spec)) if a is not None]
    assert len(axes) <= 1, spec
    return axes[0] if axes else None


def check(name, ids, idx, leaves, param, heads=None):
    spec = param_spec(name, param, M)
    if not all(leaves.get(int(lid)) for lid in np.unique(ids)):
        # no JAX parameter behind it (a slot the exporter fills by default)
        assert spec is None, name
        return 0
    jax_specs = {}
    for lid in np.unique(ids):
        path, leaf = leaves[int(lid)]
        jax_specs[int(lid)] = (jax_param_spec(path, leaf, M), leaf)
    if spec is None:
        assert all(s == P() for s, _ in jax_specs.values()), (name, jax_specs)
        return 0
    assert all(s != P() for s, _ in jax_specs.values()), (name, spec, jax_specs)
    packed_leaf = spec.packs == 3 and len(jax_specs) == 1
    for r in range(M):
        rows = shard_index(spec, param.shape[spec.dim], M, r).numpy()
        sid = np.take(ids, rows, axis=spec.dim).reshape(-1)
        six = np.take(idx, rows, axis=spec.dim).reshape(-1)
        coords = {}
        for lid, (jspec, leaf) in jax_specs.items():
            axis = jax_shard_coords(jspec, leaf)
            sel = sid == lid
            coords[lid] = np.unravel_index(six[sel], leaf.shape)[axis]
            n = leaf.shape[axis]
            if packed_leaf:
                # JAX's (in, 3C) qkv: the output axis, the rank's own heads
                assert axis == leaf.ndim - 1, (name, jspec)
                c = n // 3
                d = c // heads
                h = heads // M
                want = {t * c + hh * d + j for t in range(3) for hh in range(r * h, (r + 1) * h)
                        for j in range(d)}
                assert set(np.unique(coords[lid]).tolist()) == want, (name, r)
            else:
                lo, hi = r * n // M, (r + 1) * n // M
                assert coords[lid].min() >= lo and coords[lid].max() < hi, (name, r, lid)
                # every element of JAX's shard of the leaf is in the port's
                assert sel.sum() == int(np.prod(leaf.shape)) // M, (name, r, lid)
    return 1


def check_model(variables, export, build, heads):
    """Check every parameter; returns the names of the sharded ones."""
    out, leaves, params = traced(variables, export, build)
    sharded = set()
    for name, (ids, idx) in out.items():
        head = heads.get(name.split(".attn.qkv")[0]) if ".attn.qkv" in name else None
        if check(name, ids, idx, leaves, params[name], head):
            sharded.add(name)
    return sharded


def fusion_variables(cfg, seed):
    x = np.zeros((2, 32, 32, 14), np.float32)
    jd, vd = jax_encoder(cfg.dwi_model, 14, x, seed=seed)
    _, aux, mask = jax.eval_shape(lambda v, xx: jd.apply(v, xx, train=False), vd, x)
    feats, mask = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), (aux["raw_feats"], mask))
    jf = JaxFusion(config=cfg.fusion_model, num_classes=cfg.class_num)
    return vd, init_shapes(jf, feats, feats, mask, mask)


@pytest.mark.parametrize("use_backbone", [False, True], ids=["no-backbone", "resnet"])
def test_fusion_network_shards_as_jax(use_backbone):
    cfg = tiny_cfg(use_backbone=use_backbone)
    pcfg = port_config(cfg)
    vd, vf = fusion_variables(cfg, seed=1)

    def encoder():
        return Encoder("dwi", pcfg.dwi_model, 14, 4, backbone_layers=BACKBONE_LAYERS)

    with resnet_layers(BACKBONE_LAYERS):
        enc = check_model(vd, export_reference_encoder, encoder, {})
    size = encoder().feature_size
    fus = check_model(vf, export_reference_fusion,
                      lambda: FusionModel(pcfg.fusion_model, pcfg.class_num, 32, 32, size), {})
    # the cross-attention's in_proj (weight, bias) and out_proj's weight
    assert fus == {"cross_attn_block.cross_attn." + k
                   for k in ("in_proj_weight", "in_proj_bias", "out_proj.weight")}
    # a (1, 1, 1, 1) ResNet-50: its convs with Cout >= 128; none without
    assert all(k.startswith("backbone.") for k in enc)
    assert (len(enc) > 10) == use_backbone and (not enc) == (not use_backbone)


def test_hybrid_encoder_shards_as_jax():
    cfg = hybrid_cfg()
    x = np.zeros((2, 32, 32, 14), np.float32)
    _, v = jax_encoder(cfg.dwi_model, 14, x, seed=2)
    pcfg = port_config(cfg)
    sharded = check_model(v, export_reference_encoder,
                          lambda: Encoder("dwi", pcfg.dwi_model, 14, 4,
                                          backbone_layers=BACKBONE_LAYERS),
                          {f"transformer.transformer.layers.{i}": 2 for i in range(2)})
    # per block qkv (weight, bias), proj, fc1 (weight, bias), fc2
    assert sharded == {f"transformer.transformer.layers.{i}.{k}" for i in range(2)
                       for k in ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                                 "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")}
    # state_shardings names the same shards for a train state
    state = TrainState.create(Encoder("dwi", pcfg.dwi_model, 14, 4))
    specs = state_shardings(state, types.SimpleNamespace(shape={"data": 4, "model": M}))
    assert {n for n, spec in specs.items() if spec is not None} == sharded
    spec = param_spec("transformer.transformer.layers.0.attn.qkv.weight",
                      torch.zeros(96, 32), M)
    assert spec == ShardSpec(0, 3)


def test_vit_encoder_shards_as_jax():
    cfg = vit_cfg()
    x = np.zeros((2, IMG, IMG, CHANNELS), np.float32)
    _, v = jax_vit_encoder(cfg.dwi_model, CHANNELS, x, seed=4)
    pcfg = port_config(cfg)
    sharded = check_model(v, export_reference_encoder,
                          lambda: Encoder("dwi", pcfg.dwi_model, CHANNELS, 4,
                                          backbone_layers=SIZE),
                          {f"backbone.blocks.{i}": SIZE.num_heads for i in range(SIZE.depth)})
    # per block qkv (weight, bias) and proj; the ViT's mlp_fc1/2 (JAX's
    # mlp_fc1/mlp_fc2) stay whole
    assert sharded == {f"backbone.blocks.{i}.attn.{k}" for i in range(SIZE.depth)
                       for k in ("qkv.weight", "qkv.bias", "proj.weight")}


def test_param_spec_rules():
    z = torch.zeros
    # a 1-way axis shards nothing; narrow convs, conv biases, norms and the
    # SE MLP convs (JAX's Dense layers) stay whole
    assert param_spec("block3.bottlenecks.0.7.weight", z(256, 64, 1, 1), 1) is None
    assert param_spec("block3.bottlenecks.0.7.weight", z(256, 64, 1, 1), 2) == ShardSpec(0)
    assert param_spec("block1.bottlenecks.0.7.weight", z(64, 32, 1, 1), 2) is None
    assert param_spec("block3.se.fc.3.weight", z(256, 128, 1, 1), 2) is None
    assert param_spec("backbone_adapter.necks.f1.0.bias", z(256), 2) is None
    assert param_spec("trans_out_proj.weight", z(130, 64, 1, 1), 4) is None
    # row-parallel weights on dim 1; their biases whole
    assert param_spec("x.attn.proj.weight", z(32, 32), 2) == ShardSpec(1)
    assert param_spec("x.attn.proj.bias", z(32), 2) is None
    assert param_spec("transformer.transformer.layers.3.mlp.fc2.weight", z(32, 128), 2) == \
        ShardSpec(1)
    assert param_spec("fusion.cross_attn_block.cross_attn.in_proj_bias", z(48), 2) == \
        ShardSpec(0, 3)
    with pytest.raises(ValueError, match="head-aligned"):
        param_spec("x.attn.qkv.weight", z(12, 4), 3)


@pytest.mark.parametrize("kernel", [1, 3])
@pytest.mark.parametrize("fmt", [torch.channels_last, torch.contiguous_format])
def test_conv_shard_keeps_the_weights_strides(kernel, fmt):
    """A conv shard keeps its weight's strides, those of a 1x1 kernel's
    size-1 dims too, which ``is_contiguous`` does not tell apart: cuDNN picks
    the conv's output format from them, and a dropout after the conv draws
    its mask in that format's memory order."""
    from dmf_tpu_torch.parallel.tensor import ShardedConv2d

    conv = torch.nn.Conv2d(64, 128, kernel, bias=False).to(memory_format=fmt)
    whole = conv.weight.detach().clone()
    for r in range(M):
        shard = ShardedConv2d(conv, types.SimpleNamespace(n_model=M, model_rank=r), ShardSpec(0))
        want = torch.empty((64, 64, kernel, kernel), memory_format=fmt).stride()
        assert shard.weight.stride() == want
        assert torch.equal(shard.weight, whole[64 * r:64 * (r + 1)])
