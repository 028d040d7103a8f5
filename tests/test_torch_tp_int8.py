"""int8 serving over the mesh's model axis (``ops/quant.py``'s shard route,
``parallel/tensor.py``) on gloo ranks on the CPU, each a process of its own
(``torch_mesh_workers``), on 1x2 and 2x2 meshes, held against the port's
single process and the JAX package's 4x2 GSPMD mesh on the 8 virtual
devices of ``tests/conftest.py``:

* the shard route: a :class:`ShardedQuantConv2d` of Cout 128 (64 a rank),
  3x3, with and without a bias, static and dynamic scales, fp32 and bf16,
  ``torch.equal`` to one process's :class:`QuantConv2d` (the gloo gather is a
  sum with zeros: -0.0 may come back +0.0, which ``torch.equal`` accepts);
  its QuantSet entry the rows ``[lo:hi]`` of one process's, its ``weight_q``
  the shard's rows; the adapter's necks at Cout 128 on int8 shards (int8
  conv, gather, eval BatchNorm, GELU; kernel 2 not called) equal to one
  process's quantized necks;
* ``build_quant_set`` and the calibration on the sharded toy fusion models
  (a (1, 1, 1, 1) ResNet-50 at full width under each encoder): ``kernel_q``,
  ``scale`` and ``bias`` bit-equal to the slices of one process's, ``x_scale``
  within rel 1e-6 (TP's activations round apart from one process's);
* the int8 and int8-prefix (hybrid) predictors on one process's calibrated
  QuantSets cut to the shards: ``tta`` over 1x2 and 2x2 and ``tta_mc`` at
  dropout 0.2 over 1x2 (one data rank: the caller's masks) within 1e-6 of
  one process's; a predictor over the model axis refuses a forward that
  holds whole int8 convs the axis shards;
* ``test_fusion_model(int8=True, calibration_data=val, mesh=)`` at channels
  (64, 128, 256) without a backbone (the Cout-128 3x3 convs sharded and
  quantized), dropout 0.2 on 1x2 and 0 on 2x2: against the port's single
  process (probs rtol 1e-4 / atol 1e-6, ``test_torch_tp.py``'s bounds) and,
  on 2x2, JAX's ``test_fusion_model(int8=True, mesh=make_mesh(4, 2))`` on the
  same weights (``test_torch_tp.py``'s 4x2 bounds).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from test_torch_helpers import assert_close, fusion_stack, port_config, tiny_cfg
from test_torch_mesh import volumes
from test_torch_tp import jax_state

from dmf_tpu import parallel as jparallel
from dmf_tpu.pipeline import run_fusion as jrun_fusion
from dmf_tpu_torch.models import build_fusion_models

MESHES = {"1x2": 2, "2x2": 4}  # name -> world; the model axis is 2
PROBS = dict(rtol=1e-4, atol=1e-6)  # test_torch_tp.py's single-process bounds
PRED_ATOL = 1e-6
KINDS = ("int8", "hybrid")


def wide_cfg(dropout):
    """The toy fusion config at channels (64, 128, 256), no backbone: the
    3x3 convs of Cout 128 are both sharded and quantized at the default
    thresholds."""
    cfg = tiny_cfg(dropout=dropout, use_backbone=False, mc_passes=3).replace(batch_size=4)
    mc = dataclasses.replace(cfg.dwi_model, channels=(64, 128, 256))
    fs = dataclasses.replace(cfg.fusion_model.fusion_specific, dwi_out_channels=256,
                             dce_out_channels=256)
    return cfg.replace(dwi_model=mc, dce_model=mc,
                       fusion_model=dataclasses.replace(mc, fusion_specific=fs))


def rows(t, model_rank, n_model=2):
    n = t.shape[0] // n_model
    return t[model_rank * n:(model_rank + 1) * n]


@pytest.fixture(scope="module")
def case():
    g = torch.Generator().manual_seed(11)
    convs = torch.nn.ModuleDict({"biased": torch.nn.Conv2d(32, 128, 3, padding=1),
                                 "unbiased": torch.nn.Conv2d(32, 128, 3, padding=1,
                                                             bias=False)})
    with torch.no_grad():
        for p in convs.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
    x = torch.randn(2, 32, 8, 8, generator=g).numpy()
    # the adapter's necks at Cout 128 on small maps (test_torch_tp.py's)
    from dmf_tpu_torch.models.adapter import BackboneAdapter
    from dmf_tpu_torch.ops import quant

    adapter = BackboneAdapter((24, 40, 16, 8), ((0,), (1,), (2, 3)), (128, 128, 128))
    with torch.no_grad():
        for name, t in adapter.named_parameters():
            t.copy_(0.1 * torch.randn(t.shape, generator=g) + (1.0 if "4.weight" in name
                                                                or "1.weight" in name else 0.0))
        for name, t in adapter.named_buffers():
            if "running_var" in name:
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif "running_mean" in name:
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    feats = [torch.randn(2, c, 8, 8, generator=g).numpy() for c in (24, 40, 16, 8)]
    neck_qset = quant.build_quant_set(adapter, min_fan_in=64, min_out=8)
    quant.calibrate_act_scales(adapter, neck_qset, [torch.as_tensor(f) for f in feats])
    out = {"conv": dict(convs=convs, x=x, adapter=adapter, feats=feats, neck_qset=neck_qset)}
    # the predictors: ResNet-backed toy models, dropout 0.2
    pcfg = port_config(tiny_cfg(dropout=0.2, use_backbone=True, mc_passes=3))
    models = build_fusion_models(pcfg, "cpu", torch.float32, torch.Generator().manual_seed(0),
                                 backbone_layers=(1, 1, 1, 1))
    calib = (volumes(60, 2, 14), volumes(61, 2, 6))
    out["predict"] = dict(cfg=pcfg, models=models, calibration=calib,
                          requests=[(volumes(62, 2, 14), volumes(63, 2, 6))])
    # the test pass: channels (64, 128, 256), dropout 0 and 0.2, with JAX twins
    r = np.random.RandomState(5)
    test = {"dwi": volumes(64, 10, 14), "dce": volumes(65, 10, 6),
            "labels": r.randint(0, 4, 10).astype(np.int64)}
    val = {"dwi": volumes(66, 8, 14), "dce": volumes(67, 8, 6),
           "labels": r.randint(0, 4, 8).astype(np.int64)}
    serve = {p: (wide_cfg(p),) + fusion_stack(wide_cfg(p), test["dwi"][:2], test["dce"][:2],
                                              seeds=(44, 45, 46))
             for p in (0.0, 0.2)}
    out["serve"] = (serve, test, val)
    return out


def jobs(case, world, single=None):
    """The jobs of one spawn (``single``: the one-process results whose
    QuantSets the mesh predictors take)."""
    case = copy.deepcopy(case)
    serve, test, val = case["serve"]
    p = 0.2 if world == 2 else 0.0
    modes = ("tta", "tta_mc") if world <= 2 else ("tta",)
    qsets = None if single is None else single("predict", world)["qsets"]
    return [
        ("tp_int8_conv", case["conv"]),
        ("tp_int8_predict", dict(case["predict"], qsets=qsets,
                                 cases=[(k, m) for k in KINDS for m in modes])),
        ("tp_test_fusion", dict(cfg=port_config(serve[p][0]), models=serve[p][3],
                                test_data=test, chunks=(None,), int8=True,
                                calibration_data=val)),
    ]


NAMES = ("conv", "predict", "test_fusion")


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    """The single-process runs (the ``tta_mc`` cases and dropout 0.2 for
    the 1x2 mesh), then each mesh's ranks (one spawn a mesh)."""
    def key(name, world):  # the meshes serve different models in the test pass
        return (name, world) if name == "test_fusion" else name

    singles = {}
    for world in (2, 4):
        for name, (job, kw) in zip(NAMES, jobs(case, world)):
            if key(name, world) not in singles:
                singles[key(name, world)] = W.JOBS[job](None, **copy.deepcopy(kw))

    def single(name, world):
        return singles[key(name, world)]

    ranks = {}
    for mesh, world in MESHES.items():
        out = W.spawn(tmp_path_factory.mktemp(f"tp_int8_{world}"), world, "several", n_model=2,
                      jobs=jobs(case, world, single))
        ranks[mesh] = [dict(zip(NAMES, r)) for r in out]
    return single, ranks


# ---------------------------------------------------------------- the shard route
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_int8_conv_is_bit_equal_to_one_process(runs, mesh):
    single, ranks = runs
    ref = single("conv", 2)
    assert len(ref["y"]) == 8  # two convs x static / dynamic x fp32 / bf16
    assert ref["selected_at_min_out_100"] == ["biased", "unbiased"]
    for g, r in enumerate(ranks[mesh]):
        got = r["conv"]
        # the size test is made on the whole conv, not on the shard
        assert got["selected_at_min_out_100"] == ref["selected_at_min_out_100"]
        for key, y in ref["y"].items():
            assert got["y"][key].dtype == y.dtype and torch.equal(got["y"][key], y), key
        # each rank holds its rows of the int8 weight, its scale and bias
        for name, e in ref["qset"].items():
            assert got["shapes"][f"0.{name}"] == ("ShardedQuantConv2d", (64, 3, 3, 32))
            assert ref["shapes"][f"0.{name}"] == ("QuantConv2d", (128, 3, 3, 32))
            assert got["qset"][name].keys() == e.keys()
            for k, t in e.items():
                assert torch.equal(got["qset"][name][k], rows(t, g % 2)), (name, k)


@pytest.mark.parametrize("mesh", MESHES)
def test_int8_neck_shards_take_the_quantized_route(runs, mesh):
    """Int8 conv on the shard, gather, eval BatchNorm and GELU on the whole
    map: equal to one process's quantized necks; kernel 2 not called."""
    single, ranks = runs
    ref = single("conv", 2)
    assert ref["neck_kernel_2"] == 0
    for r in ranks[mesh]:
        got = r["conv"]
        assert got["neck_kernel_2"] == 0
        assert sorted(got["neck_shapes"]) == sorted(ref["neck_shapes"])
        assert len(got["neck_shapes"]) == 6
        for name, (cls, shape) in got["neck_shapes"].items():
            assert cls == "ShardedQuantConv2d" and shape[0] == ref["neck_shapes"][name][1][0] // 2
        for dt, outs in ref["neck"].items():
            for a, b in zip(got["neck"][dt], outs):
                assert torch.equal(a, b), dt


# ---------------------------------------------------------------- QuantSets
@pytest.mark.parametrize("mesh", MESHES)
def test_build_quant_set_on_sharded_models(runs, mesh):
    """From the shards: the weights bit-equal to the slices of one
    process's QuantSet, the calibrated scales within rel 1e-6."""
    single, ranks = runs
    ref = single("predict", MESHES[mesh])["qsets"]
    for g, r in enumerate(ranks[mesh]):
        got = r["predict"]["qsets"]
        n_sharded = 0
        for model, qs in ref.items():
            assert got[model].keys() == qs.keys()
            for name, e in qs.items():
                mine = got[model][name]
                sharded = mine["kernel_q"].shape[0] < e["kernel_q"].shape[0]
                n_sharded += sharded
                for k in ("kernel_q", "scale", "bias"):
                    if k in e:
                        want = rows(e[k], g % 2) if sharded else e[k]
                        assert torch.equal(mine[k], want), (model, name, k)
                np.testing.assert_allclose(float(mine["x_scale"]), float(e["x_scale"]),
                                           rtol=1e-6, err_msg=(model, name))
        assert n_sharded > 20


# ---------------------------------------------------------------- the predictors
def _held(got, ref):
    for (m, s), (rm, rs) in zip(got, ref):
        np.testing.assert_allclose(m.numpy(), rm.numpy(), rtol=0, atol=PRED_ATOL)
        np.testing.assert_allclose(s.numpy(), rs.numpy(), rtol=0, atol=PRED_ATOL)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_int8_tta_predictor_over_the_model_axis(runs, mesh, kind):
    single, ranks = runs
    ref = single("predict", MESHES[mesh])
    for r in ranks[mesh]:
        got = r["predict"]
        _held(got["y"][(kind, "tta")], ref["y"][(kind, "tta")])
        # each rank's int8 weights: its rows of every sharded conv
        shards = {n: s for n, (c, s) in got["shapes"].items() if c == "ShardedQuantConv2d"}
        assert len(shards) > 20 and got["shapes"].keys() == ref["shapes"].keys()
        for n, s in shards.items():
            assert s[0] * 2 == ref["shapes"][n][1][0] and s[1:] == ref["shapes"][n][1][1:], n


@pytest.mark.parametrize("kind", KINDS)
def test_int8_tta_mc_predictor_over_1x2(runs, kind):
    """Dropout 0.2, one data rank: the caller's generator, one process's masks."""
    single, ranks = runs
    ref = single("predict", 2)["y"][(kind, "tta_mc")]
    fp = single("predict", 2)["y"][(kind, "tta")]
    assert not torch.equal(ref[0][1], fp[0][1])  # the MC passes spread
    for r in ranks["1x2"]:
        _held(r["predict"]["y"][(kind, "tta_mc")], ref)


def test_model_axis_refuses_a_whole_int8_forward(runs):
    for rs in runs[1].values():
        for r in rs:
            assert "whole int8 conv" in r["predict"]["refused"]


# ---------------------------------------------------------------- the test pass
@pytest.mark.parametrize("mesh", MESHES)
def test_test_fusion_model_int8_over_the_model_axis(runs, mesh):
    single, ranks = runs
    ref = single("test_fusion", MESHES[mesh])[None]
    for r in ranks[mesh]:
        got = r["test_fusion"][None]
        np.testing.assert_allclose(got["probs"], ref["probs"], **PROBS)
        np.testing.assert_allclose(got["std"], ref["std"], **PROBS)
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        np.testing.assert_allclose(got["modality_attention"], ref["modality_attention"],
                                   **PROBS)


def test_test_fusion_model_int8_matches_jax_4x2(case, runs):
    """The 2x2 run (dropout 0) against JAX's int8 ``test_fusion_model`` on
    ``make_mesh(4, 2)``, the same weights and calibration split."""
    serve, test, val = case["serve"]
    cfg, jmods, jvars, _ = serve[0.0]
    theirs = jrun_fusion.test_fusion_model(cfg, *jmods, jax_state(jvars), test, seed=0,
                                           int8=True, calibration_data=val,
                                           mesh=jparallel.make_mesh(4, 2))
    for r in runs[1]["2x2"]:
        got = r["test_fusion"][None]
        assert_close(got["probs"], theirs["probs"], what="probs")
        assert_close(got["modality_attention"], theirs["modality_attention"], what="attention")
