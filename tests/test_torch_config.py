"""The port's own configuration tree vs the JAX package's, and the port's
independence from the JAX package.

The port copies ``dmf_tpu/config.py``'s dataclasses rather than importing
them; these tests hold the copy to the original through ``to_dict`` and scan
every module of the port, and ``chip_smoke.py``, for imports of ``dmf_tpu``,
``jax`` or ``flax``.
"""

import ast
import dataclasses
from pathlib import Path

import pytest

from test_torch_helpers import hybrid_cfg, port_config, tiny_cfg

from dmf_tpu import config as jconfig
from dmf_tpu_torch import config as pconfig

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("dmf_tpu", "jax", "flax")


def _hybrid_nb(cfg_mod):
    """``bench.py --encoder hybrid-nb`` (:517-521, :534-535) in either package."""
    cfg = cfg_mod.default_parameters()
    mc = cfg_mod.resolve_backbone_config(dataclasses.replace(
        cfg.dwi_model, use_backbone=False, use_hybrid_transformer=True))
    return cfg.replace(dwi_model=mc, dce_model=mc, fusion_model=dataclasses.replace(
        mc, fusion_specific=cfg.fusion_model.fusion_specific))


@pytest.mark.parametrize("build", ["default", "hybrid-nb", "tiny", "hybrid-toy"])
def test_config_matches_jax(build):
    make = {"default": lambda m: m.default_parameters(),
            "hybrid-nb": _hybrid_nb,
            "tiny": None, "hybrid-toy": None}[build]
    if make is not None:
        ours, theirs = make(pconfig), make(jconfig)
    else:
        theirs = tiny_cfg() if build == "tiny" else hybrid_cfg()
        ours = port_config(theirs)
    assert isinstance(ours, pconfig.Config)
    assert ours.to_dict() == theirs.to_dict()
    assert pconfig.Config.from_dict(theirs.to_dict()) == ours
    assert (ours.dwi_channel_num, ours.dce_channel_num, ours.min_epochs) == (
        theirs.dwi_channel_num, theirs.dce_channel_num, theirs.min_epochs)


@pytest.mark.parametrize("backbone", sorted(jconfig._BACKBONE_DERIVED))
def test_resolve_backbone_config_matches_jax(backbone):
    mc_j = dataclasses.replace(jconfig.ModelConfig(), backbone_str=backbone)
    mc_p = dataclasses.replace(pconfig.ModelConfig(), backbone_str=backbone)
    assert (dataclasses.asdict(pconfig.resolve_backbone_config(mc_p))
            == dataclasses.asdict(jconfig.resolve_backbone_config(mc_j)))
    with pytest.raises(ValueError, match="backbone_str"):
        pconfig.resolve_backbone_config(
            dataclasses.replace(mc_p, backbone_str="no-such-backbone"))


def test_json_round_trip(tmp_path):
    cfg = _hybrid_nb(pconfig)
    path = tmp_path / "cfg.json"
    cfg.save(str(path))
    assert pconfig.Config.load(str(path)) == cfg


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_sources():
    pkg = ROOT / "dmf_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts
                  ) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_scan_sees_the_forbidden_forms(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy\nfrom dmf_tpu.config import Config\nimport flax\n"
                     "from dmf_tpu_torch.ops import attention\nfrom .config import Config\n")
    assert [m for m in _imports(probe) if m.split(".")[0] in FORBIDDEN] == [
        "jax.numpy", "dmf_tpu.config", "flax"]


def _reference_dicts():
    """The reference layouts ``from_reference_dict`` is held on: the default
    config's own, one with fp16 AMP, derived, environment and unknown keys,
    and the ``hybrid-nb`` geometry's."""
    base = jconfig.to_reference_dict(jconfig.default_parameters())
    odd = jconfig.to_reference_dict(jconfig.default_parameters())
    odd.update(precision="16-mixed", dwi_channel_num=99, min_epochs=-1,
               data_key_mod="_fold", nyul_path="store/nyul.npy", no_such_key=3,
               batch_size=16, methods=["dce"])
    odd["dwi_model_parameters"] = dict(odd["dwi_model_parameters"], input_size=128,
                                       unknown_model_key=1, channels=[16, 32, 64])
    odd["dwi_model_parameters"]["optimizer_parameters"] = dict(
        odd["dwi_model_parameters"]["optimizer_parameters"], name="adamW", lr=3e-4)
    odd["early_stopping_parameters"] = {"metric": "val_loss", "mode": "min"}
    del odd["fusion_model_parameters"]
    return {"default": base, "odd": odd,
            "hybrid-nb": jconfig.to_reference_dict(_hybrid_nb(jconfig))}


@pytest.mark.parametrize("name", ["default", "odd", "hybrid-nb"])
@pytest.mark.parametrize("overrides", [{}, {"seed": 7, "batch_size": 4, "base_path": "b"}],
                         ids=["plain", "overrides"])
def test_from_reference_dict_matches_jax(name, overrides):
    d = _reference_dicts()[name]
    ours = pconfig.from_reference_dict(d, **overrides)
    theirs = jconfig.from_reference_dict(d, **overrides)
    assert isinstance(ours, pconfig.Config)
    assert ours.to_dict() == theirs.to_dict()
    if name == "odd":
        assert ours.precision == "bf16-mixed" and ours.dwi_channel_num != 99
        assert ours.dwi_model.optimizer.name == "adamw"
    for k, v in overrides.items():
        assert getattr(ours, k) == v
