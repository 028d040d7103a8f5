"""The port's data-preparation slice vs ``dmf_tpu`` in fp32 on the CPU.

Splits and synthetic data, the nearest resize, the ADC fit, the DCE max
normalisation, the Nyul standardizer (fit, file format, exact and fast
transforms), augmentation, the per-modality processor, and the slice as a
whole: ``prepare_single_data`` + ``export_processed_splits`` on 32^2
synthetic data.  The JAX side runs on the CPU, where its processor takes the
exact Nyul route, as the port's does for CPU tensors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import port_config

from dmf_tpu.config import default_parameters
from dmf_tpu.data import augment as jaug
from dmf_tpu.data import modality as jmod
from dmf_tpu.data import preprocess as jpre
from dmf_tpu.data import splits as jsplits
from dmf_tpu.data import synthetic as jsyn
from dmf_tpu.ops import resize as jresize
from dmf_tpu.pipeline import prepare_single as jprep
from dmf_tpu_torch.config import resolve_backbone_config
from dmf_tpu_torch.data import augment as paug
from dmf_tpu_torch.data import modality as pmod
from dmf_tpu_torch.data import preprocess as ppre
from dmf_tpu_torch.data import splits as psplits
from dmf_tpu_torch.data import synthetic as psyn
from dmf_tpu_torch.ops import resize as presize
from dmf_tpu_torch.pipeline import prepare_single as pprep

TOL = 1e-5
CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(_np(port), np.asarray(ref), rtol=tol, atol=tol)


def _cfg(base, compat=True, size=32):
    """The default config cut to 32^2 inputs, writing under ``base``."""
    cfg = default_parameters(base_path=str(base), reference_compat=compat)
    mc = dataclasses.replace(cfg.dwi_model, input_size=size)
    return cfg.replace(dwi_model=mc, dce_model=mc)


@pytest.fixture(scope="module")
def raw():
    return jsyn.make_synthetic_arrays(n_train=20, n_test=6, image_size=32, mask_size=64,
                                      seed=3)


# ------------------------------------------------------- splits, synthetic

@pytest.mark.parametrize("fold", [0, 4])
def test_splits_equal_jax(fold):
    labels = np.random.RandomState(fold).randint(0, 4, size=53)
    for a, b in zip(psplits.train_val_indices(labels, 5, 4, fold, 42),
                    jsplits.train_val_indices(labels, 5, 4, fold, 42)):
        np.testing.assert_array_equal(a, b)
    imgs = np.arange(53)[:, None]
    masks = imgs * 2
    for pa, ja in zip(psplits.data_segmentation_mask(imgs, masks, labels, 5, 4, fold),
                      jsplits.data_segmentation_mask(imgs, masks, labels, 5, 4, fold)):
        for a, b in zip(pa, ja):
            np.testing.assert_array_equal(a, b)


def test_synthetic_equal_jax():
    kw = dict(n_train=5, n_test=3, image_size=16, mask_size=8, seed=9)
    p, j = psyn.make_synthetic_arrays(**kw), jsyn.make_synthetic_arrays(**kw)
    assert p.keys() == j.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], j[k])


@pytest.mark.parametrize("src,dst", [((64, 64), (32, 32)), ((12, 10), (7, 9)),
                                     ((8, 8), (20, 24))])
def test_resize_nearest(src, dst):
    x = np.random.RandomState(0).rand(2, *src, 3).astype(np.float32)
    np.testing.assert_array_equal(_np(presize.resize_nearest(torch.from_numpy(x), dst)),
                                  np.asarray(jresize.resize_nearest(jnp.asarray(x), dst)))
    np.testing.assert_array_equal(_np(presize.resize_nearest(torch.from_numpy(x[0]), dst)),
                                  np.asarray(jresize.resize_nearest(jnp.asarray(x[0]), dst)))


# ------------------------------------------------------------ ADC, DCE max

def test_adc_functions(raw):
    x = raw["dwi"][:3] * 500.0 + 1.0
    bvals = tuple(range(13))
    adc = ppre.compute_adc_map(torch.from_numpy(x), bvals)
    jadc = jpre.compute_adc_map(jnp.asarray(x), bvals)
    _close(adc, jadc)
    # log1p(clip) lands in [0, 3e-3] for slopes this small; scale them up
    _close(ppre.preprocess_adc(adc * 1e-2), jpre.preprocess_adc(jadc * 1e-2))
    _close(ppre.zero_to_one_adc(adc, -0.1, 0.05), jpre.zero_to_one_adc(jadc, -0.1, 0.05))


@pytest.mark.parametrize("compat", [True, False])
def test_prep_dwi_adc_maps(raw, compat):
    bvals = tuple(range(13))
    port = ppre.prep_dwi_adc_maps(raw["dwi"], raw["dwi_test"], bvals, compat, device=CPU)
    ref = jpre.prep_dwi_adc_maps(raw["dwi"], raw["dwi_test"], bvals, compat)
    for p, j in zip(port, ref):
        if j is None:
            assert p is None
        else:
            _close(p, j)


def test_dce_global_max_normalize(raw):
    x = raw["dce"][:4] * 3.0
    _close(ppre.dce_global_max_normalize(torch.from_numpy(x)),
           jpre.dce_global_max_normalize(jnp.asarray(x)))


# ------------------------------------------------------------------- Nyul

def test_nyul_fit_and_file_round_trip(raw, tmp_path):
    imgs = raw["dce"][:8]
    port, ref = ppre.NyulStandardizer(), jpre.NyulStandardizer()
    port.fit(imgs)
    ref.fit(imgs)
    np.testing.assert_allclose(port.channel_landmarks, ref.channel_landmarks, rtol=1e-5)
    # each package reads the other's file
    port.save(str(tmp_path / "port.npy"))
    ref.save(str(tmp_path / "jax.npy"))
    from_port, from_jax = jpre.NyulStandardizer(), ppre.NyulStandardizer()
    from_port.load(str(tmp_path / "port.npy"))
    from_jax.load(str(tmp_path / "jax.npy"))
    np.testing.assert_array_equal(from_port.channel_landmarks, port.channel_landmarks)
    np.testing.assert_array_equal(from_jax.channel_landmarks, ref.channel_landmarks)
    assert from_port.fitted and from_jax.fitted


@pytest.mark.parametrize("fast", [False, True])
def test_nyul_transform_matches_jax(raw, fast):
    fit, imgs = raw["dce"][:8], raw["dce_test"][:3] * 1.3
    port, ref = ppre.NyulStandardizer(), jpre.NyulStandardizer()
    port.fit(fit)
    ref.fit(fit)
    out = port.transform(torch.from_numpy(imgs), fast=fast)
    _close(out, ref.transform(jnp.asarray(imgs), fast=fast, percentile_stride=1))
    # a CPU tensor takes the exact route unless told otherwise
    if not fast:
        _close(port.transform(torch.from_numpy(imgs[0])), out[0])


# ------------------------------------------------------------ augmentation

@pytest.mark.parametrize("params", [(90.0, (2.0, -3.0), (0.0, 0.0)),
                                    (-180.0, (0.0, 1.0), (0.0, 0.0)),
                                    (0.0, (-4.0, 5.0), (0.0, 0.0)),
                                    (30.0, (1.5, -2.25), (0.1, 0.0))])
def test_affine_nearest_fixed_parameters_exact(params):
    angle, translate, shear = params
    img = np.random.RandomState(0).rand(20, 24, 3).astype(np.float32)
    out = paug.affine_nearest(torch.from_numpy(img), angle, translate, shear)
    ref = jaug.affine_nearest(jnp.asarray(img), angle, translate, shear)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


def test_augment_batch_shape_and_range(raw):
    imgs = torch.from_numpy(raw["dwi"][:5])
    out = paug.augment_batch(torch.Generator().manual_seed(0), imgs, 24)
    assert out.shape == (5, 24, 24, 13) and torch.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= imgs.max()
    again = paug.augment_batch(torch.Generator().manual_seed(0), imgs, 24)
    assert torch.equal(out, again)
    # a batch of one warps like the single-image call on the same draws
    single = paug.random_affine_flip(torch.Generator().manual_seed(1), imgs[0])
    batch = paug.random_affine_flip(torch.Generator().manual_seed(1), imgs[:1])
    assert torch.equal(single, batch[0])
    assert torch.equal(paug.eval_resize(imgs, 32), imgs)


# ------------------------------------------------------------- processor

@pytest.mark.parametrize("method,compat", [("dwi", True), ("dwi", False),
                                           ("dce", True), ("dce", False)])
def test_modality_processor_eval_matches_jax(raw, tmp_path, method, compat):
    jcfg = _cfg(tmp_path, compat)
    cfg = port_config(jcfg)
    imgs = raw[method][:5]
    kw, pkw = {}, {}
    if method == "dce":
        jn, pn = jpre.NyulStandardizer(), ppre.NyulStandardizer()
        jn.fit(raw["dce"])
        pn.fit(raw["dce"])
        kw, pkw = {"nyul": jn}, {"nyul": pn}
    else:
        maps = jpre.prep_dwi_adc_maps(raw["dwi"], raw["dwi_test"], jcfg.dwi_bvals_to_use)
        kw = {"adc_map": maps[1]}
        pkw = {"adc_map": torch.from_numpy(np.array(maps[1]))}
    jp = jmod.ModalityProcessor(jcfg, method, **kw)
    pp = pmod.ModalityProcessor(cfg, method, device=CPU, **pkw)
    _close(pp.eval_batch(imgs), jp.eval_batch(imgs))
    # chunked with a padded tail: 5 volumes in chunks of 2
    _close(pp.eval_split(imgs, chunk=2), jp.eval_split(imgs, chunk=2))
    if method == "dwi":
        adc = np.random.RandomState(1).rand(5, 32, 32, 1).astype(np.float32)
        _close(pp.eval_split(imgs, adc=adc, chunk=2), jp.eval_split(imgs, adc=adc, chunk=2))
        out = pp.train_batch(torch.Generator().manual_seed(0), imgs)
        assert out.shape == (5, 32, 32, cfg.dwi_channel_num) and torch.isfinite(out).all()
        assert out.min() >= 0.0 and out.max() <= 1.0


# ------------------------------------------------------------- the slice

@pytest.mark.parametrize("method,compat", [("dwi", True), ("dce", True), ("dwi", False)])
def test_prepare_and_export_match_jax(raw, tmp_path, method, compat):
    jcfg = _cfg(tmp_path / "jax", compat)
    cfg = port_config(_cfg(tmp_path / "port", compat))
    jdata = jprep.prepare_single_data(jcfg, method, 0, raw=dict(
        imgs=raw[method], test_imgs=raw[f"{method}_test"], labels=raw["labels"],
        test_labels=raw["labels_test"], masks=raw["masks"]))
    pdata = pprep.prepare_single_data(cfg, method, 0, raw=dict(
        imgs=raw[method], test_imgs=raw[f"{method}_test"], labels=raw["labels"],
        test_labels=raw["labels_test"], masks=raw["masks"]), device=CPU)
    for split in ("train", "val", "test"):
        for key in ("imgs", "masks", "labels", "adc"):
            p, j = pdata.splits[split][key], jdata.splits[split][key]
            if j is None:
                assert p is None
            else:
                _close(p, j)
    if method == "dce":
        np.testing.assert_allclose(pdata.nyul.channel_landmarks,
                                   jdata.nyul.channel_landmarks, rtol=1e-5)
    jpaths = jprep.export_processed_splits(jcfg, jdata)
    ppaths = pprep.export_processed_splits(cfg, pdata, torch.Generator().manual_seed(0))
    for split in ("train", "val", "test"):
        p = pprep.load_processed_split(ppaths[split])
        j = jprep.load_processed_split(jpaths[split])
        assert p.keys() == j.keys()
        assert p["imgs"].shape == j["imgs"].shape
        if split == "train" and compat:
            # one frozen augmentation: CPU and JAX generators draw other streams
            assert np.isfinite(p["imgs"]).all()
            assert p["imgs"].min() >= 0.0 and p["imgs"].max() <= 1.0
        else:
            _close(p["imgs"], j["imgs"])
        for key in set(p) - {"imgs"}:
            np.testing.assert_array_equal(p[key], j[key])


def test_load_raw_tensors_npz_pth_and_synthetic(raw, tmp_path):
    cfg = port_config(_cfg(tmp_path))
    store = {"imgs": raw["dce"], "test_imgs": raw["dce_test"], "labels": raw["labels"],
             "test_labels": raw["labels_test"], "masks": raw["masks"]}
    np.savez(tmp_path / "dce_tensordata.npz", **store)
    got = pprep.load_raw_tensors(cfg, "dce")
    for k in store:
        np.testing.assert_array_equal(got[k], store[k])

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    # the reference's nested .pth layout, written by the test itself
    for stem, t in (("dwi_tensordata", nchw(raw["dwi"])), ("dwi_test_tensordata",
                    nchw(raw["dwi_test"])), ("labels_tensordata", torch.from_numpy(raw["labels"])),
                    ("labels_test_tensordata", torch.from_numpy(raw["labels_test"])),
                    ("masks/mask", nchw(raw["masks"]))):
        path = tmp_path / (stem if "/" in stem else f"{stem}/{stem}")
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(t, str(path) + ".pth")
    got = pprep.load_raw_tensors(cfg, "dwi")
    for k, v in (("imgs", raw["dwi"]), ("test_imgs", raw["dwi_test"]), ("masks", raw["masks"]),
                 ("labels", raw["labels"])):
        np.testing.assert_array_equal(got[k], v)
    empty = port_config(_cfg(tmp_path / "empty"))
    syn = pprep.load_raw_tensors(empty, "dwi")
    np.testing.assert_array_equal(syn["imgs"], psyn.make_synthetic_arrays(seed=empty.seed)["dwi"])


def test_build_single_model_runs_on_cpu():
    cfg = port_config(_cfg("unused"))
    model, resolved = pprep.build_single_model(cfg, "dce", device=CPU,
                                               backbone_layers=(1, 1, 1, 1))
    assert resolved.dce_model == resolve_backbone_config(cfg.dce_model)
    x = torch.rand(2, cfg.dce_channel_num, 32, 32)
    with torch.no_grad():
        logits, aux, mask = model(x)
    assert logits.shape == (2, cfg.class_num) and torch.isfinite(logits).all()
    # a pretrained path is read (tests/test_torch_backbones.py loads real ones)
    with pytest.raises(FileNotFoundError):
        pprep.build_single_model(cfg, "dce", pretrained_path="x.pth", device=CPU)
