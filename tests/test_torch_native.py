"""The port's native host library (``dmf_tpu_torch/utils/native.py`` over its
own copy of ``native/dmf_native.cpp``) vs the JAX package's and numpy.

* ``nyul_fit`` bit-equal to ``dmf_tpu.utils.native.nyul_fit`` (the same C++:
  exact ``nth_element`` percentiles, a serial mean over the images) and
  within atol 1e-5 of the numpy formula, the tolerance of
  ``tests/test_native.py``; ``NyulStandardizer.fit`` takes it;
* ``percentiles`` and ``gather_rows`` against numpy;
* ``NativeBatchLoader`` gives the JAX loader's batches on the same arrays and
  seed, each epoch a permutation, and is reused across ``new_epoch``;
  ``iterate_batches(native=True)`` gives JAX's native batches (without its
  padded tail) and a CLI fold trains through it;
* the library builds from a clean build directory, and a failed build
  raises with the compiler's output.
"""

import threading

import numpy as np
import pytest
import torch

from dmf_tpu.data import pipeline as jpipe
from dmf_tpu.utils import native as jnative
from dmf_tpu_torch import cli
from dmf_tpu_torch.config import default_parameters
from dmf_tpu_torch.data import pipeline as ppipe
from dmf_tpu_torch.data.preprocess import DEFAULT_LANDMARKS, NyulStandardizer, nyul_fit_plain
from dmf_tpu_torch.ops import cuda_build
from dmf_tpu_torch.utils import native

LANDMARKS = np.asarray(DEFAULT_LANDMARKS, np.float64)


def images(seed, n=6, side=24, c=3):
    return np.random.RandomState(seed).gamma(2.0, 1.0, (n, side, side, c)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_nyul_fit_matches_jax_and_numpy(seed):
    imgs = images(seed)
    ours = native.nyul_fit(imgs, LANDMARKS)
    theirs = jnative.nyul_fit(imgs, LANDMARKS)
    assert theirs is not None, "the JAX package's native library did not load"
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(ours, nyul_fit_plain(imgs, LANDMARKS), rtol=0, atol=1e-5)
    assert ours.shape == (3, len(LANDMARKS)) and ours.dtype == np.float64


def test_standardizer_fit_takes_the_native_fit():
    imgs = images(2, c=4)
    ny = NyulStandardizer()
    ny.fit(imgs, num_channels=3)
    np.testing.assert_array_equal(ny.channel_landmarks,
                                  native.nyul_fit(imgs[..., :3], LANDMARKS))
    ny.fit(torch.from_numpy(imgs))
    np.testing.assert_array_equal(ny.channel_landmarks, native.nyul_fit(imgs, LANDMARKS))


def test_percentiles_and_gather_match_numpy():
    r = np.random.RandomState(3)
    data = r.standard_normal(10007).astype(np.float32)
    q = np.array([0, 1, 10, 25, 50, 75, 90, 99, 100], np.float64)
    np.testing.assert_allclose(native.percentiles(data, q), np.percentile(data, q),
                               rtol=0, atol=1e-6)
    src = r.rand(50, 4, 4, 3).astype(np.float32)
    idx = r.randint(0, 50, 37)
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    assert native.gather_rows(src, np.zeros(0, np.int64)).shape == (0, 4, 4, 3)
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([0, 50]))
    with pytest.raises(ValueError, match="refused"):
        native.percentiles(np.zeros(0, np.float32), q)


def loader_arrays(n):
    imgs = np.zeros((n, 4, 4, 2), np.float32)
    imgs[:, 0, 0, 0] = np.arange(n)  # the sample id, in the data
    masks = np.zeros((n, 2, 2, 1), np.float32)
    masks[:, 0, 0, 0] = np.arange(n)
    return {"imgs": imgs, "masks": masks}, np.arange(n, dtype=np.int32)


def batches_of(loader):
    return [{k: np.array(v) for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_matches_jax_and_is_reused(shuffle):
    """Three epochs: the JAX loader's batches, rows aligned across arrays,
    each epoch a permutation with a short tail."""
    arrays, labels = loader_arrays(37)
    ours = native.NativeBatchLoader(arrays, labels, 8, shuffle=shuffle, seed=3)
    theirs = jnative.NativeBatchLoader(arrays, labels, 8, shuffle=shuffle, seed=3)
    handle = ours._h
    for epoch in range(3):
        if epoch:
            ours.new_epoch(10 + epoch)
            theirs.new_epoch(10 + epoch)
        got, ref = batches_of(ours), batches_of(theirs)
        assert [len(b["labels"]) for b in got] == [8, 8, 8, 8, 5]
        for a, b in zip(got, ref):
            assert set(a) == set(b) == {"imgs", "masks", "labels"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a["imgs"][:, 0, 0, 0], a["labels"])
            np.testing.assert_array_equal(a["masks"][:, 0, 0, 0], a["labels"])
        order = np.concatenate([b["labels"] for b in got])
        assert sorted(order.tolist()) == list(range(37))
        assert (order.tolist() != list(range(37))) == shuffle
    assert ours._h == handle
    ours.close()
    theirs.close()


def test_iterate_batches_native_matches_jax():
    """The native route's batches are JAX's (its ``pad_to_batch=False``: no
    padded tail) in the dataset's dtypes; the loader is built once and
    restarted each epoch; a staged copy wins over it."""
    r = np.random.RandomState(4)
    arrays = {"imgs": r.rand(19, 6, 6, 3).astype(np.float32),
              "masks": (r.rand(19, 3, 3, 1) > 0.5).astype(np.float32),
              "labels": r.randint(0, 4, 19).astype(np.int64)}
    ours_ds, theirs_ds = ppipe.ArrayDataset(**arrays), jpipe.ArrayDataset(**arrays)
    ours_rng, theirs_rng = np.random.RandomState(5), np.random.RandomState(5)
    loaders = []
    for _ in range(2):
        got = list(ppipe.iterate_batches(ours_ds, 8, shuffle=True, rng=ours_rng, native=True))
        ref = list(jpipe.iterate_batches(theirs_ds, 8, shuffle=True, rng=theirs_rng,
                                         pad_to_batch=False, native=True))
        loaders.append(ours_ds.native_loader[1])
        assert [len(b["labels"]) for b in got] == [8, 8, 3]
        for a, b in zip(got, ref):
            assert a["labels"].dtype == np.int64
            for k in arrays:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    assert loaders[0] is loaders[1]
    staged = list(ppipe.iterate_batches(ours_ds, 8, device="cpu", native=True))
    assert isinstance(staged[0]["imgs"], torch.Tensor)


def test_loader_stress_abandoned_epochs():
    """More worker threads than cores on a two-slot ring, epochs abandoned
    part-way and restarted: every full epoch is still a permutation with
    rows aligned, and the run ends within its time bound."""
    arrays, labels = loader_arrays(301)
    loader = native.NativeBatchLoader(arrays, labels, 3, seed=0, ring_slots=2, n_threads=32)
    errors = []

    def run():
        try:
            for epoch in range(20):
                loader.new_epoch(epoch)
                it = iter(loader)
                if epoch % 3 == 0:  # abandon part-way, holding a slot
                    next(it)
                    next(it)
                    continue
                ids = []
                for b in it:
                    assert np.array_equal(b["imgs"][:, 0, 0, 0], b["labels"])
                    ids.extend(b["labels"].tolist())
                assert sorted(ids) == list(range(301))
        except Exception as e:  # reported to the test thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the loader hung"
    assert not errors, errors
    loader.close()


def test_cli_fold_trains_through_the_native_loader(tmp_path, monkeypatch):
    """``use_native_loader=True`` trains (it raised before the library was
    ported): a tiny DWI fold on the CPU, its train batches from the loader."""
    calls = []
    real = ppipe.native_batches

    def spy(*a, **k):
        calls.append(a[1])
        yield from real(*a, **k)

    monkeypatch.setattr(ppipe, "native_batches", spy)
    config = tmp_path / "cfg.json"
    default_parameters(use_native_loader=True, test_mode="normal").save(str(config))
    assert cli.main(["run", "--config", str(config), "--tiny", "--device", "cpu", "--folds",
                     "0", "--methods", "dwi", "--epochs", "2", "--base-path",
                     str(tmp_path / "data"), "--results-dir", str(tmp_path / "res")]) == 0
    assert len(calls) == 2  # one per epoch, the validation split on the host route


def test_builds_into_a_clean_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    lib = native.build()
    assert lib.parent.parent == tmp_path and lib.name == "libdmf_native.so"
    assert lib.parent.name.startswith("dmf_native-")
    assert [p.name for p in lib.parent.iterdir() if p.suffix == ".tmp"] == []
    import ctypes

    assert ctypes.CDLL(str(lib)).dmf_native_version() == native.VERSION
    assert native.build() == lib  # built once per source and flags
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        cuda_build.build_library("dmf_native", native.SOURCES, compiler="g++",
                                 flags=native.GXX_FLAGS + ("-DDMF_BROKEN", "-include",
                                                           "no_such_header.h"))
