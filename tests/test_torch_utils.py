"""The port's observability utilities (``dmf_tpu_torch/utils/{visualize,
profiling,introspect}.py``) against the JAX package's, on the CPU, and the
fits' mask triptychs.

* the triptych's panels against the arrays JAX's ``visualize_mask_triplet``
  hands to ``imshow`` (captured by patching ``matplotlib.axes.Axes.imshow``;
  its layout and ``savefig`` are patched out, matplotlib's first text layout
  takes tens of seconds here), bit for bit; the PNG decoded with ``zlib``;
* ``StepTimer`` against JAX's on one sequence of ``time.perf_counter``
  values, exactly;
* ``capture_features`` on a toy encoder against JAX's at the counterpart
  modules, ``RTOL`` (relative 1e-4 against the tensor's scale).
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import assert_close, jax_encoder, port_encoder, tiny_cfg, volumes

from dmf_tpu.utils import introspect as jintrospect
from dmf_tpu.utils import profiling as jprofiling
from dmf_tpu.utils import visualize as jvisualize
from dmf_tpu_torch.utils import introspect, profiling, visualize


def read_png(path):
    """``(gray image, {tEXt keyword: text})`` of an 8-bit grayscale PNG."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks.append((kind, body))
        pos += 12 + n
    assert chunks[0][0] == b"IHDR" and chunks[-1] == (b"IEND", b"")
    w, h, depth, color = struct.unpack(">IIBB", chunks[0][1][:10])
    assert (depth, color) == (8, 0)
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    assert len(raw) == h * (w + 1)
    rows = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all()  # filter type 0 on every row
    text = dict(b.split(b"\x00", 1) for k, b in chunks if k == b"tEXt")
    return rows[:, 1:], {k.decode(): v.decode("latin-1") for k, v in text.items()}


def jax_imshow_arrays(monkeypatch, *args, **kwargs):
    """The arrays and titles JAX's ``visualize_mask_triplet`` draws."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.axes
    import matplotlib.figure

    shown, titles = [], []
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow",
                        lambda self, data, **kw: shown.append(np.array(data)))
    monkeypatch.setattr(matplotlib.axes.Axes, "set_title",
                        lambda self, t, **kw: titles.append(t))
    monkeypatch.setattr(matplotlib.figure.Figure, "tight_layout", lambda self, **kw: None)
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", lambda self, *a, **kw: None)
    jvisualize.visualize_mask_triplet(*args, **kwargs)
    return shown, titles


@pytest.mark.parametrize("with_gt", [True, False])
def test_triptych_panels_match_jax(monkeypatch, tmp_path, with_gt):
    rng = np.random.RandomState(0)
    img = rng.rand(32, 32, 3).astype(np.float32) * 7 - 2
    gt = (rng.rand(32, 32) > 0.5).astype(np.float32) if with_gt else None
    pred = rng.randn(32, 32, 1).astype(np.float32)
    shown, titles = jax_imshow_arrays(monkeypatch, img, gt, pred, str(tmp_path / "j.png"),
                                      title_prefix="Epoch 3, sample: ")
    panels = visualize.mask_panels(img, gt, pred, title_prefix="Epoch 3, sample: ")
    assert [t for _, t in panels] == titles
    assert len(panels) == len(shown) == (4 if with_gt else 3)
    for (got, _), ref in zip(panels, shown):
        np.testing.assert_array_equal(got, ref)

    out = visualize.visualize_mask_triplet(img, gt, pred, str(tmp_path / "viz" / "m.png"),
                                           title_prefix="Epoch 3, sample: ")
    image, text = read_png(out)
    n = len(panels)
    assert image.shape == (32, n * 32 + (n - 1) * visualize.GAP)
    assert text == {"Title": " | ".join(titles)}
    for i, (panel, _) in enumerate(panels):
        tile = image[:, i * (32 + visualize.GAP):i * (32 + visualize.GAP) + 32]
        np.testing.assert_array_equal(tile, visualize.to_gray8(panel))
        if panel.max() > panel.min():  # autoscaled from its minimum to its maximum
            assert tile.min() == 0 and tile.max() == 255


def test_gray8_matches_matplotlib_gray_colormap():
    """``to_gray8`` is matplotlib's Normalize + 256-entry gray colormap."""
    import matplotlib

    x = np.random.RandomState(1).randn(17, 9)
    cmap = matplotlib.colormaps["gray"]
    norm = matplotlib.colors.Normalize(vmin=x.min(), vmax=x.max())
    ref = (cmap(norm(x))[..., 0] * 255).round().astype(np.uint8)
    np.testing.assert_array_equal(visualize.to_gray8(x), ref)
    assert (visualize.to_gray8(np.full((3, 3), 2.0)) == 0).all()


def test_step_timer_matches_jax(monkeypatch):
    ticks = [0.0, 1.0, 1.5, 4.0, 4.25, 6.0, 7.0, 7.125]
    timers = []
    for mod in (jprofiling, profiling):
        it = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        t = mod.StepTimer(warmup=1)
        for _ in range(len(ticks) // 2):
            with t:
                pass
        timers.append(t)
    jt, pt = timers
    assert (pt.count, pt.total, pt.mean_step_time, pt.steps_per_sec) == \
        (jt.count, jt.total, jt.mean_step_time, jt.steps_per_sec)
    assert pt.summary() == jt.summary() == {"mean_step_time_s": 4.375 / 3,
                                            "steps_per_sec": 3 / 4.375}
    assert profiling.StepTimer().summary() == jprofiling.StepTimer().summary()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("dmf_span"):
            torch.ones(8).sum()
    (trace,) = list(tmp_path.iterdir())
    assert trace.suffix == ".json" and "dmf_span" in trace.read_text()
    with profiling.trace(None):
        pass


@pytest.fixture(scope="module")
def encoders():
    cfg = tiny_cfg(dropout=0.2, use_backbone=False)
    xd, _ = volumes(0)
    jm, v = jax_encoder(cfg.dwi_model, 14, xd)
    pm, _ = port_encoder(cfg.dwi_model, 14, v)
    return jm, v, pm, xd


# counterpart modules: JAX path -> the port's; JAX keeps a tuple output whole
# (its first call's), the port its first element
PAIRS = {"modality_attention": "modality_attention", "block1": "block1", "block2": "block2",
         "block3": "block3", "mask_head": "mask_head", "proj_f1": "proj_f1",
         "classification_head": "classification_head"}


def test_capture_features_matches_jax(encoders):
    jm, v, pm, xd = encoders
    (jlogits, _, _), jfeats = jintrospect.capture_features(jm, v, jnp.asarray(xd), train=False)
    with torch.no_grad():
        (logits, _, _), feats = introspect.capture_features(
            pm, torch.from_numpy(xd).permute(0, 3, 1, 2).contiguous())
    assert_close(logits, jlogits, what="outputs")
    for jname, name in PAIRS.items():
        ref = jfeats[jname][0] if isinstance(jfeats[jname], tuple) else jfeats[jname]
        got = feats[name]
        assert_close(got.permute(0, 2, 3, 1) if got.dim() == 4 else got, ref, what=name)


def test_capture_features_filter_and_hooks_removed(encoders):
    _, _, pm, xd = encoders
    x = torch.from_numpy(xd).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        _, feats = introspect.capture_features(pm, x, path_filter="block2")
        assert feats and all("block2" in k for k in feats)
        assert not any(m._forward_hooks for m in pm.modules())
        with pytest.raises(TypeError):
            introspect.capture_features(pm, x, bogus=1)
    assert not any(m._forward_hooks for m in pm.modules())


def test_fit_single_draws_triptychs(tmp_path):
    """``fit_single`` at ``viz_every=1`` draws a triptych of the first
    validation sample each epoch (0 never draws), outside the step times."""
    from dmf_tpu_torch import cli
    from dmf_tpu_torch.data import make_synthetic_arrays
    from dmf_tpu_torch.pipeline import build_single_model, prepare_single_data
    from dmf_tpu_torch.train.loop import fit_single
    from dmf_tpu_torch.train.optim import SingleModelOptController
    from dmf_tpu_torch.train.state import TrainState

    cfg = cli.load_config(cli.build_parser().parse_args(
        ["run", "--tiny", "--base-path", str(tmp_path / "data")]))
    arrays = make_synthetic_arrays(n_train=24, n_test=8, image_size=32, mask_size=32, seed=0)
    raw = {"imgs": arrays["dwi"], "test_imgs": arrays["dwi_test"], "labels": arrays["labels"],
           "test_labels": arrays["labels_test"], "masks": arrays["masks"]}
    data = prepare_single_data(cfg, "dwi", 0, raw=raw, device="cpu")
    model, cfg = build_single_model(cfg, "dwi", device="cpu")
    for viz_every, expect in ((1, ["epoch_0000.png", "epoch_0001.png"]), (0, [])):
        workdir = tmp_path / f"every{viz_every}"
        fit = fit_single(cfg, "dwi", TrainState.create(model), data.splits["train"],
                         data.splits["val"], data.processor,
                         SingleModelOptController(cfg, "dwi"), str(workdir), num_epochs=2,
                         min_epochs=2, viz_every=viz_every)
        assert len(fit.history) == 2
        drawn = sorted(p.name for p in (workdir / "viz").glob("*.png"))
        assert drawn == expect
        for name in drawn:
            image, text = read_png(workdir / "viz" / name)
            assert image.shape[0] == 32 and text["Title"].startswith(
                f"Epoch {int(name[6:10])}, sample: Input | GT Mask")
