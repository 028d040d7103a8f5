"""The MC ensemble does not depend on ``mc_chunk`` (``ops/dropout.py``'s
pass-indexed seed route), on the CPU.

Every MC route draws each dropout mask from Philox4x32-10 of one request
seed, the pass word and the site's counter within its pass, so a pass's
masks are the same bits whether it runs alone, in a chunk of 2 or 4, or in
the one unchunked lean forward, as JAX's predictor draws each pass from its
own key (``dmf_tpu/evals/predict.py:349``).  Held here:

* the plain torch Philox against the numpy oracle with pass words (0, 1,
  2^31) and counters past 2^32, and at pass word 0 the counter layout that
  had no pass word;
* per-site masks, captured at ``ops/dropout.py::keep_mask_plain`` (the CPU
  implementation of kernel 1's dropout and of the keep-mask operator),
  bit-equal across ``mc_chunk`` None / 1 / 2 / 4 of a 10-pass ensemble, and
  the mean and std within ``rtol=1e-5, atol=1e-6`` (what the dropout-off
  ensemble meets), for the ResNet-backed, ``hybrid`` and ``hybrid-nb`` toy
  encoders, ``mc`` and ``tta_mc``, the single-encoder predictor, both int8
  forwards and the exported artifact against the eager predictor;
* the model axis: a shard's mask is the slice of the whole mask; over 2x1
  and 1x2 gloo meshes (``tests/torch_mesh_workers.py``) chunk 1 equals the
  unchunked ensemble, and on the model axis each rank equals one process,
  on the weights route (``hybrid``) and with the attention on the fused
  route (``hybrid-nb``, each rank's sites at its shard's first head);
* the dropout-off ensemble at chunks 1 and None against the JAX package's
  chunked predictor at rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (assert_close, fusion_stack, hybrid_cfg, port_config, tiny_cfg,
                                volumes)
from torch_mesh_workers import mc_fused, recorded_masks, spawn

from dmf_tpu.evals.predict import make_fusion_predictor as jax_predictor
from dmf_tpu_torch.evals.predict import make_fusion_predictor, make_single_predictor
from dmf_tpu_torch.models import build_fusion_models
from dmf_tpu_torch.models.layers import dropout as layer_dropout
from dmf_tpu_torch.ops import dropout, quant
from dmf_tpu_torch.ops.epilogue_cuda import keep_mask_ref, philox4x32
from dmf_tpu_torch.serving import (export_serving, load_serving, make_serving_fn,
                                   serving_variables)

PASSES = 10
CHUNKS = (None, 1, 2, 4)
TOL = dict(rtol=1e-5, atol=1e-6)  # the dropout-off ensemble's agreement across chunkings
LOW = dict(min_fan_in=64, min_out=8)  # quantize the toy convs too (test_torch_quant.py)


def _build(cfg, seed=0):
    pcfg = port_config(cfg)
    return pcfg, build_fusion_models(pcfg, "cpu", torch.float32,
                                     torch.Generator().manual_seed(seed),
                                     backbone_layers=(1, 1, 1, 1))


@pytest.fixture(scope="module")
def stacks():
    """Port models with dropout 0.2 on random weights: the ResNet-backed
    toy encoders, ``hybrid`` (backbone + transformer) and ``hybrid-nb``."""
    return {"resnet": _build(tiny_cfg(dropout=0.2, mc_passes=PASSES)),
            "hybrid": _build(hybrid_cfg(use_backbone=True, dropout=0.2, mc_passes=PASSES)),
            "hybrid-nb": _build(hybrid_cfg(dropout=0.2, mc_passes=PASSES))}


def _request(seed=3):
    return tuple(torch.from_numpy(a) for a in volumes(seed))


def _held(runs):
    """Runs ``{chunk: ((mean, std, ...), masks)}``: every pass's masks
    bit-equal to the unchunked run's, mean and std within TOL."""
    (ref, ref_masks), *rest = runs.values()
    assert sorted(ref_masks) == list(range(PASSES)) and all(ref_masks.values())
    for chunk, (out, masks) in list(runs.items())[1:]:
        assert sorted(masks) == sorted(ref_masks), chunk
        for p, sites in ref_masks.items():
            assert len(masks[p]) == len(sites), (chunk, p)
            for a, b in zip(masks[p], sites):
                assert torch.equal(a, b), (chunk, p)
        for got, want in zip(out[:2], ref[:2]):
            torch.testing.assert_close(got, want, **TOL)
    assert float(ref[1].mean()) > 1e-6, "dropout on: the ensemble has spread"


def _chunked(predict_of, args, chunks=CHUNKS, seed=5):
    runs = {}
    for c in chunks:
        with recorded_masks() as masks:
            out = predict_of(c)(*args, torch.Generator().manual_seed(seed))
        runs[c] = (out, dict(masks))
    return runs


# ------------------------------------------------------------ the Philox bits
def test_pass_word_bits_match_the_numpy_philox():
    """``keep_mask_plain`` against ``keep_mask_ref`` with pass words 0, 1
    and 2^31 and counters past 2^32; at pass word 0 the bits of the counter
    ``(e/4 lo, e/4 hi, 0, 0)``, and another pass word gives other bits."""
    x = torch.zeros(4, 5, 3, 7)
    per = x.numel() // 2
    for seed in (12345, (0x5EED << 32) | 77):
        for base in (0, 2 ** 32 - 8, 2 ** 40 + 4):
            for first in (0, 1, 2 ** 31):
                got = dropout.keep_mask_plain(x.shape, 0.3, torch.tensor(seed), base, first, 2)
                flat = got.permute(0, 2, 3, 1).reshape(-1).numpy()
                np.testing.assert_array_equal(
                    flat, keep_mask_ref(base, x.numel(), 0.3, seed, first, 2))
                np.testing.assert_array_equal(
                    flat[per:], keep_mask_ref(base, per, 0.3, seed, first + 1))
            zero = keep_mask_ref(base, 12, 0.3, seed)
            for i in range(12):
                e = base + i
                word = philox4x32([e // 4 % 2 ** 32, e // 4 >> 32, 0, 0],
                                  (seed % 2 ** 32, seed >> 32))[e % 4]
                assert zero[i] == (np.float32(word >> 8) * np.float32(2.0 ** -24)
                                   < np.float32(0.7))
            assert not np.array_equal(keep_mask_ref(base, 64, 0.3, seed, 1),
                                      keep_mask_ref(base, 64, 0.3, seed))


def test_seed_stream_counts_per_pass():
    """A site's base advances by one pass's elements, so a chunk of k passes
    takes the bases of one pass; a tensor that does not split into the
    stream's passes along its first dimension raises."""
    one, three = (dropout.SeedStream(torch.tensor(1), passes=k) for k in (1, 3))
    assert [one.take(n) for n in (10, 6)] == [three.take(3 * n) for n in (10, 6)] == [0, 12]
    with pytest.raises(ValueError, match="passes"):
        three.take(10)
    with pytest.raises(ValueError, match="passes"):
        dropout.keep_mask_plain((4, 3), 0.2, torch.tensor(1), 0, 0, 3)
    with pytest.raises(ValueError, match="pass word"):
        dropout.SeedStream(torch.tensor(1), first_pass=2 ** 32 - 1, passes=2)


@pytest.mark.parametrize("shape,dim", [((4, 6, 5, 5), 1), ((4, 7, 12), -1)])
def test_shard_mask_is_the_slice_of_the_whole(shape, dim):
    """On a model axis of 2, each rank's dropout on its slice along ``dim``
    (attention heads, MLP features) keeps that slice of the whole tensor's
    seed-route mask, bit for bit, and advances the stream as the whole."""
    class Axis:
        n_model = 2

        def __init__(self, rank):
            self.model_rank = rank

    g = torch.Generator().manual_seed(0)
    whole = torch.randn(*shape, generator=g)
    seed = torch.tensor(99)
    ref = dropout.seeded_dropout(whole, 0.3, dropout.SeedStream(seed, first_pass=4, passes=2))
    n = shape[dim] // 2
    for rank in (0, 1):
        stream = dropout.SeedStream(seed, first_pass=4, passes=2)
        got = layer_dropout(whole.narrow(dim, rank * n, n), 0.3, stream, Axis(rank), dim)
        assert torch.equal(got, ref.narrow(dim, rank * n, n))
        assert stream.counter == -(-whole.numel() // 2 // 4) * 4


# ------------------------------------------------------------ the predictors
@pytest.mark.parametrize("kind", ["resnet", "hybrid", "hybrid-nb"])
@pytest.mark.parametrize("mode", ["mc", "tta_mc"])
def test_fusion_ensemble_is_chunk_invariant(stacks, kind, mode):
    pcfg, models = stacks[kind]
    _held(_chunked(lambda c: make_fusion_predictor(pcfg, *models, mode=mode, mc_chunk=c),
                   _request()))


def test_single_predictor_is_chunk_invariant(stacks):
    pcfg, (dwi, _, _) = stacks["resnet"]
    x, _ = _request()
    _held(_chunked(lambda c: make_single_predictor(pcfg, dwi, mode="tta_mc", mc_chunk=c),
                   (x,)))


@pytest.mark.parametrize("hybrid", [False, True])
def test_int8_forwards_are_chunk_invariant(stacks, hybrid):
    """``make_quantized_fusion_fwd`` and the int8-prefix hybrid, calibrated
    with MC dropout on."""
    pcfg, models = stacks["resnet"]
    xd, xc = _request()
    _, qsets = quant.make_quantized_fusion_apply(*models, calibration=(xd, xc),
                                                 calibration_mc=True, **LOW)
    make = quant.make_hybrid_fusion_fwd if hybrid else quant.make_quantized_fusion_fwd
    fwd = make(*models, qsets)
    _held(_chunked(lambda c: make_fusion_predictor(pcfg, *models, mode="tta_mc", mc_chunk=c,
                                                   fwd_override=fwd), (xd, xc), (None, 1, 4)))


def test_artifact_at_chunk_2_is_the_eager_ensemble(stacks):
    """An artifact exported at ``mc_chunk=2`` gives the unchunked eager
    predictor's masks for one seed, and its ensemble within TOL."""
    pcfg, models = stacks["resnet"]
    xd, xc = _request()
    seed = torch.tensor(11)
    args = (serving_variables(*models), xd, xc, seed)
    served = load_serving(export_serving(make_serving_fn(pcfg, *models, mode="tta_mc",
                                                         mc_chunk=2), args))
    runs = {}
    with recorded_masks() as masks:
        runs["eager"] = (make_fusion_predictor(pcfg, *models, mode="tta_mc")(xd, xc, seed),
                         dict(masks))
    with recorded_masks() as masks:
        runs["artifact"] = (served(*args), dict(masks))
    _held(runs)


# ------------------------------------------------------------ the mesh
def test_data_mesh_chunks_per_rank(stacks, tmp_path):
    """2x1 data mesh, ``tta_mc`` at B=4: on each rank, chunk 1 gives the
    unchunked run's masks and ensemble (each rank draws its own seed)."""
    pcfg, models = stacks["resnet"]
    request = tuple(torch.from_numpy(a) for a in volumes(9, b=4))
    out = spawn(tmp_path, 2, "mc_chunks", cfg=pcfg, models=models, request=request,
                chunks=(None, 1))
    for rank in out:
        _held(rank)
    assert not torch.equal(out[0][None][1][0][0], out[1][None][1][0][0]), "ranks' own seeds"


def test_model_mesh_matches_one_process(stacks, tmp_path):
    """1x2 model mesh, ``hybrid`` ``tta_mc`` (attention on head shards, the
    MLP on feature shards): each rank's whole masks and ensemble at chunk 1
    and unchunked equal one process's."""
    pcfg, models = stacks["hybrid"]
    request = _request()
    one = _chunked(lambda c: make_fusion_predictor(pcfg, *models, mode="tta_mc", mc_chunk=c),
                   request, (None, 1))
    out = spawn(tmp_path, 2, "mc_chunks", n_model=2, cfg=pcfg, models=models,
                request=request, chunks=(None, 1))
    for rank in out:
        _held(rank)
        for c in (None, 1):
            _held({"one process": one[c], "rank": rank[c]})


def test_model_mesh_fused_attention_matches_one_process(stacks, tmp_path):
    """1x2 model mesh, ``hybrid-nb`` ``tta_mc`` with every MC attention site
    on the fused route (``use_flash`` patched in ``mc_fused`` alone): each
    rank's fused sites take one process's counters and passes with the whole
    head count and their shard's first head, and the rank's masks and
    ensemble at chunk 1 and unchunked equal one process's."""
    pcfg, models = stacks["hybrid-nb"]
    request = _request()
    one, calls = mc_fused(None, pcfg, models, request, (None, 1))
    heads = pcfg.dwi_model.transformer_heads
    assert calls[None] and all(c[4:] == (heads, 0, heads) for c in calls[None])
    out = spawn(tmp_path, 2, "mc_fused", n_model=2, cfg=pcfg, models=models,
                request=request, chunks=(None, 1))
    for rank, (runs, rank_calls) in enumerate(out):
        _held(runs)
        for c in (None, 1):
            _held({"one process": one[c], "rank": runs[c]})
            assert [s[:5] for s in rank_calls[c]] == [s[:5] for s in calls[c]], c
            assert all(s[5:] == (rank * heads // 2, heads // 2) for s in rank_calls[c]), c


# ------------------------------------------------------------ against JAX
def test_dropout_off_ensemble_matches_jax_chunked():
    """Dropout 0: the port at chunks 1 and None against JAX's
    ``make_fusion_predictor(mode="tta_mc", mc_chunk=2)`` at rel 1e-4."""
    cfg = tiny_cfg(dropout=0.0, use_backbone=False, mc_passes=4)
    xd, xc = volumes(7)
    jmods, jvars, pmods = fusion_stack(cfg, xd, xc)
    jmean, jstd, _ = jax_predictor(cfg, *jmods, mode="tta_mc", mc_chunk=2)(
        *jvars, jnp.asarray(xd), jnp.asarray(xc), jax.random.PRNGKey(0))
    for c in (1, None):
        mean, std, _ = make_fusion_predictor(port_config(cfg), *pmods, mode="tta_mc",
                                             mc_chunk=c)(
            torch.from_numpy(xd), torch.from_numpy(xc), torch.Generator().manual_seed(0))
        assert_close(mean, jmean, what=f"mean at chunk {c}")
        np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=0, atol=1e-5)
