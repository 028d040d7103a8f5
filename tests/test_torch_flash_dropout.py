"""The MC attention's fused route (``flash_attention_dropout``) on the CPU.

On a seed stream at the flash shapes (``ops/attention.py::use_flash``) the
port's MC attention runs the ``flash_forward_dropout`` operator: on the card
the flash forward kernels with the seed route's keep mask drawn inside, on
the CPU its plain version ``flash_attention_dropout_ref``.  Held here:

* the plain version equals the weights route it replaces (the materialized
  weights, ``layers.dropout`` on a ``SeedStream``, the value product) bit for
  bit, at 2 and 3 passes, ``first_pass > 0``, a counter base other than 0, 4
  and 2 heads, and on a 2-way head shard (``h0 = 2``), which is the whole
  call's heads ``h0 ..``; after the site the stream's counter is the weights
  route's;
* the module at 512 tokens x embed 32 against JAX's ``_xla_attention`` with
  the seed route's mask injected into its weights, rel 1e-4 (fp32; the two
  frameworks' CPU matmuls sum in other orders), and with dropout off against
  JAX's module at the same tolerance;
* the ``tta_mc`` ensemble of the toy ``hybrid-nb`` models through the
  operator (the token rule patched down in this test only) chunk-invariant,
  as ``tests/test_torch_mc_chunk.py`` holds the weights route;
* a ``torch.export`` of a module that takes the operator holds one node of
  it and matches eager bit for bit.

The kernels themselves are held on the card (``tests/test_torch_cuda.py``
under the ``cuda`` mark, and ``chip_smoke.py`` phase 3i).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import assert_close, hybrid_cfg, randomize
from test_torch_mc_chunk import PASSES, _build, _chunked, _held, _request

from dmf_tpu.models.ref_ckpt import _Exporter, _to_host
from dmf_tpu.models.transformer import MultiHeadSelfAttention as JaxMHSA
from dmf_tpu.ops.attention import _xla_attention
from dmf_tpu_torch.evals.predict import make_fusion_predictor
from dmf_tpu_torch.models import load_reference_state_dict
from dmf_tpu_torch.models import transformer
from dmf_tpu_torch.models.layers import dropout as layer_dropout
from dmf_tpu_torch.models.transformer import MultiHeadSelfAttention
from dmf_tpu_torch.ops import dropout, flash_attention
from dmf_tpu_torch.ops.flash_attention import attention_weights, flash_attention_dropout

P = 0.1
SEED = (0x5EED << 32) | 27


def _qkv(b, h, n, d, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32)) for _ in range(3)]


class _Axis:
    """A model axis of 2 as ``layers.dropout`` reads it."""
    n_model = 2

    def __init__(self, rank):
        self.model_rank = rank


def _weights_route(q, k, v, stream, mesh=None):
    """The module's weights route on (B, H, N, D) tensors (a head shard of
    the whole under ``mesh``): the weights, the seed-route dropout, the
    value product."""
    w = attention_weights(q, k, q.shape[-1] ** -0.5)
    w = (layer_dropout(w, P, stream) if mesh is None
         else layer_dropout(w, P, stream, mesh, dim=1))
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


@pytest.mark.parametrize("passes,first_pass,base,heads", [
    (1, 0, 0, 4), (2, 0, 0, 4), (3, 5, 0, 4), (2, 1, 36, 4), (3, 0, 8, 2), (2, 7, 4, 2)])
def test_plain_version_is_the_weights_route(passes, first_pass, base, heads):
    """Bit-equal outputs, and the stream advanced exactly as the weights
    route advances it; a later site's base is then the same too."""
    q, k, v = _qkv(2 * passes, heads, 64, 8, seed=passes + heads)
    seed = torch.tensor(SEED)
    old = dropout.SeedStream(seed, counter=base, first_pass=first_pass, passes=passes)
    new = dropout.SeedStream(seed, counter=base, first_pass=first_pass, passes=passes)
    want = _weights_route(q, k, v, old)
    got = flash_attention_dropout(q, k, v, P, new)
    assert torch.equal(got, want)
    assert new.counter == old.counter == base + 2 * heads * 64 * 64
    assert new.take(12 * passes) == old.take(12 * passes)
    # dropout acted: some weights kept, some dropped
    assert not torch.equal(got, torch.einsum("bhqk,bhkd->bhqd",
                                             attention_weights(q, k, 8 ** -0.5), v))


@pytest.mark.parametrize("passes,first_pass,base", [(1, 0, 0), (2, 3, 12)])
def test_head_shard_is_the_slice_of_the_whole(passes, first_pass, base):
    """A 2-way head shard of 4 heads (``h0 = 2`` on rank 1): the whole
    call's heads ``h0 ..``, bit for bit, and the sharded weights route's
    output (``layers.dropout`` narrowing the whole mask), with the counter
    of the whole weights."""
    q, k, v = _qkv(2 * passes, 4, 64, 8, seed=11)
    seed = torch.tensor(SEED)

    def stream():
        return dropout.SeedStream(seed, counter=base, first_pass=first_pass, passes=passes)

    whole = flash_attention_dropout(q, k, v, P, stream())
    for rank in (0, 1):
        sl = slice(2 * rank, 2 * rank + 2)
        s_new, s_old = stream(), stream()
        got = flash_attention_dropout(q[:, sl], k[:, sl], v[:, sl], P, s_new, heads=4,
                                      h0=2 * rank)
        assert torch.equal(got, whole[:, sl])
        assert torch.equal(got, _weights_route(q[:, sl], k[:, sl], v[:, sl], s_old,
                                               _Axis(rank)))
        assert s_new.counter == s_old.counter == base + 2 * 4 * 64 * 64


def test_ref_arguments_are_checked():
    q, k, v = _qkv(2, 2, 64, 8)
    seed = torch.tensor(SEED)
    with pytest.raises(ValueError, match="outside"):
        torch.ops.dmf.flash_forward_dropout(q, k, v, 0.5, 0.0, seed, 0, 0, 1, 2, 0)
    with pytest.raises(ValueError, match="heads"):
        torch.ops.dmf.flash_forward_dropout(q, k, v, 0.5, P, seed, 0, 0, 1, 2, 1)
    with pytest.raises(ValueError, match="passes"):
        torch.ops.dmf.flash_forward_dropout(q, k, v, 0.5, P, seed, 0, 0, 3, 2, 0)


def _jax_mhsa(p, n=512, embed=32, heads=2):
    rng = np.random.RandomState(3)
    x = rng.randn(2, n, embed).astype(np.float32)
    jm = JaxMHSA(embed, heads, attn_drop=p, proj_drop=0.0)
    params = randomize(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                               train=False), 4)["params"]
    pm = MultiHeadSelfAttention(embed, heads, attn_drop=p, proj_drop=0.0)
    exp = _Exporter()
    exp.dense(_to_host(params)["qkv"], "qkv")
    exp.dense(_to_host(params)["proj"], "proj")
    load_reference_state_dict(pm, exp.out)
    return x, jm, params, pm


def test_module_matches_jax_with_the_injected_mask(monkeypatch):
    """MHSA at 512 tokens (the flash shapes) on a seed stream: the fused
    route, against JAX's XLA weights with the seed route's mask of the whole
    (B, H, N, N) weights injected, then its value product and projection."""
    x, jm, params, pm = _jax_mhsa(P)
    calls = []
    ref = flash_attention.flash_attention_dropout_ref
    monkeypatch.setattr(flash_attention, "flash_attention_dropout_ref",
                        lambda *a, **kw: calls.append(a[4:]) or ref(*a, **kw))
    seed = torch.tensor(SEED)
    stream = dropout.SeedStream(seed, counter=16, first_pass=2, passes=2)
    with torch.no_grad():
        out = pm(torch.from_numpy(x), mc=True, generator=stream)
    assert len(calls) == 1, "the fused route"
    B, N, C, H = 2, 512, 32, 2
    D = C // H
    keep = dropout.keep_mask_plain((B, H, N, N), P, seed, 16, 2, 2)
    assert 0.85 < keep.float().mean() < 0.95

    qkv = jnp.asarray(x) @ params["qkv"]["kernel"] + params["qkv"]["bias"]
    q, k, v = qkv.reshape(B, N, 3, H, D).transpose(2, 0, 3, 1, 4)
    _, w = _xla_attention(q, k, v, D ** -0.5)
    w = w * jnp.asarray(keep.numpy()) / (1.0 - P)
    want = jnp.einsum("bhqk,bhkd->bhqd", w, v).transpose(0, 2, 1, 3).reshape(B, N, C)
    want = want @ params["proj"]["kernel"] + params["proj"]["bias"]
    assert_close(out, want)
    assert stream.counter == 16 + B * H * N * N // 2


def test_module_without_dropout_matches_jax():
    """``attn_drop = 0``: the MC route is attention without dropout, JAX's
    module's function at 512 tokens."""
    x, jm, params, pm = _jax_mhsa(0.0)
    stream = dropout.SeedStream(torch.tensor(SEED))
    with torch.no_grad():
        out = pm(torch.from_numpy(x), mc=True, generator=stream)
    assert stream.counter == 0
    assert_close(out, jm.apply({"params": params}, jnp.asarray(x), train=False))


def test_generator_keeps_the_weights_route():
    """A ``torch.Generator`` (training, a direct ``mc=True`` call) keeps the
    weights route below the flash shapes (256 tokens: its mask the
    generator's ``uniform_`` draw); at 512 tokens it takes the fused route
    on one seed drawn from the generator, the counters from 0: the weights
    route's function on that seed's keep mask."""
    for n in (256, 512):
        x, _, _, pm = _jax_mhsa(P, n=n)
        B, N, C, H = 2, n, 32, 2
        with torch.no_grad():
            out = pm(torch.from_numpy(x), mc=True, generator=torch.Generator().manual_seed(9))
            q, k, v = pm.qkv(torch.from_numpy(x)).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1,
                                                                                     4)
            g = torch.Generator().manual_seed(9)
            if n == 256:
                keep = torch.empty(B, H, N, N).uniform_(generator=g) < 1 - P
            else:
                seed = torch.randint(0, 2 ** 63 - 1, (1,), generator=g, dtype=torch.int64)
                keep = dropout.keep_mask_plain((B, H, N, N), P, seed, 0)
            w = torch.where(keep, attention_weights(q, k, (C // H) ** -0.5) / (1 - P), 0.0)
            want = pm.proj(torch.einsum("bhqk,bhkd->bhqd", w, v).transpose(1, 2).reshape(B, N, C))
        assert torch.equal(out, want), n


@pytest.fixture(scope="module")
def hybrid_nb():
    return _build(hybrid_cfg(dropout=0.2, mc_passes=PASSES))


@pytest.mark.parametrize("mode", ["mc", "tta_mc"])
def test_ensemble_through_the_operator_is_chunk_invariant(hybrid_nb, mode, monkeypatch):
    """The toy ``hybrid-nb`` ensemble with every attention site on the fused
    route (``use_flash`` patched to hold at its 16 tokens): each (pass,
    site) mask bit-equal across ``mc_chunk`` None / 1 / 2 / 4, the ensemble
    within ``rtol=1e-5, atol=1e-6``, and the same as the weights route's."""
    pcfg, models = hybrid_nb
    calls = []
    ref = flash_attention.flash_attention_dropout_ref
    monkeypatch.setattr(flash_attention, "flash_attention_dropout_ref",
                        lambda *a, **kw: calls.append(1) or ref(*a, **kw))
    weights = _chunked(lambda c: make_fusion_predictor(pcfg, *models, mode=mode, mc_chunk=c),
                       _request(), (None,))
    assert not calls
    monkeypatch.setattr(transformer, "use_flash", lambda *a: True)
    runs = _chunked(lambda c: make_fusion_predictor(pcfg, *models, mode=mode, mc_chunk=c),
                    _request())
    depth = sum(len(m.transformer.transformer.layers) for m in models[:2])
    # each lean chunk and the last pass run every attention site once
    assert len(calls) == depth * sum(-(-(PASSES - 1) // (PASSES - 1 if c is None else c)) + 1
                                     for c in runs)
    _held(runs)
    _held({"weights": weights[None], "fused": runs[None]})


class _Site(torch.nn.Module):
    def __init__(self, mhsa):
        super().__init__()
        self.attn = mhsa

    def forward(self, x, seed):
        return self.attn(x, mc=True, generator=dropout.SeedStream(seed, passes=2))


def test_export_holds_the_operator():
    """``torch.export`` of an MC attention site on the seed route: one
    ``flash_forward_dropout`` node, and the program gives eager's output."""
    x, _, _, pm = _jax_mhsa(P)
    site = _Site(pm).eval()
    args = (torch.from_numpy(x), torch.tensor(SEED))
    with torch.no_grad():
        ep = torch.export.export(site, args)
        want = site(*args)
        got = ep.module()(*args)
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"
             and "flash_forward_dropout" in str(n.target)]
    assert len(nodes) == 1
    assert torch.equal(got, want)


# ------------------------------------------------ the head-shared instance
@pytest.mark.parametrize("heads,h0,local_heads,base,group", [
    (4, 0, 4, 0, 4),            # served: four heads, base 0
    (4, 0, 4, 2 ** 33 + 4, 4),  # served: a base past 2^33
    (4, 0, 2, 0, 2),            # a 2-way head shard, rank 0
    (4, 2, 2, 0, 2),            # a 2-way head shard, rank 1
    (4, 0, 4, 1000, 4),         # base 1000, a multiple of 4
    (4, 0, 4, 2 ** 32 - 2, 1),  # base = 2 mod 4: the per-element instance
    (4, 2, 2, 2 ** 32 - 2, 1),
    (2, 0, 2, 0, 1),            # H = 2: a call holds two keys of two heads
    (8, 0, 8, 0, 4),            # H = 8: two calls a weight's (q, k)
    (8, 4, 4, 16, 4),           # the second half of 8 heads
    (12, 2, 2, 8, 2),           # 12 heads, a 2-head shard at h0 = 2
    (4, 1, 2, 0, 1)])           # a shard that splits a call's heads unevenly
def test_instance_rule(heads, h0, local_heads, base, group):
    """Which instance the dropout forward takes: the head-shared one (G = 4,
    or 2 on a 2-way head shard) where H and the counter base are multiples of
    4 and the call's heads are whole groups of G, the per-element one (G = 1)
    for every other shape."""
    assert flash_attention.dropout_group(heads, h0, local_heads, base) == group


@pytest.mark.parametrize("dtype,d,nk,tile,words", [
    (torch.bfloat16, 128, 4096, 128, 128),  # the served rows: 4 words a tile of 128 keys
    (torch.bfloat16, 64, 320, 128, 12),     # a half-full last tile counts whole
    (torch.float32, 128, 4096, 32, 128),    # 3xTF32 at D=128: one word a 32-key tile
    (torch.float32, 64, 192, 64, 6)])       # 3xTF32 at D=64: two words a 64-key tile
def test_bits_rows_follow_the_key_tile(dtype, d, nk, tile, words):
    """The head-shared instance's keep bits of a row b: heads x N_q rows of
    N_k bits rounded up to the forward's key tile."""
    assert flash_attention.dropout_key_tile(dtype, d) == tile
    assert flash_attention.dropout_bits_words(dtype, d, 4, 192, nk) == 4 * 192 * words


def _head_shared_replay(q_shape, nk, heads, h0, base, first_pass, passes, seed, bn, group):
    """The head-shared instance's keep bits as its consumer threads read them,
    replayed on the CPU: the pre-pass, for each row b, group of ``group``
    heads and query q, draws the Philox calls of each key tile of ``bn``
    keys in chunks of 8 calls (the kernel's counters, byte g of a chunk head
    g's 8 bits), four chunks make a word of each head's bits, N_k rounded up
    to the tile; the consumer of quad ``quad`` reads its ``bn / 4`` bits of a
    tile at ``quad * bn / 4`` and keeps key ``8 j + 2 quad + e`` on bit ``2 j
    + e``.  Returns the (B, H_local, N_q, N_k) mask."""
    B, local, nq = q_shape
    rows, hq, words_tile, chunks_tile = B // passes, heads // 4, bn // 32, bn // 8
    nkt = -(-nk // bn)
    thr = dropout.keep_threshold(P) * 256 - 1
    s = int(seed)
    keys = (torch.tensor(s & 0xFFFFFFFF), torch.tensor((s >> 32) & 0xFFFFFFFF))
    keep = torch.zeros(B, local, nq, nk, dtype=torch.bool)
    # the pre-pass's chunks of one query row: (key tile, chunk) -> counter offset
    i = torch.arange(nkt * chunks_tile)
    kt, c = i // chunks_tile, i % chunks_tile
    cq, j0 = c // (chunks_tile // 4), 4 * (c % (chunks_tile // 4))
    # the consumers' fragment: (key tile, quad, j, e) -> bit position and key
    tq, quad, j, e = torch.meshgrid(torch.arange(nkt), torch.arange(4),
                                    torch.arange(bn // 8), torch.arange(2), indexing="ij")
    first = quad * (bn // 4)  # the thread's first bit position in its tile
    key = tq * bn + 8 * j + 2 * quad + e
    ok = key < nk
    qs = torch.arange(nq)[:, None]
    for b in range(B):
        pass_word = torch.tensor(first_pass + b // rows)
        for gi in range(local // group):
            h_first = h0 + gi * group
            at = base // 4 + ((b % rows) * nq + qs) * nk * hq + h_first // 4
            call = at + (kt * bn + 8 * j0 + 2 * cq) * hq  # (N_q, chunks)
            x = torch.zeros(nq, len(i), 4, dtype=torch.int64)
            for bit in range(8):
                n = call + (8 * (bit // 2) + bit % 2) * hq
                words = dropout.philox4x32(n & 0xFFFFFFFF, n >> 32, pass_word.expand_as(n),
                                           torch.zeros_like(n), *keys)
                for g in range(4):
                    x[..., g] |= (words[g] <= thr).long() << bit
            for g in range(group):
                sel = (h_first % 4 + g) & 3
                row = torch.zeros(nq, nkt * words_tile, dtype=torch.int64)
                row.index_add_(1, i // 4, x[..., sel] << (8 * (i % 4)))
                bits = row[:, tq * words_tile + first // 32] >> (first % 32)
                kept = ((bits >> (2 * j + e)) & 1).bool()
                keep[b, gi * group + g][:, key[ok]] = kept[:, ok]
    return keep


@pytest.mark.parametrize("heads,h0,local_heads,base,first_pass,passes,bn", [
    (4, 0, 4, 0, 0, 1, 128),            # bf16's key tile, the served call
    (4, 0, 4, 2 ** 33 + 4, 5, 2, 32),   # fp32 D=128's tile, pass words 5, 6
    (4, 2, 2, 1000, 3, 1, 64),          # fp32 D=64's tile, a shard at h0 = 2
    (8, 4, 4, 16, 0, 2, 128)])          # 8 heads, the second group
def test_head_shared_layout_gives_the_seed_route_bits(heads, h0, local_heads, base,
                                                      first_pass, passes, bn):
    """The head-shared instance's counters, word transposition and bit
    layout (its pre-pass's and its consumers'), replayed, give each consumer
    thread the keep bits of the seed route's mask of the whole (B, H, N_q,
    N_k) weights (``keep_mask_plain``, heads ``h0 ..``), on a ragged N_q and
    N_k (a half-full query block and key tile): the bits the per-element
    instance draws one call a weight."""
    group = flash_attention.dropout_group(heads, h0, local_heads, base)
    assert group > 1
    B, nq, nk = 2 * passes, 192, 2 * bn + 64 if bn == 128 else 3 * bn
    seed = torch.tensor(SEED)
    got = _head_shared_replay((B, local_heads, nq), nk, heads, h0, base, first_pass, passes,
                              SEED, bn, group)
    want = dropout.keep_mask_plain((B, heads, nq, nk), P, seed, base, first_pass,
                                   passes).narrow(1, h0, local_heads)
    assert torch.equal(got, want)
