"""The port's blocked exact search (`DescriptorIndex(db_block=...)`) and
chunked build (`build_chunked`) against its single-shot search and
`build`, and against the JAX package's `DescriptorIndex(db_block=...)`,
`chunk_topk` and `build_chunked`, on the CPU.

Galleries of 64 and 67 rows of dimension 64, every row leaning along one
direction u, so that the query -u scores every row negative: a padded
row's zero score would displace a real candidate if the padding were
masked after a block's top-k (the int8 index pads 67 rows to 72, and the
sharded one pads its tail shard). Exact duplicate rows straddle block
boundaries. Blocks of 16 rows divide 64 rows and leave a tail of 3 (bf16)
or 8 (int8, 5 of them padding) at 67; an int8 block of 36 rounds up to
40 (`_ROW_QUANTUM`). k = 5 and k = 20 (past a block's rows), queries in
one chunk and in chunks of 3.

What is compared, as in `tests/test_torch_sharded_index.py` (`torch.topk`
does not document its order among exact ties): every score within 1e-6
and, at each rank position, the row's exact f64 score equal to the
reference row's; the indices exactly wherever the reference row's score is
held by no other row. The blocked merge orders exact ties by the lower
row, as `lax.top_k` does: checked on the int8 index, whose duplicate rows
score exactly alike in any block (an f32 product of a bf16 row may round
differently in two blocks' products). The chunked build's rows and scales are bit for
bit those of `build` and of JAX's `build`; JAX's jitted `build_chunked` gives the
bf16 rows bit for bit and the int8 scales within one f32 ulp (XLA turns
its amax / 127 into a product by the reciprocal), a code moving by at
most one only in a row whose scale moved.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geovpr.parallel import create_mesh as j_create_mesh
from geovpr.retrieval import index as jidx
from geovpr_torch.retrieval import index as tidx
from torch_parallel_ranks import run_ranks

DIM = 64
ATOL = 1e-6
DUPLICATES = ((15, 16), (31, 32), (39, 40), (47, 48))
CASES = [  # (quantize, rows, db_block)
    (False, 64, 16), (False, 67, 16), (True, 64, 16), (True, 67, 16),
    (True, 67, 36)]


def _data(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=DIM)
    u /= np.linalg.norm(u)
    g = rng.normal(size=(n, DIM)) / np.sqrt(DIM) + 0.5 * u
    for a, b in DUPLICATES:
        g[b] = g[a]
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[[31, 15, 39, 47, 50, 5]] + 0.05 * rng.normal(size=(6, DIM))
    q = np.concatenate([q, -u[None]])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return g.astype(np.float32), q.astype(np.float32)


def _exact(index: tidx.DescriptorIndex, q: np.ndarray) -> np.ndarray:
    """The (Q, N) f64 scores of the stored rows."""
    rows, scale = index.whole_rows()
    if scale is None:
        qq = torch.from_numpy(q).to(index.dtype).double().numpy()
        return qq @ rows.double().numpy().T
    q8, qs = tidx.quantize_rows(torch.from_numpy(q))
    dots = q8.double().numpy() @ rows.double().numpy().T
    return dots * qs.double().numpy()[:, None] * \
        scale.double().numpy()[None, :]


def assert_same_search(got, want, exact):
    gs, gi = (np.asarray(a) for a in got)
    ws, wi = (np.asarray(a) for a in want)
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gs, ws, rtol=0, atol=ATOL)
    n = exact.shape[1]
    for qi in range(wi.shape[0]):
        row = exact[qi]
        for pos in range(wi.shape[1]):
            w, g = int(wi[qi, pos]), int(gi[qi, pos])
            assert 0 <= g < n
            assert abs(row[g] - row[w]) <= ATOL, (qi, pos, g, w)
            if (np.abs(row - row[w]) <= ATOL).sum() == 1:
                assert g == w, (qi, pos)


def assert_ties_lower_row_first(idx):
    for a, b in DUPLICATES:
        for hits in np.asarray(idx).tolist():
            if a in hits and b in hits:
                assert hits.index(a) < hits.index(b)


@pytest.mark.parametrize("chunk", [0, 3])
@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("quantize, n, block", CASES)
def test_blocked_matches_single_shot_and_jax(quantize, n, block, k, chunk):
    g, q = _data(n)
    single = tidx.DescriptorIndex(dim=DIM, quantize=quantize,
                                  query_chunk=chunk).build(g)
    blocked = tidx.DescriptorIndex(dim=DIM, quantize=quantize,
                                   query_chunk=chunk, db_block=block).build(g)
    rows = blocked._db.shape[0]
    assert rows == (-(-n // 8) * 8 if quantize else n)
    width = blocked._block()
    assert width == (-(-block // 8) * 8 if quantize else block)
    assert (rows % width == 0) == (n == 64)
    exact = _exact(single, q)
    want = tuple(t.numpy() for t in single.search(q, k))
    got = tuple(t.numpy() for t in blocked.search(q, k))
    assert_same_search(got, want, exact)
    if quantize:
        assert_ties_lower_row_first(got[1])
    # the negative-cosine query: every score below zero, no padded row
    assert (got[0][-1] < 0).all() and got[1][-1].max() < n
    jindex = jidx.DescriptorIndex(dim=DIM, quantize=quantize,
                                  query_chunk=chunk,
                                  db_block=block).build(jnp.asarray(g))
    js, ji = jindex.search(jnp.asarray(q), k)
    assert_same_search(got, (np.asarray(js), np.asarray(ji)), exact)


@pytest.mark.parametrize("quantize, n, block", CASES)
def test_chunk_topk_matches_jax(quantize, n, block):
    """One query chunk's blocked top-k against JAX's `chunk_topk` on the
    same stored rows, scales and quantized queries, the padded rows
    masked by `n_real`."""
    g, q = _data(n)
    index = tidx.DescriptorIndex(dim=DIM, quantize=quantize,
                                 db_block=block).build(g)
    qt = torch.from_numpy(q)
    got = tuple(t.numpy() for t in index._chunk_topk(
        qt if quantize else qt.to(index.dtype), 5))
    db = index._db.float().numpy() if not quantize else index._db.numpy()
    if quantize:
        q8, qs = tidx.quantize_rows(qt)
        ops = (jnp.asarray(q8.numpy()), jnp.asarray(qs.numpy()),
               jnp.asarray(db), jnp.asarray(index._db_scale.numpy()))
    else:
        ops = (jnp.asarray(qt.to(torch.bfloat16).float().numpy()), None,
               jnp.asarray(db), None)
    js, ji = jidx.chunk_topk(*ops, 5, db_block=index._block(),
                             n_real=n if index._db.shape[0] > n else None)
    assert_same_search(got, (np.asarray(js), np.asarray(ji)),
                       _exact(index, q))


def assert_rows_within(index, jindex, ulps: int):
    """The real rows (and int8 scales) of the port's index against a JAX
    index's: bf16 rows and f32 scales within `ulps` units in the last
    place, an int8 code moving by at most one only in a row whose scale
    moved."""
    n = index.size
    if index.quantize:
        scale = index._db_scale[:n].numpy().view(np.int32)
        moved = np.abs(scale - np.asarray(jindex._db_scale)[:n].view(
            np.int32))
        assert moved.max() <= ulps
        codes = np.abs(index._db[:n].numpy().astype(int)
                       - np.asarray(jindex._db)[:n].astype(int))
        assert codes.max() <= min(ulps, 1) and not codes[moved == 0].any()
    else:
        bits = index._db[:n].view(torch.int16).numpy().astype(int)
        jbits = np.asarray(jindex._db)[:n].view(np.int16).astype(int)
        assert np.abs(bits - jbits).max() <= ulps


def _chunks(g, size, dtype=None):
    for a in range(0, len(g), size):
        c = torch.from_numpy(g[a:a + size])
        yield c if dtype is None else c.to(dtype)


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("quantize", [False, True])
def test_build_chunked_matches_build_and_jax(quantize, normalized):
    """Chunks of 10 rows (a ragged last chunk) of a 67-row gallery, unit
    rows or rows scaled by 3 with `normalized=False`: the stored rows and
    scales bit for bit those of `build` and of JAX's `build`, within the
    module docstring's bound of JAX's `build_chunked`, the
    padded rows zero with scale 1; the same search. `_install` (and its
    padding concatenation, which would hold the index twice) never runs."""
    g, q = _data(67)
    src = g if normalized else 3.0 * g
    want = tidx.DescriptorIndex(dim=DIM, quantize=quantize).build(
        src, normalized=normalized)
    index = tidx.DescriptorIndex(dim=DIM, quantize=quantize, db_block=16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tidx.DescriptorIndex, "_install", None)
        index.build_chunked(_chunks(src, 10), total=67,
                            normalized=normalized)
    assert index.size == 67
    assert torch.equal(index._db, want._db)
    if quantize:
        assert torch.equal(index._db_scale, want._db_scale)
        assert index._db.shape[0] == 72
        assert not index._db[67:].any() and (index._db_scale[67:] == 1).all()
    jindex = jidx.DescriptorIndex(dim=DIM, quantize=quantize).build_chunked(
        (np.asarray(c) for c in _chunks(src, 10)), total=67,
        normalized=normalized)
    jeager = jidx.DescriptorIndex(dim=DIM, quantize=quantize).build(
        jnp.asarray(src), normalized=normalized)
    rows = index._db[:67]
    if normalized:
        assert_rows_within(index, jeager, 0)
    # JAX's jitted fill computes amax / 127 as amax * (1 / 127), one f32
    # ulp off its own eager `build` in some rows; with normalized=False
    # each package's L2 norm rounds its own way (up to two ulps of the
    # normalized row's amax)
    assert_rows_within(index, jindex, 1 if normalized else 2)
    if not normalized:
        assert_rows_within(index, jeager, 2)
    got = tuple(t.numpy() for t in index.search(q, 5))
    exact = _exact(want, q)
    assert_same_search(got, tuple(t.numpy() for t in want.search(q, 5)),
                       exact)
    js, ji = jindex.search(jnp.asarray(q), 5)
    assert_same_search(got, (np.asarray(js), np.asarray(ji)), exact)


def test_build_chunked_from_bf16_and_numpy_chunks():
    """Chunks of any dtype or kind are widened to f32 on the device before
    the cast, as JAX's `fill` does: bf16 tensor chunks give the index of
    their f32 widening, numpy chunks the index of the tensors."""
    g, _ = _data(67)
    want = tidx.DescriptorIndex(dim=DIM, quantize=True).build(
        torch.from_numpy(g).to(torch.bfloat16).float())
    got = tidx.DescriptorIndex(dim=DIM, quantize=True).build_chunked(
        _chunks(g, 16, torch.bfloat16), total=67)
    assert torch.equal(got._db, want._db)
    assert torch.equal(got._db_scale, want._db_scale)
    arrays = tidx.DescriptorIndex(dim=DIM).build_chunked(
        (g[a:a + 16] for a in range(0, 67, 16)), total=67)
    assert torch.equal(arrays._db, tidx.DescriptorIndex(dim=DIM).build(g)._db)


@pytest.mark.parametrize("total, match", [
    (60, "chunks exceed total=60"),
    (70, "chunks carried 67 rows, expected total=70")])
def test_build_chunked_row_count_errors(total, match):
    g, _ = _data(67)
    for quantize in (False, True):
        with pytest.raises(ValueError, match=match):
            tidx.DescriptorIndex(dim=DIM, quantize=quantize).build_chunked(
                _chunks(g, 10), total=total)
        with pytest.raises(ValueError, match=match):
            jidx.DescriptorIndex(dim=DIM, quantize=quantize).build_chunked(
                (np.asarray(c) for c in _chunks(g, 10)), total=total)


MESH_CONFIGS = {
    "bf16_k5": dict(quantize=False, k=5, db_block=16, chunk=10),
    "bf16_kbig": dict(quantize=False, k=30, db_block=8, chunk=7),
    "int8_k5": dict(quantize=True, k=5, db_block=16, chunk=10),
    "int8_kbig": dict(quantize=True, k=30, db_block=12, chunk=64)}


def test_two_ranks_blocked_chunked_match_one_process_and_jax(tmp_path):
    """Two gloo ranks: each builds its shard with `build_chunked` (chunks
    straddling the shard boundary) and searches it block by block; the
    merged result equals the single-process single-shot search and JAX's
    blocked search on its 8-device mesh."""
    g, q = _data(67)
    ranks = run_ranks([("blocked_search", dict(gallery=g, queries=q,
                                               configs=MESH_CONFIGS))],
                      2, tmp_path)
    for name, cfg in MESH_CONFIGS.items():
        first = ranks[0]["blocked_search"][name]
        for res in ranks:
            got = res["blocked_search"][name]
            np.testing.assert_array_equal(got[0], first[0])
            np.testing.assert_array_equal(got[1], first[1])
        assert first[2] == (40 if cfg["quantize"] else 34)
        single = tidx.DescriptorIndex(dim=DIM,
                                      quantize=cfg["quantize"]).build(g)
        exact = _exact(single, q)
        want = tuple(t.numpy() for t in single.search(q, cfg["k"]))
        assert_same_search(first[:2], want, exact)
        if cfg["quantize"]:
            assert_ties_lower_row_first(first[1])
        assert (first[0][-1] < 0).all() and first[1][-1].max() < 67
        jindex = jidx.DescriptorIndex(
            dim=DIM, quantize=cfg["quantize"], mesh=j_create_mesh(),
            db_block=cfg["db_block"]).build(jnp.asarray(g))
        js, ji = jindex.search(jnp.asarray(q), cfg["k"])
        assert_same_search(first[:2], (np.asarray(js), np.asarray(ji)),
                           exact)
