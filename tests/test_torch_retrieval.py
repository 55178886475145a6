"""The port's descriptor index and retrieval metrics against
`geovpr.retrieval.index` (single device), plus the index file format both
ways and the host helpers the port repeats from the JAX package.

Score tolerance 1e-6: both sides widen the same bf16 rows to f32 and take an
f32 matmul of unit vectors; only summation order differs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geovpr.data.pipeline import ArraySource as JArraySource
from geovpr.data.pipeline import iterate_batches as j_iterate_batches
from geovpr.pipeline.export import (
    write_retrieval_matches_csv as j_write_matches)
from geovpr.retrieval import index as jidx
from geovpr_torch.data.pipeline import ArraySource, iterate_batches
from geovpr_torch.retrieval import index as tidx

DIM = 64


def _unit(rng, n):
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_same_search(t_out, j_out):
    ts, ti = (t.cpu().numpy() for t in t_out)
    js, ji = np.asarray(j_out[0]), np.asarray(j_out[1])
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)


@pytest.mark.parametrize("query_chunk", [0, 4, 1024])
def test_search_matches_jax(query_chunk):
    """Query chunking (4 < Q = 10, with a ragged last chunk) gives the same
    top-k as JAX; negative cosines included."""
    rng = np.random.default_rng(0)
    db, q = _unit(rng, 40), _unit(rng, 10)
    q[:3] = -db[:3]                      # some all-negative neighbourhoods
    j = jidx.DescriptorIndex(dim=DIM, query_chunk=query_chunk).build(db)
    t = tidx.DescriptorIndex(dim=DIM, query_chunk=query_chunk).build(db)
    assert t.size == j.size == 40
    _assert_same_search(t.search(q, k=5), j.search(jnp.asarray(q), k=5))


def test_padded_rows_never_win_over_negative_cosines():
    """JAX pads 40 rows to 48 for db_block=16 and masks the zero rows to
    -inf before the top-k; the port's index installed with the same padding
    and n_real must return the same, all-negative, neighbours."""
    rng = np.random.default_rng(1)
    db = _unit(rng, 40)
    q = -db[:6]                          # every true cosine is <= ~0
    q = q + 0.3 * db[6:12]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    j = jidx.DescriptorIndex(dim=DIM, db_block=16).build(db)
    assert j._db.shape[0] == 48
    t = tidx.DescriptorIndex(dim=DIM)
    t._install(torch.from_numpy(np.array(j._db.astype(jnp.float32)))
               .to(torch.bfloat16), n_real=40)
    t_out = t.search(q, k=40)
    assert int(t_out[1].max()) < 40
    _assert_same_search(t_out, j.search(jnp.asarray(q), k=40))


def test_build_normalizes_when_asked():
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(12, DIM)).astype(np.float32) * 3
    j = jidx.DescriptorIndex(dim=DIM).build(raw, normalized=False)
    t = tidx.DescriptorIndex(dim=DIM).build(raw, normalized=False)
    q = _unit(rng, 3)
    _assert_same_search(t.search(q, k=4), j.search(jnp.asarray(q), k=4))


def test_index_rejects_what_is_not_ported():
    """A mesh must be the port's `parallel.Mesh` (the sharded search itself:
    tests/test_torch_sharded_index.py); k past the index size raises."""
    with pytest.raises(TypeError, match="Mesh"):
        tidx.DescriptorIndex(dim=DIM, mesh=object())
    t = tidx.DescriptorIndex(dim=DIM).build(_unit(np.random.default_rng(3),
                                                  4))
    with pytest.raises(ValueError):
        t.search(np.zeros((1, DIM), np.float32), k=5)


def test_cosine_topk_and_recall_match_jax():
    rng = np.random.default_rng(4)
    db = rng.normal(size=(30, DIM)).astype(np.float32)
    q = rng.normal(size=(7, DIM)).astype(np.float32)
    js, ji = jidx.cosine_topk(jnp.asarray(q), jnp.asarray(db), 6,
                              normalized=False)
    ts, ti = tidx.cosine_topk(torch.from_numpy(q), torch.from_numpy(db), 6,
                              normalized=False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    pos = rng.integers(0, 30, 7)
    for k in (1, 3, 6):
        assert float(tidx.recall_at_k(ti, torch.from_numpy(pos), k)) == \
            pytest.approx(float(jidx.recall_at_k(ji, jnp.asarray(pos), k)))


@pytest.mark.parametrize("radius", [0.0, 15.0, 60.0])
def test_recall_at_k_radius_matches_jax(radius):
    rng = np.random.default_rng(5)
    g_ll = rng.uniform(0, 100, (20, 2)).astype(np.float32)
    q_ll = rng.uniform(0, 100, (9, 2)).astype(np.float32)
    q_ll[:3] = g_ll[:3]
    nbrs = rng.integers(0, 20, (9, 5))
    nbrs[:3, 0] = np.arange(3)
    for k in (1, 5):
        want = float(jidx.recall_at_k_radius(
            jnp.asarray(nbrs), jnp.asarray(q_ll), jnp.asarray(g_ll),
            radius, k))
        got = float(tidx.recall_at_k_radius(nbrs, q_ll, g_ll, radius, k))
        assert got == pytest.approx(want)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_index_file_is_shared_both_ways(tmp_path, writer):
    """An index saved by either package loads in the other (bf16 rows as
    uint16 bits) with its metadata and searches the same."""
    rng = np.random.default_rng(6)
    db, q = _unit(rng, 25), _unit(rng, 4)
    names = [f"g_{i}.jpg" for i in range(25)]
    latlon = rng.uniform(0, 1, (25, 2)).astype(np.float32)
    path = os.path.join(tmp_path, "index.npz")
    if writer == "jax":
        jidx.save_index(jidx.DescriptorIndex(dim=DIM).build(db), path,
                        filenames=names, latlon=latlon)
    else:
        tidx.save_index(tidx.DescriptorIndex(dim=DIM).build(db), path,
                        filenames=names, latlon=latlon)
    j, j_meta = jidx.load_index(path)
    t, t_meta = tidx.load_index(path)
    assert t._db.dtype == torch.bfloat16 and t.size == j.size == 25
    assert list(t_meta["filenames"]) == list(j_meta["filenames"]) == names
    np.testing.assert_array_equal(t_meta["latlon"], latlon)
    np.testing.assert_array_equal(
        t._db.float().numpy(), np.asarray(j._db.astype(jnp.float32)))
    _assert_same_search(t.search(q, k=3), j.search(jnp.asarray(q), k=3))


@pytest.mark.parametrize("with_names", [True, False])
def test_matches_csv_is_byte_equal(tmp_path, with_names):
    rng = np.random.default_rng(7)
    nbrs = rng.integers(0, 6, (3, 2))
    scores = rng.normal(size=(3, 2)).astype(np.float32)
    gallery = [f"g{i}.jpg" for i in range(6)] if with_names else None
    queries = ["q0.jpg", "q1.jpg", "q2.jpg"]
    a, b = os.path.join(tmp_path, "a.csv"), os.path.join(tmp_path, "b.csv")
    j_write_matches(a, queries, gallery, nbrs, scores)
    tidx.write_retrieval_matches_csv(b, queries, gallery, nbrs, scores)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("batch_size", [1, 4, 5, 16])
def test_iterate_batches_matches_jax(batch_size):
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 255, (10, 4, 4, 3)).astype(np.uint8)
    tg = rng.normal(size=(10, 2)).astype(np.float32)
    want = list(j_iterate_batches(JArraySource(imgs, tg), batch_size))
    got = list(iterate_batches(ArraySource(imgs, tg), batch_size))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_prefetch_to_cpu_keeps_metadata():
    from geovpr_torch.data.pipeline import prefetch_to_device

    imgs = np.arange(5 * 2 * 2 * 3, dtype=np.uint8).reshape(5, 2, 2, 3)
    src = ArraySource(imgs, np.zeros((5, 2), np.float32))
    out = list(prefetch_to_device(iterate_batches(src, 2), "cpu", depth=1))
    assert len(out) == 3
    assert torch.equal(out[0]["image"], torch.from_numpy(imgs[:2]))
    np.testing.assert_array_equal(out[2]["_indices"], [4])
