"""The port's sharded descriptor search (`DescriptorIndex(mesh=...)`) at
worlds 2 and 4 on the CPU over gloo, against the port's unsharded search
and JAX's sharded search on its 8-device CPU mesh.

A 67-row gallery (a padded tail shard at both worlds: bf16 shards of
34 / 17 rows, int8 shards of 40 / 24 rows, each a multiple of 8), every
row leaning along one direction u, so that the query -u scores every row
negative: a padded row's zero score would push a real candidate out of
its shard's local top-k if the padding were masked after it. Exact
duplicate rows straddle every shard boundary of both worlds. Seven queries
in chunks of three, k = 5 and k past the shard rows (40 at world 2, 45
in int8).

What is compared, since `torch.topk` does not document its order among
exact ties: every score within 1e-6 (bf16: an f32 plane per shard or one
plane; int8: the same exact integer products and scales) and, at each
rank position, the row's exact score (f64, from the stored rows) equal to
the reference row's; the indices themselves exactly wherever the
reference row's exact score is held by no other row. The merge orders
exact ties by the lower global row, as `lax.top_k` does, so the sharded
search's duplicates come lower row first.

`save_index` at world 2 writes one `.npz` (rank 0) that JAX's
`load_index` and the port's unsharded `load_index` read back to the same
search, and the ranks reload it sharded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geovpr.parallel import create_mesh as j_create_mesh
from geovpr.retrieval import index as jidx
from geovpr_torch.retrieval import index as tidx
from torch_parallel_ranks import run_ranks

DIM, N = 64, 67
ATOL = 1e-6
DUPLICATES = ((16, 17), (23, 24), (33, 34), (39, 40), (47, 48), (50, 51))
CONFIGS = {"bf16_k5": dict(quantize=False, k=5, chunk=3),
           "bf16_kbig": dict(quantize=False, k=40, chunk=0),
           "int8_k5": dict(quantize=True, k=5, chunk=3),
           "int8_kbig": dict(quantize=True, k=45, chunk=0)}


def _data():
    rng = np.random.default_rng(0)
    u = rng.normal(size=DIM)
    u /= np.linalg.norm(u)
    g = rng.normal(size=(N, DIM)) / np.sqrt(DIM) + 0.5 * u
    for a, b in DUPLICATES:
        g[b] = g[a]
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[[33, 16, 23, 47, 50, 5]] + 0.05 * rng.normal(size=(6, DIM))
    q = np.concatenate([q, -u[None]])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return g.astype(np.float32), q.astype(np.float32)


def _images():
    rng = np.random.default_rng(1)
    return (rng.integers(0, 255, (7, 28, 28, 3)).astype(np.uint8),
            (np.arange(14, dtype=np.float32) * 100).reshape(7, 2))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    g, q = _data()
    images, latlon = _images()
    out = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"index{world}")
        cases = [("sharded_search", dict(gallery=g, queries=q,
                                         configs=CONFIGS))]
        if world == 2:
            cases.append(("retrieve_and_score", dict(images=images,
                                                     latlon=latlon)))
        out[world] = (run_ranks(cases, world, tmp), tmp)
    return out


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
    for qi in range(wi.shape[0]):
        row = exact[qi]
        for pos in range(wi.shape[1]):
            w, g = int(wi[qi, pos]), int(gi[qi, pos])
            assert 0 <= g < N
            assert abs(row[g] - row[w]) <= ATOL, (qi, pos, g, w)
            if (np.abs(row - row[w]) <= ATOL).sum() == 1:
                assert g == w, (qi, pos)


def _unsharded(cfg, g, q):
    index = tidx.DescriptorIndex(dim=DIM, quantize=cfg["quantize"],
                                 query_chunk=cfg["chunk"]).build(g)
    s, i = index.search(q, k=cfg["k"])
    return (s.numpy(), i.numpy()), _exact(index, q)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_search_matches_unsharded_and_jax(worlds, world, name):
    g, q = _data()
    cfg = CONFIGS[name]
    ranks, _ = worlds[world]
    want, exact = _unsharded(cfg, g, q)
    shard_rows = ranks[0]["sharded_search"][name][2]
    assert shard_rows == (({2: 34, 4: 17} if not cfg["quantize"]
                           else {2: 40, 4: 24})[world])
    assert shard_rows * world > N          # a padded tail shard
    if name.endswith("kbig"):
        assert cfg["k"] > shard_rows
    first = ranks[0]["sharded_search"][name]
    for res in ranks:                          # every rank holds the result
        got = res["sharded_search"][name]
        np.testing.assert_array_equal(got[0], first[0])
        np.testing.assert_array_equal(got[1], first[1])
    assert_same_search(first[:2], want, exact)
    # the negative-cosine query: every score below zero, no padded row
    assert (first[0][-1] < 0).all() and first[1][-1].max() < N
    # duplicates straddling a boundary come lower row first
    for a, b in DUPLICATES:
        for qi in range(q.shape[0]):
            hits = list(first[1][qi])
            if a in hits and b in hits:
                assert hits.index(a) < hits.index(b)
    jindex = jidx.DescriptorIndex(dim=DIM, quantize=cfg["quantize"],
                                  mesh=j_create_mesh(),
                                  query_chunk=cfg["chunk"]).build(
        jnp.asarray(g))
    js, ji = jindex.search(jnp.asarray(q), k=cfg["k"])
    assert_same_search(first[:2], (np.asarray(js), np.asarray(ji)), exact)


@pytest.mark.parametrize("quantize", [False, True])
def test_save_index_at_world_2_reads_back(worlds, quantize):
    """The world-2 `.npz` through JAX's `load_index` (on its 8-device
    mesh), the port's unsharded `load_index`, and the ranks' sharded
    reload: each search equals the unsharded one."""
    g, q = _data()
    ranks, tmp = worlds[2]
    path = tmp / f"index_{int(quantize)}.npz"
    want, exact = _unsharded(dict(quantize=quantize, k=5, chunk=0), g, q)
    port, meta = tidx.load_index(str(path))
    assert port.size == N and list(meta["filenames"])[-1] == f"g{N - 1}"
    s, i = port.search(q, k=5)
    assert_same_search((s.numpy(), i.numpy()), want, exact)
    jindex, _ = jidx.load_index(str(path), mesh=j_create_mesh())
    js, ji = jindex.search(jnp.asarray(q), k=5)
    assert_same_search((np.asarray(js), np.asarray(ji)), want, exact)
    for res in ranks:
        assert_same_search(res["sharded_search"][f"reloaded_{int(quantize)}"],
                           want, exact)


def test_retrieve_and_evaluate_over_the_mesh_match_one_process(worlds,
                                                                tmp_path):
    """`run_retrieval --int8` at world 2 (batch 4 of 7 images: a sharded
    extraction, then a padded ragged batch) writes the CSV of the
    single-process run, byte for byte; `evaluate_and_predict` at world 2
    (batch 3, which the ranks do not divide: each batch padded to 4) gives
    its metrics and predictions."""
    from geovpr_torch.cli.evaluate import evaluate_and_predict
    from geovpr_torch.cli.retrieve import build_model, run_retrieval
    from geovpr_torch.data.pipeline import ArraySource
    from geovpr_torch.objectives.scaler import identity_scaler

    images, latlon = _images()
    src = ArraySource(images, latlon, [f"g{i}.jpg" for i in range(7)])
    torch.set_num_threads(1)
    model = build_model("small-14", 28, "cpu", seed=0, int8=True)
    rec = run_retrieval(model, src, src, batch_size=4, top_k=3,
                        positive_radius=150.0, out_dir=str(tmp_path),
                        device="cpu", int8=True)
    with open(rec["matches_csv"]) as f:
        want_csv = f.read()

    class Head(torch.nn.Module):
        def forward(self, x):
            return model(x).pooled.float()[:, :2] * 100.0

    metrics, preds = evaluate_and_predict(Head(), identity_scaler(2), src, 3,
                                          "cpu")
    for res in worlds[2][0]:
        got = res["retrieve_and_score"]
        assert got["csv"] == want_csv
        for k in ("gallery_size", "recall@1", "recall@3"):
            assert got["record"][k] == rec[k], k
        np.testing.assert_allclose(got["preds"], preds, rtol=1e-5,
                                   atol=1e-5)
        for k, v in metrics.items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-5), k
