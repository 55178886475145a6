"""The port's int8 descriptor index against `geovpr.retrieval.index`
(`quantize=True`), the int8 `.npz` both ways, and the int8 main path
through `run_retrieval` on the CPU.

Scores are compared to 1e-6: both sides quantize the same f32 rows
bit-equally (tests/test_torch_quant.py), take exact int32 products and
rescale them by the same two f32 multiplies in the same order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geovpr.retrieval import index as jidx
from geovpr_torch.retrieval import index as tidx

DIM = 64


def _unit(rng, n):
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_same_search(t_out, j_out):
    ts, ti = (t.cpu().numpy() for t in t_out)
    np.testing.assert_array_equal(ti, np.asarray(j_out[1]))
    np.testing.assert_allclose(ts, np.asarray(j_out[0]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("query_chunk", [0, 4])
def test_int8_search_matches_jax(query_chunk):
    """37 rows (padded to 40 in the port, masked), all-negative
    neighbourhoods included."""
    rng = np.random.default_rng(0)
    db, q = _unit(rng, 37), _unit(rng, 10)
    q[:3] = -db[:3]
    j = jidx.DescriptorIndex(dim=DIM, quantize=True,
                             query_chunk=query_chunk).build(db)
    t = tidx.DescriptorIndex(dim=DIM, quantize=True,
                             query_chunk=query_chunk).build(db)
    assert t._db.dtype == torch.int8 and t._db.shape == (40, DIM)
    assert t.size == j.size == 37
    out = t.search(q, k=37)
    assert int(out[1].max()) < 37
    _assert_same_search(out, j.search(jnp.asarray(q), k=37))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_int8_index_file_is_shared_both_ways(tmp_path, writer):
    rng = np.random.default_rng(1)
    db, q = _unit(rng, 21), _unit(rng, 5)
    names = [f"g_{i}.jpg" for i in range(21)]
    path = os.path.join(tmp_path, "index.npz")
    build = (jidx if writer == "jax" else tidx).DescriptorIndex
    (jidx if writer == "jax" else tidx).save_index(
        build(dim=DIM, quantize=True).build(db), path, filenames=names)
    j, _ = jidx.load_index(path)
    t, t_meta = tidx.load_index(path)
    assert t.quantize and j.quantize and t.size == j.size == 21
    assert list(t_meta["filenames"]) == names
    np.testing.assert_array_equal(t._db[:21].numpy(), np.asarray(j._db))
    np.testing.assert_array_equal(t._db_scale[:21].numpy(),
                                  np.asarray(j._db_scale))
    _assert_same_search(t.search(q, k=4), j.search(jnp.asarray(q), k=4))


def test_run_retrieval_int8_on_cpu(tmp_path, monkeypatch):
    """The int8 slice end to end on the CPU (a 2-layer, width-64 DINOv2 at
    56x56): the model calibrates on the first gallery batch, every query
    finds itself, the saved index is int8."""
    from geovpr_torch.cli.retrieve import build_model, run_retrieval
    from geovpr_torch.data.pipeline import ArraySource
    from geovpr_torch.models import dinov2

    monkeypatch.setitem(dinov2.DINOV2_VARIANTS, "tiny", dict(
        hidden_size=64, num_layers=2, num_heads=4))

    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (6, 4, 4, 3)).astype(np.float32)
    imgs = np.repeat(np.repeat(base, 14, 1), 14, 2).astype(np.uint8)
    src = ArraySource(imgs, (np.arange(12, dtype=np.float32) * 100)
                      .reshape(6, 2), [f"g{i}.jpg" for i in range(6)])
    model = build_model("tiny", 56, "cpu", seed=0, int8=True)
    idx = os.path.join(tmp_path, "ix.npz")
    out = run_retrieval(model, src, src, batch_size=4, top_k=2,
                        positive_radius=1.0, out_dir=str(tmp_path),
                        device="cpu", save_index_path=idx, int8=True)
    assert out["recall@1"] == 1.0 and out["gallery_size"] == 6
    blk = model.backbone.blocks[0]
    assert blk._k2 is not None and float(blk.mlp.a_in_scale) != 1.0
    index, _ = tidx.load_index(idx)
    assert index.quantize and index._db.dtype == torch.int8
