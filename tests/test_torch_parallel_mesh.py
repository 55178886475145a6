"""The port's process mesh (`geovpr_torch.parallel.mesh`) against
`geovpr.parallel` on the same shapes.

One job of four gloo ranks on the CPU (`tests/torch_parallel_ranks.py`)
builds `create_mesh` and `create_hybrid_mesh` meshes on every rank; each
rank's view (the rank ids in the mesh, its coordinates, the members of its
`data` and `model` groups, found by an all-gather over each group) must
match the device ids JAX lays out over the first four of its eight CPU
devices, and both packages raise their ValueErrors on the same bad shapes.
The two-host hybrid layout (two ranks a host) has no single-process JAX
counterpart: each `model` line must stay on one host there. On the host
side `pad_batch_to_multiple` equals JAX's on a seeded batch and
`shard_batch` gives each rank the rows JAX places on its device.
"""

import jax
import numpy as np
import pytest

from geovpr.parallel import mesh as jmesh
from geovpr_torch.parallel import mesh as tmesh
from torch_parallel_ranks import run_ranks

WORLD = 4


def _batch(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, 4, 4, 3)).astype(np.uint8),
            "target": rng.normal(size=(n, 2)).astype(np.float32),
            "mask": np.arange(n) < n - 1}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks([("mesh_layouts", {}),
                      ("shard_batch_rows", {"batch": _batch()})],
                     WORLD, tmp_path_factory.mktemp("mesh"))


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _jax_meshes() -> dict:
    devs = jax.devices()[:WORLD]
    return {"default": jmesh.create_mesh(devices=devs),
            "dp_tp": jmesh.create_mesh((2, 2), ("data", "model"),
                                       devices=devs),
            "hybrid_one_host": jmesh.create_hybrid_mesh(
                (1, 2), (2, 1), ("data", "model"), devices=devs)}


@pytest.mark.parametrize("name", ["default", "dp_tp", "hybrid_one_host"])
def test_mesh_matches_jax(ranks, name):
    """Rank ids, shape, each rank's coordinates and its axis groups."""
    jm = _jax_meshes()[name]
    ids = _ids(jm)
    for r, res in enumerate(ranks):
        got = res["mesh_layouts"][name]
        assert res["mesh_layouts"]["world"] == WORLD
        np.testing.assert_array_equal(got["devices"], ids)
        assert got["shape"] == dict(jm.shape)
        coord = tuple(int(c) for c in np.argwhere(ids == r)[0])
        assert tuple(got["coords"][a] for a in jm.axis_names) == coord
        for i, axis in enumerate(jm.axis_names):
            line = np.moveaxis(ids, i, 0)[(slice(None),) + tuple(
                c for j, c in enumerate(coord) if j != i)]
            assert got["groups"][axis] == line.tolist(), (axis, r)


def test_hybrid_mesh_two_hosts_keeps_model_lines_on_one_host(ranks):
    """Two ranks a host (host = rank // 2): `model` lines stay inside a
    host, `data` lines cross hosts; the layout is JAX's contiguous one at
    8 ranks of one host, and `create_hybrid_device_mesh`'s block order
    (host-major blocks of ici_shape) across hosts."""
    for res in ranks:
        got = res["mesh_layouts"]["hybrid_two_hosts"]
        assert got["shape"] == {"data": 2, "model": 2}
        assert len({r // 2 for r in got["groups"]["model"]}) == 1
        assert len({r // 2 for r in got["groups"]["data"]}) == 2
    j8 = jmesh.create_hybrid_mesh((2, 2), (2, 1), ("data", "model"))
    assert dict(j8.shape) == {"data": 4, "model": 2}
    np.testing.assert_array_equal(
        tmesh.hybrid_layout((2, 2), (2, 1), range(8), 8), _ids(j8))
    np.testing.assert_array_equal(
        tmesh.hybrid_layout((2, 2), (2, 1), range(8), 4),
        [[0, 1], [2, 3], [4, 5], [6, 7]])
    np.testing.assert_array_equal(
        tmesh.hybrid_layout((1, 2), (2, 2), range(8), 2),
        [[0, 1, 2, 3], [4, 5, 6, 7]])


def test_mesh_errors_match_jax(ranks):
    devs = jax.devices()[:WORLD]
    jax_calls = {
        "shape": lambda: jmesh.create_mesh((3,), devices=devs),
        "rank": lambda: jmesh.create_mesh((2, 2), ("data",), devices=devs),
        "hybrid_rank": lambda: jmesh.create_hybrid_mesh(
            (2, 2), (2,), ("data", "model"), devices=devs),
        "hybrid_cover": lambda: jmesh.create_hybrid_mesh(
            (2, 2), (4, 1), ("data", "model"), devices=devs)}
    for name, call in jax_calls.items():
        with pytest.raises(ValueError):
            call()
    for res in ranks:
        errors = res["mesh_layouts"]["errors"]
        assert all(errors[name] for name in jax_calls), errors
        # a host's ici block must cover its ranks (no JAX counterpart
        # without a multi-host runtime)
        assert "one host" in errors["hybrid_host"]


@pytest.mark.parametrize("n,multiple", [(5, 2), (5, 4), (8, 4), (3, 8)])
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    batch = {k: v[:n] for k, v in _batch().items()}
    got, got_mask = tmesh.pad_batch_to_multiple(batch, multiple)
    want, want_mask = jmesh.pad_batch_to_multiple(batch, multiple)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("name", ["default", "dp_tp"])
def test_shard_batch_gives_each_rank_jax_rows(ranks, name):
    jm = _jax_meshes()[name]
    want = jmesh.shard_batch(jm, _batch())
    key = "data" if name == "default" else "dp_tp"
    for r, res in enumerate(ranks):
        got = res["shard_batch_rows"][key]
        for k, arr in want.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device.id == r)
            np.testing.assert_array_equal(got[k], np.asarray(shard.data))
