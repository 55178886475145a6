"""`python -m geovpr_torch.cli.retrieve` against `geovpr.cli.retrieve` on
the same JAX-initialised small-14/28 variables and the same tiny JPEG set.

Both CLIs compute in bf16, with bf16 rounding at different places, so the
scores are held to a bf16 tolerance and the neighbour indices to equality
only where JAX's gap between consecutive scores exceeds it.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.serialization import msgpack_serialize

from geovpr.cli.retrieve import main as jax_main
from geovpr_torch.cli.retrieve import main as torch_main

N_GALLERY, N_QUERY = 10, 3
# cosine scores of unit descriptors from two bf16 models that round at
# different places: measured 2.2e-3 apart at most on this set
SCORE_TOL = 5e-3


def _write_dataset(root):
    from PIL import Image
    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    def make(count, prefix, csv_name):
        with open(os.path.join(root, csv_name), "w") as f:
            f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
            for i in range(count):
                nm = f"{prefix}_{i:03d}.jpg"
                arr = rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)
                Image.fromarray(arr).save(os.path.join(img_dir, nm))
                f.write(f"{nm},0,{219000.0 + i * 10.0},"
                        f"{143000.0 + i * 10.0},90.0,1\n")

    make(N_GALLERY, "g", "gallery.csv")
    make(N_QUERY, "q", "query.csv")
    return img_dir


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from geovpr.models.salad import DinoV2Salad
    root = str(tmp_path_factory.mktemp("retrieve"))
    img_dir = _write_dataset(root)
    model = DinoV2Salad(variant="small-14", image_size=28)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 28, 28, 3)))
    var_path = os.path.join(root, "salad.msgpack")
    with open(var_path, "wb") as f:
        f.write(msgpack_serialize(jax.tree_util.tree_map(np.asarray,
                                                         variables)))
    common = ["--query-csv", os.path.join(root, "query.csv"),
              "--image-root", img_dir, "--variables", var_path,
              "--variant", "small-14", "--image-size", "28",
              "--batch-size", "4"]
    return root, common


def _run(main, argv, capsys, extra=()):
    main(list(argv) + list(extra))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out["matches_csv"], newline="") as f:
        rows = list(csv.DictReader(f))
    return out, rows


def _table(rows):
    t = {}
    for r in rows:
        t.setdefault(r["query_filename"], []).append(
            (r["match_filename"], float(r["score"])))
    return t


def test_port_cli_matches_jax_cli(dataset, capsys):
    root, common = dataset
    gallery = ["--gallery-csv", os.path.join(root, "gallery.csv"),
               "--top-k", str(N_GALLERY)]
    j_out, j_rows = _run(jax_main, common + gallery, capsys,
                         ["--out-dir", os.path.join(root, "jax")])
    t_out, t_rows = _run(torch_main, common + gallery, capsys,
                         ["--out-dir", os.path.join(root, "torch"),
                          "--device", "cpu"])
    assert t_out["gallery_size"] == j_out["gallery_size"] == N_GALLERY
    assert t_out["num_queries"] == j_out["num_queries"] == N_QUERY
    assert len(t_rows) == len(j_rows) == N_GALLERY * N_QUERY
    jt, tt = _table(j_rows), _table(t_rows)
    assert jt.keys() == tt.keys()
    checked = 0
    for q, jr in jt.items():
        tr = tt[q]
        np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr],
                                   rtol=0, atol=SCORE_TOL)
        js = [s for _, s in jr]
        for r in range(len(jr)):
            gaps = [abs(js[r] - js[o]) for o in (r - 1, r + 1)
                    if 0 <= o < len(js)]
            if min(gaps) > 2 * SCORE_TOL:
                assert tr[r][0] == jr[r][0], (q, r)
                checked += 1
    assert checked > 0
    for k in ("recall@1", f"recall@{N_GALLERY}"):
        assert 0.0 <= t_out[k] <= 1.0


def test_port_cli_save_then_load_index(dataset, capsys):
    """--save-index then --load-index (no gallery CSV) writes the same
    matches, with --approx accepted and the search still exact; the saved
    file also loads in the JAX package."""
    root, common = dataset
    idx = os.path.join(root, "port_index.npz")
    a_out, a_rows = _run(torch_main, common, capsys, [
        "--gallery-csv", os.path.join(root, "gallery.csv"),
        "--save-index", idx, "--top-k", "3", "--device", "cpu",
        "--out-dir", os.path.join(root, "a")])
    b_out, b_rows = _run(torch_main, common, capsys, [
        "--load-index", idx, "--top-k", "3", "--device", "cpu",
        "--approx", "0.99", "--out-dir", os.path.join(root, "b")])
    assert a_out["saved_index"] == idx
    assert a_rows == b_rows
    assert a_out["recall@1"] == b_out["recall@1"]
    from geovpr.retrieval.index import load_index
    j_index, meta = load_index(idx)
    assert j_index.size == N_GALLERY and len(meta["filenames"]) == N_GALLERY


@pytest.mark.parametrize("flags", [["--device", "cpu"],
                                   ["--int8", "--device", "cpu"]])
def test_port_cli_refuses_what_it_cannot_do(dataset, flags):
    """Without --gallery-csv or --load-index argparse exits with usage
    (code 2), with or without --int8."""
    root, common = dataset
    with pytest.raises(SystemExit) as e:
        torch_main(common + flags)
    assert e.value.code == 2


def test_port_cli_int8(dataset, capsys):
    """--int8 on the CPU: the JAX variables load into the int8 model (its
    quant buffers filled by calibration on the first gallery batch), every
    query gets its matches, and the saved index is int8 and loads in the
    JAX package with the same rows."""
    root, common = dataset
    idx = os.path.join(root, "port_index_int8.npz")
    out, rows = _run(torch_main, common, capsys, [
        "--gallery-csv", os.path.join(root, "gallery.csv"), "--int8",
        "--save-index", idx, "--top-k", "3", "--device", "cpu",
        "--out-dir", os.path.join(root, "int8")])
    assert out["gallery_size"] == N_GALLERY and len(rows) == 3 * N_QUERY
    assert 0.0 <= out["recall@1"] <= out["recall@3"] <= 1.0
    from geovpr.retrieval.index import load_index as j_load_index
    from geovpr_torch.retrieval.index import load_index
    j_index, _ = j_load_index(idx)
    t_index, _ = load_index(idx)
    assert j_index.quantize and t_index.quantize
    np.testing.assert_array_equal(np.asarray(j_index._db),
                                  t_index._db[:N_GALLERY].numpy())


def test_port_cli_fails_without_a_card(dataset, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, common = dataset
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_main(common + ["--gallery-csv",
                             os.path.join(root, "gallery.csv")])
