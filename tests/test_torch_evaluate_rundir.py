"""`geovpr_torch.cli.evaluate --run-dir`: the port scores a run directory
that its own trainer wrote, as `geovpr.cli.evaluate` does with
`--run-dir`/`--checkpoint` (`geovpr/cli/common.py::load_trained`).

A tiny DINOv2 geopose preset (2 layers, D = 64, 28 px, f32) trains one
epoch on the CPU (`run_train`, validation on, so `best/` and
`checkpoint_0/` are written); `main` then scores `best`, `latest` and the
named checkpoint from PNGs of the same pixels. Its metrics equal the
trainer's own evaluation of the final state within rtol 1e-6 (the same f32
forward on the same images), the CSV lands in the run directory (JAX's
default `--out-dir`) with one row per image, and a missing checkpoint or a
bad name exits with JAX's message.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import geovpr_torch.cli.presets as tpresets
from geovpr_torch.cli.evaluate import main
from geovpr_torch.cli.train import run_train
from geovpr_torch.data.pipeline import ArraySource
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS

VARIANT = dict(hidden_size=64, num_layers=2, num_heads=2)
SIZE, N = 28, 6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("rundir")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (N, SIZE, SIZE, 3)).astype(np.uint8)
    latlon = (rng.normal(size=(N, 2)) * [300, 100]
              + [219000, 143000]).astype(np.float32)
    names = [f"p{i}.png" for i in range(N)]
    os.makedirs(tmp / "img")
    with open(tmp / "labels.csv", "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for name, img, (lat, lon) in zip(names, images, latlon):
            Image.fromarray(img).save(tmp / "img" / name)
            f.write(f"{name},0,{float(lat)!r},{float(lon)!r},0,1\n")
    latlon = np.loadtxt(tmp / "labels.csv", delimiter=",", skiprows=1,
                        usecols=(2, 3), dtype=np.float32)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(DINOV2_VARIANTS, "tiny-test", VARIANT)
        cfg = tpresets.GEOPOSE_PRESETS["dinov2_meanpool_huber"]
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, variant="tiny-test",
                                           compute_dtype="float32"),
            data=dataclasses.replace(cfg.data, image_size=SIZE,
                                     batch_size=4),
            train=dataclasses.replace(cfg.train, epochs=1))
        mp.setitem(tpresets.GEOPOSE_PRESETS, "dinov2_test", cfg)
        src = ArraySource(images, latlon, names)
        trainer = run_train(cfg, src, src, save_dir=str(tmp / "runs"),
                            device="cpu")
        metrics, _ = trainer.evaluate_and_predict(src)
        yield dict(tmp=tmp, run_dir=trainer.run_dir, metrics=metrics)
    torch.set_num_threads(n)


def _main(run, *extra):
    tmp = run["tmp"]
    main(["--preset", "dinov2_test", "--val-csv", str(tmp / "labels.csv"),
          "--image-root", str(tmp / "img"), "--device", "cpu", *extra])


@pytest.mark.parametrize("checkpoint", ["best", "latest", "checkpoint_0"])
def test_main_scores_its_own_run_directory(run, capsys, checkpoint):
    run_dir = run["run_dir"]
    assert {"best", "checkpoint_0"} <= set(os.listdir(run_dir))
    _main(run, "--run-dir", run_dir, "--checkpoint", checkpoint)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["validation_csv"] == os.path.join(run_dir,
                                                 "validation_predictions.csv")
    for k, v in run["metrics"].items():
        assert np.isfinite(out["metrics"][k])
        assert out["metrics"][k] == pytest.approx(v, rel=1e-6), k
    rows = open(out["validation_csv"]).read().splitlines()
    assert len(rows) == N + 1
    assert [r.split(",")[0] for r in rows[1:]] == [f"p{i}.png"
                                                   for i in range(N)]


@pytest.mark.parametrize("where, checkpoint", [
    ("run", "checkpoint_7"), ("run", "nope"), ("empty", "best"),
    ("empty", "latest")])
def test_missing_checkpoint_exits(run, tmp_path, where, checkpoint):
    run_dir = run["run_dir"] if where == "run" else str(tmp_path)
    with pytest.raises(SystemExit, match="no checkpoint"):
        _main(run, "--run-dir", run_dir, "--checkpoint", checkpoint,
              "--out-dir", str(tmp_path / "out"))


def test_variables_and_run_dir_exclude_each_other(run, tmp_path):
    with pytest.raises(SystemExit):
        _main(run, "--run-dir", run["run_dir"], "--variables",
              str(tmp_path / "m.msgpack"))
