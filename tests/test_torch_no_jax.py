"""The port runs without jax and without the JAX package (`geovpr`), through
`run_retrieval`, the retrieve CLI's `main` with `--int8`, the evaluate
CLI's `main` (geopose bf16 and `--int8`; angle presets), the train CLI
(window-12 and window-7 Swin, DINOv2 across the unfreeze; `--multihost` on
two spawned ranks) and the fuse
CLI's `main` (`--int8`, three components), the convert and parity CLIs'
`main`, and chip_smoke.py fails where it cannot run."""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
_BLOCK = ("jax", "jaxlib", "flax", "optax", "orbax")

_MAIN_PATH = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import tempfile
import numpy as np
import torch
import geovpr_torch, geovpr_torch.cli.retrieve, geovpr_torch.models.salad
from geovpr_torch.cli.retrieve import build_model, run_retrieval
from geovpr_torch.data.pipeline import ArraySource

model = build_model("small-14", 28, "cpu", seed=0)
rng = np.random.default_rng(0)
src = ArraySource(rng.integers(0, 255, (6, 28, 28, 3)).astype(np.uint8),
                  (np.arange(12, dtype=np.float32) * 100).reshape(6, 2),
                  [f"g{{i}}.jpg" for i in range(6)])
with tempfile.TemporaryDirectory() as d:
    out = run_retrieval(model, src, src, batch_size=4, top_k=2,
                        positive_radius=1.0, out_dir=d, device="cpu")
assert out["gallery_size"] == 6, out
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in ("geovpr",) + {block!r})
assert not leaked, leaked
print("OK")
"""


def test_main_path_runs_without_jax_or_geovpr():
    """With jax/flax/optax/orbax blocked, the port imports and drives its
    retrieve main path on the CPU, importing no `geovpr` module either."""
    proc = subprocess.run(
        [sys.executable, "-c", _MAIN_PATH.format(block=_BLOCK)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


_CLI_INT8 = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import json, os, tempfile
import numpy as np
from PIL import Image
from geovpr_torch.cli.retrieve import main
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
DINOV2_VARIANTS["tiny"] = dict(hidden_size=64, num_layers=2, num_heads=4)

with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "img"))
    rng = np.random.default_rng(0)
    with open(os.path.join(d, "labels.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\\n")
        for i in range(5):
            Image.fromarray(rng.integers(0, 255, (20, 20, 3)).astype(
                np.uint8)).save(os.path.join(d, "img", f"p{{i}}.png"))
            f.write(f"p{{i}}.png,0,{{i * 100.0}},0,0,1\\n")
    csv = os.path.join(d, "labels.csv")
    main(["--gallery-csv", csv, "--query-csv", csv, "--image-root",
          os.path.join(d, "img"), "--variant", "tiny", "--image-size",
          "28", "--batch-size", "4", "--top-k", "2", "--int8", "--device",
          "cpu", "--out-dir", os.path.join(d, "out")])
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in {block!r})
assert not leaked, leaked
print("OK")
"""


def test_cli_int8_runs_without_jax_or_geovpr():
    """`main([... "--int8", "--device", "cpu"])` over a folder of PNGs,
    with jax, flax and `geovpr` blocked: manifest, PIL decode, calibration,
    int8 model and int8 index all come from the port."""
    block = _BLOCK + ("geovpr",)
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_INT8.format(block=block)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.strip().splitlines()
    assert out[-1] == "OK"
    assert json.loads(out[-2])["gallery_size"] == 5


_EVALUATE = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import json, os, tempfile
import numpy as np
from PIL import Image
from geovpr_torch.cli import presets
from geovpr_torch.cli.evaluate import main
from geovpr_torch.core.config import DataConfig, GeoposeConfig, ModelConfig
from geovpr_torch.models.swin import SWIN_VARIANTS
SWIN_VARIANTS["test-32"] = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2),
                                window_size=4, image_size=32)
presets.GEOPOSE_PRESETS["swin_test"] = GeoposeConfig(
    data=DataConfig(image_size=32, batch_size=2),
    model=ModelConfig(family="swin", variant="test-32", head="mlp",
                      head_hidden=16))

with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "img"))
    rng = np.random.default_rng(0)
    with open(os.path.join(d, "labels.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\\n")
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (20, 20, 3)).astype(
                np.uint8)).save(os.path.join(d, "img", f"p{{i}}.png"))
            f.write(f"p{{i}}.png,0,{{i * 100.0}},0,0,1\\n")
    for extra in ([], ["--int8"]):
        main(["--preset", "swin_test", "--val-csv",
              os.path.join(d, "labels.csv"), "--image-root",
              os.path.join(d, "img"), "--out-dir", os.path.join(d, "out"),
              "--device", "cpu"] + extra)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in {block!r})
assert not leaked, leaked
print("OK")
"""


def test_evaluate_cli_runs_without_jax_or_geovpr():
    """`geovpr_torch.cli.evaluate.main` on a small Swin preset over a folder
    of PNGs, bf16 and `--int8`, with jax, flax and `geovpr` blocked."""
    block = _BLOCK + ("geovpr",)
    proc = subprocess.run(
        [sys.executable, "-c", _EVALUATE.format(block=block)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.strip().splitlines()
    assert out[-1] == "OK"
    for line in out[-3:-1]:
        assert np.isfinite(json.loads(line)["metrics"]["mse"])


_EVALUATE_ANGLE = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import dataclasses, json, os, tempfile
import numpy as np
from PIL import Image
from geovpr_torch.cli import presets
from geovpr_torch.cli.evaluate import main
from geovpr_torch.models.swin import SWIN_VARIANTS
SWIN_VARIANTS["test-w7"] = dict(embed_dim=64, depths=(2, 2),
                                num_heads=(2, 4), window_size=7,
                                image_size=56)
for name, variant, size in (("swin_t224_sincos_gemini", "test-w7", 56),
                            ("efficientnet_sincos_gemini", "b0", 32)):
    cfg = presets.ANGLE_PRESETS[name]
    presets.ANGLE_PRESETS[name] = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_size=size,
                                      batch_size=2),
        model=dataclasses.replace(cfg.model, variant=variant))

with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "img"))
    rng = np.random.default_rng(0)
    with open(os.path.join(d, "labels.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\\n")
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (60, 60, 3)).astype(
                np.uint8)).save(os.path.join(d, "img", f"p{{i}}.png"))
            f.write(f"p{{i}}.png,0,0,0,{{i * 170.0}},1\\n")
    for name in ("swin_t224_sincos_gemini", "efficientnet_sincos_gemini"):
        main(["--preset", name, "--val-csv", os.path.join(d, "labels.csv"),
              "--image-root", os.path.join(d, "img"), "--out-dir",
              os.path.join(d, "out"), "--test-dir", os.path.join(d, "img"),
              "--device", "cpu"])
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in {block!r})
assert not leaked, leaked
print("OK")
"""


def test_evaluate_cli_angle_runs_without_jax_or_geovpr():
    """`geovpr_torch.cli.evaluate.main` on angle presets (a small window-7
    Swin, so the K7 path, and EfficientNet-B0 on small images) over a
    folder of PNGs, with jax, flax and `geovpr` blocked."""
    block = _BLOCK + ("geovpr",)
    proc = subprocess.run(
        [sys.executable, "-c", _EVALUATE_ANGLE.format(block=block)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.strip().splitlines()
    assert out[-1] == "OK"
    for line in out[-3:-1]:
        rec = json.loads(line)
        assert set(rec["metrics"]) == {"maae", "mse"}
        assert rec["test_csv"].endswith("test_pred.csv")


_TRAIN = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import dataclasses, json, os, tempfile
import numpy as np
import torch
from PIL import Image
from geovpr_torch.cli import presets
from geovpr_torch.cli.train import main
torch.set_num_threads(1)  # a small model, on cores the test workers share
from geovpr_torch.models.swin import SWIN_VARIANTS
SWIN_VARIANTS["test-w4"] = dict(embed_dim=64, depths=(2, 2),
                                num_heads=(2, 4), window_size=4,
                                image_size=32)
cfg = presets.GEOPOSE_PRESETS["swin_b384_gemini2"]
presets.GEOPOSE_PRESETS["swin_b384_gemini2"] = dataclasses.replace(
    cfg, data=dataclasses.replace(cfg.data, image_size=32, batch_size=2),
    model=dataclasses.replace(cfg.model, variant="test-w4"))

with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "img"))
    rng = np.random.default_rng(0)
    with open(os.path.join(d, "labels.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\\n")
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3)).astype(
                np.uint8)).save(os.path.join(d, "img", f"p{{i}}.png"))
            f.write(f"p{{i}}.png,0,{{219000 + i * 50.0}},{{143000 - i}},"
                    "0,1\\n")
    csv = os.path.join(d, "labels.csv")
    main(["--preset", "swin_b384_gemini2", "--train-csv", csv, "--val-csv",
          csv, "--image-root", os.path.join(d, "img"), "--save-dir",
          os.path.join(d, "runs"), "--epochs", "1", "--device", "cpu"])
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in {block!r})
assert not leaked, leaked
print("OK")
"""


def test_train_cli_runs_without_jax_or_geovpr():
    """`geovpr_torch.cli.train.main` for one epoch of a small window-4 Swin
    on the geopose preset (geo_light augmentation, dropout, DropPath) over
    a folder of PNGs, with jax, flax and `geovpr` blocked."""
    block = _BLOCK + ("geovpr",)
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN.format(block=block)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.strip().splitlines()
    assert out[-1] == "OK"
    rec = json.loads(out[-2])
    assert rec["final"]["epoch"] == 0
    assert np.isfinite(rec["final"]["train_loss"])
    assert np.isfinite(rec["final"]["val_mse"])


_TRAIN_DINOV2 = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import dataclasses, json, os, tempfile
import numpy as np
import torch
from PIL import Image
from geovpr_torch.cli import presets
from geovpr_torch.cli.evaluate import main as evaluate
from geovpr_torch.cli.train import main as train
torch.set_num_threads(1)  # a small model, on cores the test workers share
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
DINOV2_VARIANTS["test"] = dict(hidden_size=64, num_layers=2, num_heads=2)
cfg = presets.GEOPOSE_PRESETS["dinov2_meanpool_huber"]
presets.GEOPOSE_PRESETS["dinov2_meanpool_huber"] = dataclasses.replace(
    cfg, data=dataclasses.replace(cfg.data, image_size=28, batch_size=2),
    model=dataclasses.replace(cfg.model, variant="test"))

with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "img"))
    rng = np.random.default_rng(0)
    with open(os.path.join(d, "labels.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\\n")
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3)).astype(
                np.uint8)).save(os.path.join(d, "img", f"p{{i}}.png"))
            f.write(f"p{{i}}.png,0,{{219000 + i * 50.0}},{{143000 - i}},"
                    "0,1\\n")
    csv = os.path.join(d, "labels.csv")
    common = ["--preset", "dinov2_meanpool_huber", "--val-csv", csv,
              "--image-root", os.path.join(d, "img"), "--device", "cpu"]
    train(common + ["--train-csv", csv, "--save-dir",
                    os.path.join(d, "runs"), "--epochs", "1"])
    run_dir = os.path.join(d, "runs", os.listdir(os.path.join(d, "runs"))[0])
    evaluate(common + ["--run-dir", run_dir, "--checkpoint", "latest"])
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in {block!r})
assert not leaked, leaked
print("OK")
"""


def test_dinov2_train_and_evaluate_cli_run_without_jax_or_geovpr():
    """`geovpr_torch.cli.train.main` for one epoch of a small DINOv2 on
    dinov2_meanpool_huber (the K8 training half-blocks' plain route), then
    `geovpr_torch.cli.evaluate.main --run-dir` on the run it wrote, over a
    folder of PNGs, with jax, flax and `geovpr` blocked."""
    block = _BLOCK + ("geovpr",)
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_DINOV2.format(block=block)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.strip().splitlines()
    assert out[-1] == "OK"
    trained, scored = json.loads(out[-3]), json.loads(out[-2])
    assert trained["final"]["epoch"] == 0
    assert np.isfinite(trained["final"]["train_loss"])
    assert scored["validation_csv"].startswith(trained["run_dir"])
    assert np.isfinite(scored["metrics"]["mse"])


_TRAIN_ANGLE = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import dataclasses, json, os, tempfile
import numpy as np
import torch
from PIL import Image
from geovpr_torch.cli import presets
from geovpr_torch.cli.train import main
torch.set_num_threads(1)  # a small model, on cores the test workers share
from geovpr_torch.models.convnext import CONVNEXT_VARIANTS
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
from geovpr_torch.models.swin import SWIN_VARIANTS
DINOV2_VARIANTS["test"] = dict(hidden_size=64, num_layers=2, num_heads=2)
SWIN_VARIANTS["test-w7"] = dict(embed_dim=64, depths=(2, 2),
                                num_heads=(2, 4), window_size=7,
                                image_size=56)
CONVNEXT_VARIANTS["test"] = dict(depths=(1, 1), dims=(32, 64))
preset = {preset!r}
cfg = presets.ANGLE_PRESETS[preset]
size, variant = {{"swin": (56, "test-w7"), "dinov2": (28, "test"),
                  "efficientnet": (32, "b0"),
                  "convnext": (32, "test")}}[cfg.model.family]
presets.ANGLE_PRESETS[preset] = dataclasses.replace(
    cfg, data=dataclasses.replace(cfg.data, image_size=size, batch_size=2,
                                  eval_resize_to=0),
    model=dataclasses.replace(cfg.model, variant=variant),
    optim=dataclasses.replace(cfg.optim, freeze_backbone_epochs=min(
        cfg.optim.freeze_backbone_epochs, 1)))

with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "img"))
    rng = np.random.default_rng(0)
    with open(os.path.join(d, "labels.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\\n")
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (60, 60, 3)).astype(
                np.uint8)).save(os.path.join(d, "img", f"p{{i}}.png"))
            f.write(f"p{{i}}.png,0,0,0,{{i * 100.0}},1\\n")
    csv = os.path.join(d, "labels.csv")
    main(["--preset", preset, "--train-csv", csv, "--val-csv", csv,
          "--image-root", os.path.join(d, "img"), "--save-dir",
          os.path.join(d, "runs"), "--epochs", "2", "--device", "cpu"])
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in {block!r})
assert not leaked, leaked
print("OK")
"""


@pytest.mark.parametrize("preset", ["dinov2_sincos_gemini",
                                    "swin_t224_sincos_gemini",
                                    "efficientnet_sincos_gemini",
                                    "convnext_direct_maae"])
def test_angle_train_cli_runs_without_jax_or_geovpr(preset):
    """`geovpr_torch.cli.train.main` for two epochs of a small model on the
    preset, with jax, flax and `geovpr` blocked: DINOv2 with `angle_rot`
    across the unfreeze (one frozen epoch), window-7 Swin with `geo_light`,
    DropPath and warm restarts, EfficientNet-B0 at 32 px with BatchNorm in
    training mode, stochastic depth and `geo_light`, a small ConvNeXt."""
    block = _BLOCK + ("geovpr",)
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_ANGLE.format(block=block,
                                                   preset=preset)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.strip().splitlines()
    assert out[-1] == "OK"
    rec = json.loads(out[-2])
    assert rec["final"]["epoch"] == 1
    assert np.isfinite(rec["final"]["train_loss"])
    assert np.isfinite(rec["final"]["val_maae"])


_FUSE = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import dataclasses, json, os, tempfile
import numpy as np
import torch
from PIL import Image
from geovpr_torch.cli import presets
from geovpr_torch.cli.evaluate import build_model
from geovpr_torch.cli.fuse import main as fuse
from geovpr_torch.train.checkpoint import save_checkpoint
from geovpr_torch.train.state import TrainState, build_optimizer
torch.set_num_threads(1)  # small models, on cores the test workers share
from geovpr_torch.models.convnext import CONVNEXT_VARIANTS
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
from geovpr_torch.models.swin import SWIN_VARIANTS
SWIN_VARIANTS["test"] = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2),
                             window_size=4, image_size=32)
CONVNEXT_VARIANTS["test"] = dict(depths=(1, 1), dims=(32, 64))
DINOV2_VARIANTS["test"] = dict(hidden_size=64, num_layers=2, num_heads=2)
for table, name, variant, size, resize_to in (
        (presets.GEOPOSE_PRESETS, "swin_b384_gemini2", "test", 32, 0),
        (presets.ANGLE_PRESETS, "convnext_direct_maae", "test", 24, 28)):
    cfg = table[name]
    table[name] = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_size=size,
                                      batch_size=2, eval_resize_to=resize_to),
        model=dataclasses.replace(cfg.model, variant=variant))

with tempfile.TemporaryDirectory() as d:
    runs = {{}}
    for name in ("swin_b384_gemini2", "convnext_direct_maae"):
        cfg = presets.build_preset(name)
        model, scaler = build_model(cfg, "cpu", seed=0)
        if scaler is None:
            from geovpr_torch.objectives.scaler import identity_scaler
            scaler = identity_scaler(2)
        runs[name] = os.path.join(d, name)
        save_checkpoint(os.path.join(runs[name], "best"), TrainState(
            0, model, build_optimizer(model, cfg.optim), scaler, 0), 1)
    os.makedirs(os.path.join(d, "img"))
    os.makedirs(os.path.join(d, "test"))
    rng = np.random.default_rng(0)
    with open(os.path.join(d, "gallery.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\\n")
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (30, 40, 3)).astype(
                np.uint8)).save(os.path.join(d, "img", f"g{{i}}.png"))
            Image.fromarray(rng.integers(0, 255, (40, 30, 3)).astype(
                np.uint8)).save(os.path.join(d, "test", f"t{{i}}.png"))
            f.write(f"g{{i}}.png,0,{{219000 + i * 50.0}},143000,0,1\\n")
    fuse(["--test-dir", os.path.join(d, "test"), "--device", "cpu",
          "--geopose-preset", "swin_b384_gemini2",
          "--geopose-run", runs["swin_b384_gemini2"],
          "--angle-preset", "convnext_direct_maae",
          "--angle-run", runs["convnext_direct_maae"],
          "--gallery-csv", os.path.join(d, "gallery.csv"),
          "--image-root", os.path.join(d, "img"), "--salad-variant", "test",
          "--salad-image-size", "28", "--top-k", "2", "--int8",
          "--out-dir", os.path.join(d, "out")])
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in {block!r})
assert not leaked, leaked
print("OK")
"""


def test_fuse_cli_runs_without_jax_or_geovpr():
    """`geovpr_torch.cli.fuse.main --int8` with all three components (a
    small window-4 Swin geopose head, a small ConvNeXt angle head on its
    dual geometry, a small DINOv2 + SALAD with a gallery) on run
    directories the port's `save_checkpoint` wrote, over folders of PNGs,
    with jax, flax, optax, orbax and `geovpr` blocked."""
    block = _BLOCK + ("geovpr",)
    proc = subprocess.run(
        [sys.executable, "-c", _FUSE.format(block=block)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.strip().splitlines()
    assert out[-1] == "OK"
    rec = json.loads(out[-2])
    assert rec["num_images"] == 4 and rec["stream_size"] == 32
    assert {"geopose_csv", "angle_csv", "retrieval_csv"} <= set(rec)


def test_multihost_train_cli_runs_without_jax_or_geovpr(tmp_path):
    """`geovpr_torch.cli.train.main --multihost` on two spawned ranks over
    gloo (`--device cpu`, a `file://` rendezvous), one epoch of a small
    DINOv2 on a folder of PNGs, with jax, flax and `geovpr` blocked in
    both ranks: they exit 0, rank 0 prints the run's record and neither
    imported a blocked module."""
    from geovpr_torch.cli import presets
    from torch_parallel_ranks import run_ranks

    cfg = presets.GEOPOSE_PRESETS["dinov2_meanpool_huber"]
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, variant="test"),
        data=dataclasses.replace(cfg.data, image_size=28, batch_size=2))
    os.makedirs(tmp_path / "img")
    rng = np.random.default_rng(0)
    with open(tmp_path / "labels.csv", "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3)).astype(
                np.uint8)).save(tmp_path / "img" / f"p{i}.png")
            f.write(f"p{i}.png,0,{219000 + i * 50.0},{143000 - i},0,1\n")
    csv = str(tmp_path / "labels.csv")
    ranks = run_ranks([("cli_train", dict(
        world=2, presets={"dinov2_meanpool_huber": cfg},
        variants={"dinov2": {"test": dict(hidden_size=64, num_layers=2,
                                          num_heads=2)}},
        argv=["--preset", "dinov2_meanpool_huber", "--train-csv", csv,
              "--val-csv", csv, "--image-root", str(tmp_path / "img"),
              "--save-dir", str(tmp_path / "runs"), "--epochs", "1",
              "--device", "cpu"]))], 2, tmp_path / "job", init=False,
        block=True)
    assert [r["leaked"] for r in ranks] == [[], []]
    rec = json.loads(ranks[0]["cli_train"].strip().splitlines()[-1])
    assert rec["final"]["epoch"] == 0
    assert np.isfinite(rec["final"]["train_loss"])
    assert ranks[1]["cli_train"].strip() == ""


_CONVERT_PARITY = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import dataclasses, json, os, tempfile
import numpy as np
import torch
from PIL import Image
import chip_smoke as cs
from geovpr_torch.cli import convert, parity, presets
from geovpr_torch.cli.train import load_pretrained_backbone
from geovpr_torch.models.swin import SWIN_VARIANTS
SWIN_VARIANTS["test-32"] = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2),
                                window_size=4, image_size=32)
cfg = presets.GEOPOSE_PRESETS["swin_b384_gemini2"]
presets.GEOPOSE_PRESETS["swin_b384_gemini2"] = dataclasses.replace(
    cfg, model=dataclasses.replace(cfg.model, variant="test-32"),
    data=dataclasses.replace(cfg.data, image_size=32, batch_size=4))

model = cs.cp_model("swin_geopose")
ckpt = cs.export_reference("swin_geopose", model.state_dict())
with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "swin_geopose"))
    os.makedirs(os.path.join(d, "images"))
    torch.save({{"model_state_dict": ckpt}},
               os.path.join(d, "swin_geopose", "model_best.pth"))
    src = os.path.join(d, "backbone.pth")
    torch.save({{k[len("backbone."):]: v for k, v in ckpt.items()
                if k.startswith("backbone.")}}, src)
    dst = os.path.join(d, "backbone.msgpack")
    convert.main([src, dst, "--family", "swin", "--variant", "test-32"])
    got = load_pretrained_backbone(dst)
    want = {{f"backbone.{{k}}": v for k, v in
            model.backbone.state_dict().items()}}
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    rng = np.random.default_rng(0)
    np.savez(os.path.join(d, "swin_geopose", "latlon_scaler.npz"),
             mean=np.float32([219000.0, 143000.0]),
             scale=np.float32([300.0, 100.0]))
    with open(os.path.join(d, "labels_val.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\\n")
        for i in range(6):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3)).astype(
                np.uint8)).save(os.path.join(d, "images", f"p{{i}}.png"))
            f.write(f"p{{i}}.png,0,{{219000 + i * 50.0}},{{143000 - i}},"
                    "0,1\\n")
    with open(os.path.join(d, "parity_config.json"), "w") as f:
        json.dump({{"legs": {{"swin_geopose": {{
            "scaler": "latlon_scaler.npz", "golden": {{"mse": 1e12}},
            "convert_overrides": {{"depths": [2, 2]}}}}}}}}, f)
    parity.main(["--assets", d, "--device", "cpu"])
    with open(os.path.join(d, "parity_report.json")) as f:
        legs = json.load(f)["legs"]
    assert legs["swin_geopose"]["status"] == "pass", legs
    assert legs["swin_geopose"]["n_images"] == 6
    assert [legs[k]["status"] for k in ("efficientnet_sincos",
            "dinov2salad_geopose", "salad")] == ["skipped"] * 3, legs
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in {block!r})
assert not leaked, leaked
print("OK")
"""


def test_convert_and_parity_cli_run_without_jax_or_geovpr():
    """`geovpr_torch.cli.convert.main` on a Swin backbone in HF keys and
    `cli.parity.main --device cpu` on its trained-checkpoint layout (a
    small window-4 Swin and its MLP head, exported by chip_smoke.py's
    exporter), with jax, flax, optax, orbax and `geovpr` blocked: the
    msgpack reads back bit-equal through `--pretrained`'s loader and the
    leg passes."""
    block = _BLOCK + ("geovpr",)
    proc = subprocess.run(
        [sys.executable, "-c", _CONVERT_PARITY.format(block=block)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK"


_TRAIN_ASYNC_CACHED_NATIVE = """
import sys
for name in {block!r}:
    sys.modules[name] = None
import dataclasses, json, os, tempfile
import numpy as np
import torch
from PIL import Image
from geovpr_torch.cli import presets
from geovpr_torch.cli.train import main as train
torch.set_num_threads(1)  # a small model, on cores the test workers share
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
DINOV2_VARIANTS["test"] = dict(hidden_size=64, num_layers=2, num_heads=2)
with tempfile.TemporaryDirectory() as d:
    cfg = presets.GEOPOSE_PRESETS["dinov2_meanpool_huber"]
    presets.GEOPOSE_PRESETS["dinov2_meanpool_huber"] = dataclasses.replace(
        cfg, data=dataclasses.replace(
            cfg.data, image_size=28, batch_size=2, decoder="native",
            cache_decoded=os.path.join(d, "cache")),
        model=dataclasses.replace(cfg.model, variant="test", remat=True))
    os.makedirs(os.path.join(d, "img"))
    rng = np.random.default_rng(0)
    with open(os.path.join(d, "labels.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\\n")
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (40, 48, 3)).astype(
                np.uint8)).save(os.path.join(d, "img", f"p{{i}}.jpg"))
            f.write(f"p{{i}}.jpg,0,{{219000 + i * 50.0}},{{143000 - i}},"
                    "0,1\\n")
    csv = os.path.join(d, "labels.csv")
    train(["--preset", "dinov2_meanpool_huber", "--train-csv", csv,
           "--val-csv", csv, "--image-root", os.path.join(d, "img"),
           "--device", "cpu", "--save-dir", os.path.join(d, "runs"),
           "--epochs", "2", "--async-checkpoint"])
    run = os.path.join(d, "runs", os.listdir(os.path.join(d, "runs"))[0])
    assert {{"best", "checkpoint_0", "checkpoint_1"}} <= set(os.listdir(run))
    assert {{"cache.train.npy", "cache.val.npy"}} <= set(os.listdir(d))
    assert np.load(os.path.join(d, "cache.train.npy")).any()
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and m.split(".")[0] in {block!r})
assert not leaked, leaked
print("OK")
"""


def test_async_cached_native_train_cli_runs_without_jax_or_geovpr():
    """`geovpr_torch.cli.train.main --async-checkpoint` for two epochs of a
    tiny DINOv2 (remat on) over a folder of JPEGs decoded by the native
    decoder through `.npy` memmap caches, with jax, flax and `geovpr`
    blocked."""
    block = _BLOCK + ("geovpr",)
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_ASYNC_CACHED_NATIVE.format(
            block=block)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.strip().splitlines()
    assert out[-1] == "OK"
    rec = json.loads(out[-2])
    assert rec["final"]["epoch"] == 1
    assert np.isfinite(rec["final"]["train_loss"])


def _import_lines(pattern: str) -> list[str]:
    pat = re.compile(pattern)
    files = sorted((REPO / "geovpr_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "chip_faults.py",
        REPO / "chip_grads.py", REPO / "chip_turns.py"]
    # the multi-process package is in the scan
    assert {"mesh.py", "sharding_rules.py", "__init__.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    # and the weight import and parity modules
    assert {"convert_torch.py", "convert_reference.py",
            "convert_jax.py"} <= {f.name for f in files
                                  if f.parent.name == "models"}
    assert {"convert.py", "parity.py"} <= {f.name for f in files
                                          if f.parent.name == "cli"}
    # and the native decoder with its C++ build helper
    assert "decoder.py" in {f.name for f in files if f.parent.name == "data"}
    return [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]


_GEOVPR_IMPORT = r"^\s*(import|from) geovpr(\.|\s|$)"


def test_no_jax_import_lines():
    assert not _import_lines(r"^\s*(import|from) (jax|flax|optax|orbax)\b")


def test_no_geovpr_import_lines():
    """Nothing of the JAX package is imported either, not even a module
    of it that does not import jax."""
    pat = re.compile(_GEOVPR_IMPORT)
    assert pat.match("    from geovpr.data.manifest import load_manifest")
    assert pat.match("import geovpr")
    assert not pat.match("from geovpr_torch.data import manifest")
    assert not _import_lines(_GEOVPR_IMPORT)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Here (no CUDA) chip_smoke.py exits non-zero and prints no result,
    both in the repo and copied alone into an empty directory."""
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout
