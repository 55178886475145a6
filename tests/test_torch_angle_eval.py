"""The port's angle serving path (`geovpr_torch.cli.evaluate` on angle
presets) against the JAX package, with small registered variants of the
presets' backbones (Swin at window 7, EfficientNet-B0 at full width on
small images, a two-stage ConvNeXt) and the same perturbed weights on both
sides through a flax msgpack:

- `run_evaluate`'s decoded angles and metrics against the JAX model and
  objective through `make_eval_step`/`summarize_eval` (f32; angles to 1e-3
  deg on the circle, metrics to 1e-4 relative), its CSVs against
  `geovpr.pipeline.export`'s writers on the same predictions (equal bytes);
- `main` end to end on a folder of PNGs with `--device cpu`, with `--int8`
  on window-7 Swin and ConvNeXt, and what it refuses: `--submission-csv`
  on an angle preset, `--int8` on EfficientNet (no int8 path).
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_serialize

import geovpr.models.convnext as jconvnext
import geovpr.models.swin as jswin
import geovpr.pipeline.export as jexport
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.core.config import ModelConfig as JModelConfig
from geovpr.data.pipeline import ArraySource as JArraySource
from geovpr.data.pipeline import iterate_batches as j_iterate_batches
from geovpr.data.transforms import normalize as j_normalize
from geovpr.train.model import RegressionModel as JRegressionModel
from geovpr.train.steps import make_eval_step, summarize_eval
import geovpr_torch.cli.presets as tpresets
import geovpr_torch.models.convnext as tconvnext
import geovpr_torch.models.swin as tswin
from geovpr_torch.cli.evaluate import build_model, main, run_evaluate
from geovpr_torch.core.config import AngleConfig, DataConfig, ModelConfig
from geovpr_torch.data.pipeline import ArraySource

SWIN7 = dict(embed_dim=64, depths=(2, 2), num_heads=(2, 4), window_size=7,
             image_size=56)
CONVNEXT = dict(depths=(1, 1), dims=(32, 64))
N_IMAGES, BATCH = 5, 2      # a ragged final batch

# preset -> (family, variant, image size) of its small stand-in; the
# presets' own heads, objectives and codec orders
CASES = {
    "swin_t224_sincos_gemini": ("swin", "test-w7", 56),
    "efficientnet_sincos_gemini": ("efficientnet", "b0", 32),
    "convnext_direct_maae": ("convnext", "test", 32),
}


@pytest.fixture
def tiny_variants(monkeypatch):
    for mod in (jswin, tswin):
        monkeypatch.setitem(mod.SWIN_VARIANTS, "test-w7", SWIN7)
    for mod in (jconvnext, tconvnext):
        monkeypatch.setitem(mod.CONVNEXT_VARIANTS, "test", CONVNEXT)
    for name, (family, variant, size) in CASES.items():
        cfg = tpresets.ANGLE_PRESETS[name]
        monkeypatch.setitem(tpresets.ANGLE_PRESETS, name, dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, image_size=size,
                                          batch_size=BATCH),
            model=dataclasses.replace(cfg.model, variant=variant)))


def _jax_model(name):
    cfg = tpresets.ANGLE_PRESETS[name]
    fields = {f.name: getattr(cfg.model, f.name)
              for f in dataclasses.fields(cfg.model)}
    return JRegressionModel(config=JModelConfig(
        **{**fields, "image_size": cfg.data.image_size}))


def _variables(jm, size, seed):
    """Random variables of the shapes flax's init gives, traced with
    `jax.eval_shape` and never compiled (compiling EfficientNet's init
    costs ~10 s a process): kernels N(0, 1/fan_in), norm scales 1 +
    N(0, 0.05^2), other parameters N(0, 0.05^2), running means N(0, 0.1^2)
    and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, size, size, 3), jnp.float32))

    def draw(path, a):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        v = rng.normal(size=a.shape).astype(np.float32)
        if name == "kernel":
            return v / np.float32(np.sqrt(np.prod(a.shape[:-1])))
        return v * 0.1 if name == "mean" else v * 0.05 + (name == "scale")
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _data(size, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (N_IMAGES, size, size, 3)).astype(np.uint8)
    angles = rng.uniform(0, 750, N_IMAGES).astype(np.float32)
    names = [f"img_{(i * 3) % 7:03d}.jpg" for i in range(N_IMAGES)]
    return images, angles, names


def _jax_eval(name, jm, variables, images, angles):
    """`Trainer.evaluate_and_predict` with the JAX eval step."""
    objective = j_objective_for(j_build_preset(name))
    state = types.SimpleNamespace(
        params=variables["params"], apply_fn=jm.apply, scaler=None,
        batch_stats=variables.get("batch_stats"))
    step = jax.jit(lambda batch: make_eval_step(
        objective, normalize_fn=j_normalize,
        has_batch_stats="batch_stats" in variables)(state, batch))
    sums, preds = None, np.zeros(N_IMAGES, np.float32)
    for batch in j_iterate_batches(JArraySource(images, angles), BATCH):
        idx = batch.pop("_indices")
        s, decoded = step({k: jnp.asarray(v) for k, v in batch.items()})
        sums = s if sums is None else {k: sums[k] + s[k] for k in s}
        preds[idx] = np.asarray(decoded)[:len(idx)]
    return summarize_eval(objective, {k: float(v) for k, v in sums.items()}
                          ), preds


@pytest.mark.parametrize("name", list(CASES))
def test_run_evaluate_matches_jax_eval_step(tiny_variants, tmp_path, name):
    size = CASES[name][2]
    jm = _jax_model(name)
    variables = _variables(jm, size, seed=len(name))
    images, angles, names = _data(size, seed=1)
    want_metrics, want = _jax_eval(name, jm, variables, images, angles)

    path = tmp_path / "model.msgpack"
    path.write_bytes(msgpack_serialize(variables))
    cfg = tpresets.ANGLE_PRESETS[name]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="float32"))
    model, scaler = build_model(cfg, "cpu", variables=str(path))
    assert scaler is None
    out_dir = tmp_path / "out"
    outputs, got = run_evaluate(
        model, None, ArraySource(images, angles, names), batch_size=BATCH,
        out_dir=str(out_dir), device="cpu",
        test_source=ArraySource(images[:3], np.zeros(3, np.float32),
                                names[:3]),
        objective=tpresets.objective_for(cfg))
    assert got.shape == (N_IMAGES,) and ((got >= 0) & (got < 360)).all()
    d = np.abs(got - want)
    assert np.minimum(d, 360 - d).max() <= 1e-3
    assert set(outputs["metrics"]) == set(want_metrics) == {"maae", "mse"}
    for k, v in want_metrics.items():
        np.testing.assert_allclose(outputs["metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    assert set(outputs) == {"metrics", "validation_csv", "test_csv"}
    jexport.write_angle_validation_csv(str(tmp_path / "v.csv"), names,
                                       angles, got)
    jexport.write_angle_test_csv(str(tmp_path / "t.csv"), names[:3],
                                 got[:3])
    assert outputs["validation_csv"] == str(out_dir /
                                            "validation_predictions.csv")
    assert outputs["test_csv"] == str(out_dir / "test_pred.csv")
    assert (out_dir / "validation_predictions.csv").read_bytes() == \
        (tmp_path / "v.csv").read_bytes()
    assert (out_dir / "test_pred.csv").read_bytes() == \
        (tmp_path / "t.csv").read_bytes()


def _write_pngs(root, n):
    from PIL import Image
    rng = np.random.default_rng(0)
    os.makedirs(root / "img")
    os.makedirs(root / "test")
    with open(root / "labels.csv", "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i in range(n):
            arr = rng.integers(0, 255, (40, 40, 3)).astype(np.uint8)
            Image.fromarray(arr).save(root / "img" / f"p{i}.png")
            Image.fromarray(arr).save(root / "test" / f"t{i}.png")
            f.write(f"p{i}.png,0,219000,143000,{100.0 * i + 300.0},1\n")


def _argv(root, preset, *extra):
    return ["--preset", preset, "--val-csv", str(root / "labels.csv"),
            "--image-root", str(root / "img"), "--out-dir",
            str(root / "out"), "--device", "cpu", *extra]


@pytest.mark.parametrize("name", list(CASES) + ["dinov2_sincos_gemini"])
def test_main_runs_on_cpu(tiny_variants, monkeypatch, tmp_path, capsys,
                          name):
    """The CLI end to end in bf16 (random init) on PNGs: the JSON record
    with the angle metrics, the val CSV and the sorted test CSV."""
    if name == "dinov2_sincos_gemini":
        from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
        monkeypatch.setitem(DINOV2_VARIANTS, "tiny",
                            dict(hidden_size=64, num_layers=2, num_heads=2))
        cfg = tpresets.ANGLE_PRESETS[name]
        monkeypatch.setitem(tpresets.ANGLE_PRESETS, name, dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, image_size=28),
            model=dataclasses.replace(cfg.model, variant="tiny")))
    _write_pngs(tmp_path, 3)
    main(_argv(tmp_path, name, "--test-dir", str(tmp_path / "test")))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metrics", "validation_csv", "test_csv"}
    assert set(out["metrics"]) == {"maae", "mse"}
    assert 0 <= out["metrics"]["maae"] <= 180
    lines = open(out["test_csv"]).read().splitlines()
    assert lines[0] == "filename,predicted_angle_degrees"
    assert [ln.split(",")[0] for ln in lines[1:]] == ["t0.png", "t1.png",
                                                      "t2.png"]
    val = open(out["validation_csv"]).read().splitlines()
    assert val[0] == "filename,true_angle,predicted_angle,angular_error"
    assert [float(ln.split(",")[1]) for ln in val[1:]] == [300.0, 400.0,
                                                           500.0]


@pytest.mark.parametrize("preset,extra,exc,match", [
    ("swin_t224_sincos_gemini", ["--submission-csv", "s.csv"], SystemExit,
     "geopose export"),
    ("efficientnet_sincos_gemini", ["--int8"], SystemExit,
     "no int8 serving path"),
])
def test_main_refuses(tiny_variants, tmp_path, preset, extra, exc, match):
    _write_pngs(tmp_path, 2)
    with pytest.raises(exc, match=match):
        main(_argv(tmp_path, preset, *extra))
    assert not (tmp_path / "out" / "validation_predictions.csv").exists()


@pytest.mark.parametrize("preset", ["swin_t224_sincos_gemini",
                                    "convnext_direct_maae"])
def test_main_int8_window7_swin_and_convnext(tiny_variants, tmp_path,
                                             capsys, preset):
    """`--int8` on the two angle families whose w8a8 path has no kernel
    of its own besides K3 (window-7 Swin's attention halves are torch ops;
    ConvNeXt's blocks K3 with a separate residual): calibrated on the
    first val batch, then served, finite metrics."""
    _write_pngs(tmp_path, 3)
    main(_argv(tmp_path, preset, "--int8"))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0 <= out["metrics"]["maae"] <= 180
    assert np.isfinite(out["metrics"]["mse"])


def test_main_int8_on_an_angle_preset_with_a_w8a8_path(monkeypatch,
                                                       tmp_path, capsys):
    """`--int8` works where the port has the w8a8 path: a small DINOv2
    stand-in of `dinov2_sincos_gemini` (K2/K3 plain versions here)."""
    from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
    monkeypatch.setitem(DINOV2_VARIANTS, "tiny",
                        dict(hidden_size=64, num_layers=2, num_heads=2))
    name = "dinov2_sincos_gemini"
    cfg = tpresets.ANGLE_PRESETS[name]
    monkeypatch.setitem(tpresets.ANGLE_PRESETS, name, AngleConfig(
        data=DataConfig(image_size=28, batch_size=2),
        model=ModelConfig(**{**dataclasses.asdict(cfg.model),
                             "variant": "tiny"}),
        loss=cfg.loss, codec_order=cfg.codec_order))
    _write_pngs(tmp_path, 3)
    main(_argv(tmp_path, name, "--int8"))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["metrics"]["maae"])
    assert torch.isfinite(torch.tensor(out["metrics"]["mse"]))
