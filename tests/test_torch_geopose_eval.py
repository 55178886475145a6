"""The port's geopose serving path (`geovpr_torch.cli.evaluate`) against the
JAX package: a small Swin `RegressionModel` with a two-layer MLP head and a
non-identity target scaler, the same weights on both sides.

- `run_evaluate`'s predictions and metrics against the JAX model through
  `make_eval_step`/`summarize_eval` (f32, 1e-4 relative);
- the objective's decode and metric suite against JAX's (1e-5 relative);
- the port's CSV writers against `geovpr.pipeline.export` on the same
  predictions: equal bytes;
- the weight bridge reading a `{"params", "scaler"}` msgpack written by
  `flax.serialization`;
- `main` end to end on a folder of PNGs with `--device cpu`.
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

import geovpr.models.swin as jswin
import geovpr.pipeline.export as jexport
from geovpr.core.config import ModelConfig as JModelConfig
from geovpr.data.pipeline import ArraySource as JArraySource
from geovpr.data.pipeline import iterate_batches as j_iterate_batches
from geovpr.data.transforms import normalize as j_normalize
from geovpr.objectives.scaler import ScalerState as JScalerState
from geovpr.objectives.workloads import GeoposeObjective as JGeoposeObjective
from geovpr.train.model import RegressionModel as JRegressionModel
from geovpr.train.steps import make_eval_step, summarize_eval
import geovpr_torch.cli.presets as tpresets
import geovpr_torch.models.swin as tswin
import geovpr_torch.pipeline.export as texport
from geovpr_torch.cli.evaluate import build_model, main, run_evaluate
from geovpr_torch.core.config import DataConfig, GeoposeConfig, ModelConfig
from geovpr_torch.data.pipeline import ArraySource

VARIANT = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=4,
               image_size=32)
MEAN, SCALE = np.float32([219500.0, 143200.0]), np.float32([310.5, 95.25])
N_IMAGES, BATCH = 7, 3      # a ragged final batch


@pytest.fixture
def tiny_variant(monkeypatch):
    monkeypatch.setitem(jswin.SWIN_VARIANTS, "test-32", VARIANT)
    monkeypatch.setitem(tswin.SWIN_VARIANTS, "test-32", VARIANT)


def _model_cfg(cfg_cls):
    return cfg_cls(family="swin", variant="test-32", head="mlp2",
                   head_hidden=16, head_dropout=0.3, image_size=32)


def _jax_variables(seed=0):
    rng = np.random.default_rng(seed)
    jm = JRegressionModel(config=_model_cfg(JModelConfig))
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 32, 32, 3), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
            np.float32) * 0.05, v["params"])
    return jm, {"params": params,
                "scaler": {"mean": MEAN, "scale": SCALE}}


def _data(seed=1):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (N_IMAGES, 32, 32, 3)).astype(np.uint8)
    latlon = (MEAN + rng.normal(size=(N_IMAGES, 2)) * SCALE).astype(
        np.float32)
    names = [f"img_{(i * 37) % 11:03d}.jpg" for i in range(N_IMAGES)]
    return images, latlon, names


def _jax_eval(jm, variables, images, latlon):
    """`Trainer.evaluate_and_predict` with the JAX eval step."""
    state = types.SimpleNamespace(
        params=variables["params"], apply_fn=jm.apply, batch_stats=None,
        scaler=JScalerState(jnp.asarray(MEAN), jnp.asarray(SCALE)))
    eval_step = make_eval_step(JGeoposeObjective(), normalize_fn=j_normalize)
    step = jax.jit(lambda batch: eval_step(state, batch))
    sums, preds = None, np.zeros((N_IMAGES, 2), np.float32)
    for batch in j_iterate_batches(JArraySource(images, latlon), BATCH):
        idx = batch.pop("_indices")
        s, decoded = step({k: jnp.asarray(v) for k, v in batch.items()})
        sums = s if sums is None else jax.tree_util.tree_map(jnp.add, sums,
                                                             s)
        preds[idx] = np.asarray(decoded)[:len(idx)]
    return summarize_eval(JGeoposeObjective(),
                          {k: float(v) for k, v in sums.items()}), preds


def _port_model(variables, path):
    with open(path, "wb") as f:
        f.write(msgpack_serialize(variables))
    cfg = GeoposeConfig(data=DataConfig(image_size=32),
                        model=dataclasses.replace(
                            _model_cfg(ModelConfig), compute_dtype="float32"))
    return build_model(cfg, "cpu", variables=str(path))


def test_run_evaluate_matches_jax_eval_step(tiny_variant, tmp_path):
    """f32 on both sides; the port's plain path forms the serving softmax,
    JAX's XLA path the max-shifted one: predictions to 1e-4 relative on
    the (lat, lon) scale (the head's outputs times ~300, plus ~2e5), metrics
    to 1e-4 relative."""
    jm, variables = _jax_variables()
    images, latlon, names = _data()
    want_metrics, want = _jax_eval(jm, variables, images, latlon)
    model, scaler = _port_model(variables, tmp_path / "model.msgpack")
    assert torch.equal(scaler.mean, torch.from_numpy(MEAN))
    outputs, got = run_evaluate(
        model, scaler, ArraySource(images, latlon, names), batch_size=BATCH,
        out_dir=str(tmp_path / "out"), device="cpu",
        test_source=ArraySource(images[:4], np.zeros((4, 2), np.float32),
                                names[:4]),
        submission_csv="preds.csv")
    np.testing.assert_allclose(got - MEAN, want - MEAN, rtol=0,
                               atol=1e-4 * float(SCALE.max()))
    assert set(outputs["metrics"]) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(outputs["metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    for key, name in (("validation_csv", "validation_predictions.csv"),
                      ("test_csv", "test_predictions_sorted.csv"),
                      ("submission_csv", "preds.csv")):
        assert outputs[key] == str(tmp_path / "out" / name)
        assert os.path.isfile(outputs[key])


@pytest.mark.parametrize("masked", [False, True])
def test_objective_metrics_match_jax(masked):
    """`GeoposeObjective.decode_predictions` and `metrics` (MSE, RMSE, MAE,
    per-axis MAE, competition loss) against JAX's on the same f32 arrays;
    the masked case drops two rows. 1e-5 relative: f32 sums over 9 rows
    taken in another order."""
    from geovpr_torch.objectives.scaler import scaler_from_arrays
    from geovpr_torch.objectives.workloads import GeoposeObjective
    rng = np.random.default_rng(5)
    preds = rng.normal(size=(9, 2)).astype(np.float32)
    latlon = (MEAN + rng.normal(size=(9, 2)) * SCALE).astype(np.float32)
    mask = np.arange(9) < (7 if masked else 9)
    jobj = JGeoposeObjective()
    jdec = jobj.decode_predictions(
        jnp.asarray(preds), JScalerState(jnp.asarray(MEAN), jnp.asarray(SCALE)))
    want = jobj.metrics(jdec, jnp.asarray(latlon),
                        jnp.asarray(mask) if masked else None)
    tobj = GeoposeObjective()
    tdec = tobj.decode_predictions(torch.from_numpy(preds),
                                   scaler_from_arrays(MEAN, SCALE))
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
    got = tobj.metrics(tdec, torch.from_numpy(latlon),
                       torch.from_numpy(mask) if masked else None)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_csv_bytes_equal_geovpr_export(tmp_path):
    _, latlon, names = _data(seed=2)
    preds = latlon + np.random.default_rng(3).normal(size=latlon.shape
                                                     ).astype(np.float32)
    for writer, args in (
            ("write_geopose_validation_csv", (names, latlon, preds)),
            ("write_geopose_test_csv", (names, preds)),
            ("write_geopose_preds_csv", (names, preds))):
        getattr(jexport, writer)(str(tmp_path / "jax.csv"), *args)
        getattr(texport, writer)(str(tmp_path / "port.csv"), *args)
        assert ((tmp_path / "port.csv").read_bytes()
                == (tmp_path / "jax.csv").read_bytes()), writer


def test_bridge_reads_regression_model_msgpack(tiny_variant, tmp_path):
    """Every parameter of the port's RegressionModel comes from the flax
    file: backbone, the two hidden layers and the output layer of the
    head, and the (in, out) reduction kernel of PatchMerging."""
    _, variables = _jax_variables(seed=4)
    model, _ = _port_model(variables, tmp_path / "m.msgpack")
    p = variables["params"]
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["head.hidden1.weight"].numpy(), p["head"]["hidden1"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["backbone.stage0_downsample.reduction_weight"].numpy(),
        p["backbone"]["stage0_downsample"]["reduction"]["kernel"])
    np.testing.assert_array_equal(
        sd["backbone.stage1_block1.attn.relative_position_bias_table"]
        .numpy(), p["backbone"]["stage1_block1"]["attn"]
        ["relative_position_bias_table"])


def test_non_geopose_presets_are_not_ported():
    """Every angle preset whose family has a w8a8 path in JAX builds its
    w8a8 model (window-7 Swin and ConvNeXt carry the quant buffers of
    their halves); EfficientNet has none in JAX either and is refused."""
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.models.swin import SWIN_VARIANTS
    from geovpr_torch.models.convnext import CONVNEXT_VARIANTS
    small = {"convnext_direct_maae": (CONVNEXT_VARIANTS, "base-224", dict(
                 depths=(1, 1), dims=(32, 64))),
             "swin_t224_sincos_acos": (SWIN_VARIANTS, "tiny-224", dict(
                 embed_dim=32, depths=(2,), num_heads=(1,), window_size=7,
                 image_size=224))}
    for name, (table, variant, spec) in small.items():
        saved = table[variant]
        table[variant] = spec
        try:
            model, _ = build_model(build_preset(name), "cpu", int8=True)
        finally:
            table[variant] = saved
        names = dict(model.named_buffers())
        assert any(k.endswith("mlp.fc1_kernel_q") for k in names), name
        assert ("attn_wqkv_q" in "".join(names)) == (name.startswith("swin"))
    from geovpr_torch.models.registry import build_backbone
    with pytest.raises(ValueError, match="no int8 serving path"):
        build_backbone(ModelConfig(family="efficientnet", variant="b0"),
                       int8=True)


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
            f.write(f"p{i}.png,0,{219000 + 10.0 * i},{143000 - 5.0 * i},0,1\n")


@pytest.mark.parametrize("int8", [False, True])
def test_main_runs_on_cpu(tiny_variant, monkeypatch, tmp_path, capsys, int8):
    """The CLI end to end with a small preset (random init, bf16 on the
    CPU): val and test CSVs, the submission file, the JSON record."""
    monkeypatch.setitem(tpresets.GEOPOSE_PRESETS, "swin_test", GeoposeConfig(
        data=DataConfig(image_size=32, batch_size=2),
        model=_model_cfg(ModelConfig)))
    _write_pngs(tmp_path, 3)
    main(["--preset", "swin_test", "--val-csv", str(tmp_path / "labels.csv"),
          "--image-root", str(tmp_path / "img"), "--test-dir",
          str(tmp_path / "test"), "--out-dir", str(tmp_path / "out"),
          "--submission-csv", "sub.csv", "--device", "cpu"]
         + (["--int8"] if int8 else []))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metrics", "validation_csv", "test_csv",
                        "submission_csv"}
    assert np.isfinite(out["metrics"]["mse"])
    lines = open(out["test_csv"]).read().splitlines()
    assert lines[0] == "filename,predicted_latitude,predicted_longitude"
    assert [ln.split(",")[0] for ln in lines[1:]] == ["t0.png", "t1.png",
                                                      "t2.png"]
    assert len(open(out["validation_csv"]).read().splitlines()) == 4
    assert open(out["submission_csv"]).readline().strip() == \
        "ID,latitude,longitude"
