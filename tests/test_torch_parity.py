"""The port's real-weights parity harness (`geovpr_torch.cli.parity`) on the
synthetic stand-ins of `tests/test_parity_harness.py`: torch models in the
exact reference checkpoint layouts, whose own predictions define the golden
metrics in parity_config.json, through `parity.main([... "--device",
"cpu"])`.

On the Swin and EfficientNet legs the same assets directory also goes
through `geovpr.cli.parity.main`, at f32 compute (a `model_overrides`
entry) so that the two packages' sums differ by roundoff only: each metric
within 1e-4 relative, the same verdicts, the CSVs within 1e-3 row for
row (degrees, or metres at latitudes near 219,000).
"""

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

from geovpr.cli import parity as jax_parity
from geovpr.models.dinov2 import DINOV2_VARIANTS as JAX_DINOV2
from geovpr.models.swin import SWIN_VARIANTS as JAX_SWIN
from geovpr_torch.cli import parity
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
from geovpr_torch.models.swin import SWIN_VARIANTS

from test_efficientnet import build_torchvision_style_b0
from test_parity_harness import _norm_torch, _write_assets

METRIC_RTOL = 1e-4
CSV_ATOL = 1e-3


def _run(assets, legs, *extra):
    parity.main(["--assets", str(assets), "--legs", legs, "--device", "cpu",
                 *extra])
    with open(os.path.join(str(assets), "parity_report.json")) as f:
        return json.load(f)


def _config(root, name, leg):
    (root / "parity_config.json").write_text(json.dumps({"legs": {name: leg}}))


def _efficientnet_assets(root, n, size=224):
    """en_finetuning_gemini.py's checkpoint at production width (the full
    b0 through the torchvision-layout replica); returns the torch MAAE."""
    imgs, _, ang = _write_assets(str(root), n=n, size=size)
    feats = build_torchvision_style_b0()
    torch.manual_seed(1)
    classifier = torch.nn.Sequential(
        torch.nn.Dropout(0.3), torch.nn.Linear(1280, 2)).eval()
    sd = {f"backbone.{k}": v for k, v in feats.state_dict().items()}
    sd.update({f"backbone.classifier.{k}": v
               for k, v in classifier.state_dict().items()})
    (root / "efficientnet_sincos").mkdir()
    torch.save(sd, root / "efficientnet_sincos" / "model_best.pth")
    with torch.no_grad():
        cs = classifier(feats(_norm_torch(imgs)).mean((2, 3))).numpy()
    pred = (np.degrees(np.arctan2(cs[:, 1], cs[:, 0])) + 360.0) % 360.0
    d = np.abs(pred - ang) % 360.0
    return float(np.minimum(d, 360.0 - d).mean())


def _swin_assets(root, monkeypatch):
    """swin_attempt_2.py's SwinRegressionModel layout (HF SwinModel +
    regressor.{0,3}) at a tiny config, in the reference's wrapper, with an
    .npz scaler; returns the torch MSE."""
    from transformers import SwinConfig, SwinModel

    spec = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), window_size=7,
                image_size=56)
    monkeypatch.setitem(SWIN_VARIANTS, "test-56", spec)
    monkeypatch.setitem(JAX_SWIN, "test-56", spec)
    imgs, latlon, _ = _write_assets(str(root), n=6, size=56)
    torch.manual_seed(2)
    hf = SwinModel(SwinConfig(image_size=56, patch_size=4, embed_dim=32,
                              depths=[2, 2], num_heads=[2, 4], window_size=7,
                              drop_path_rate=0.0),
                   add_pooling_layer=True).eval()
    regressor = torch.nn.Sequential(
        torch.nn.Linear(hf.config.hidden_size, 512), torch.nn.ReLU(),
        torch.nn.Dropout(0.3), torch.nn.Linear(512, 2)).eval()
    sd = {f"backbone.{k}": v for k, v in hf.state_dict().items()}
    sd.update({f"regressor.{k}": v for k, v in regressor.state_dict().items()})
    (root / "swin_geopose").mkdir()
    torch.save({"model_state_dict": sd},
               root / "swin_geopose" / "model_best.pth")
    mean, scale = latlon.mean(0), latlon.std(0)
    np.savez(root / "swin_geopose" / "latlon_scaler.npz", mean=mean,
             scale=scale)
    with torch.no_grad():
        pred = regressor(hf(_norm_torch(imgs)).pooler_output).numpy()
    pred = pred * scale + mean
    return float(((pred - latlon) ** 2).sum() / (2 * len(imgs)))


_EN_DATA = {"eval_resize_to": None, "batch_size": 4, "augment": "none"}
_SWIN_LEG = {"scaler": "latlon_scaler.npz",
             "model_overrides": {"variant": "test-56"},
             "data_overrides": {"image_size": 56, "batch_size": 4,
                                "augment": "none"},
             "convert_overrides": {"depths": [2, 2]}}


def test_efficientnet_leg_passes(tmp_path):
    maae = _efficientnet_assets(tmp_path, 6)
    _config(tmp_path, "efficientnet_sincos",
            {"golden": {"maae": maae}, "data_overrides": _EN_DATA})
    leg = _run(tmp_path, "efficientnet_sincos")["legs"]["efficientnet_sincos"]
    assert leg["status"] == "pass", leg
    assert abs(leg["metrics"]["maae"] - maae) < 0.05 * max(maae, 1.0)
    with open(leg["validation_csv"]) as f:
        assert len(list(csv.DictReader(f))) == 6


def test_swin_leg_passes(tmp_path, monkeypatch):
    mse = _swin_assets(tmp_path, monkeypatch)
    _config(tmp_path, "swin_geopose",
            dict(_SWIN_LEG, golden={"mse": mse, "rmse": mse ** 0.5}))
    leg = _run(tmp_path, "swin_geopose")["legs"]["swin_geopose"]
    assert leg["status"] == "pass", leg
    assert abs(leg["metrics"]["mse"] - mse) < 0.01 * mse


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("name", ["swin_geopose", "efficientnet_sincos"])
def test_leg_agrees_with_jax(name, tmp_path, monkeypatch):
    """The same assets through both packages' `parity.main` at f32: the
    metrics, verdicts and CSVs agree."""
    if name == "swin_geopose":
        mse = _swin_assets(tmp_path, monkeypatch)
        leg = dict(_SWIN_LEG, golden={"mse": mse, "rmse": mse ** 0.5})
        leg["model_overrides"] = dict(leg["model_overrides"],
                                      compute_dtype="float32")
    else:
        # 64 px images: the width is production's, the JAX compile small
        leg = {"golden": {"maae": _efficientnet_assets(tmp_path, 6, 64)},
               "data_overrides": dict(_EN_DATA, image_size=64),
               "model_overrides": {"compute_dtype": "float32"}}
    _config(tmp_path, name, leg)
    port_report = _run(tmp_path, name)["legs"][name]
    port_csv = _rows(port_report["validation_csv"])
    jax_parity.main(["--assets", str(tmp_path), "--legs", name,
                     "--out", str(tmp_path / "jax_report.json")])
    with open(tmp_path / "jax_report.json") as f:
        jax_report = json.load(f)["legs"][name]
    assert port_report["status"] == jax_report["status"] == "pass"
    assert port_report["metrics"].keys() == jax_report["metrics"].keys()
    for k, want in jax_report["metrics"].items():
        got = port_report["metrics"][k]
        assert abs(got - want) <= METRIC_RTOL * max(abs(want), 1e-12), k
    assert {k: v["pass"] for k, v in port_report["verdicts"].items()} == \
        {k: v["pass"] for k, v in jax_report["verdicts"].items()}
    jax_csv = _rows(jax_report["validation_csv"])
    assert len(port_csv) == len(jax_csv) == 6
    assert list(port_csv[0]) == list(jax_csv[0])
    for a, b in zip(port_csv, jax_csv):
        assert a["filename"] == b["filename"]
        for col in a:
            if col != "filename":
                assert abs(float(a[col]) - float(b[col])) <= CSV_ATOL, (
                    col, a, b)


def test_threshold_violation_fails_and_exits_nonzero(tmp_path):
    _efficientnet_assets(tmp_path, 4)
    _config(tmp_path, "efficientnet_sincos",
            {"golden": {"maae": 1e-4}, "data_overrides": _EN_DATA})
    with pytest.raises(SystemExit) as ex:
        _run(tmp_path, "efficientnet_sincos")
    assert ex.value.code == 1
    with open(tmp_path / "parity_report.json") as f:
        leg = json.load(f)["legs"]["efficientnet_sincos"]
    assert leg["status"] == "fail"
    assert leg["verdicts"]["maae"]["pass"] is False


class TestDinov2SaladLegs:
    """dinov2salad_finetuning.py's DINOv2RegressionModel layout
    (feature_extractor.* hub model + regressor.{0,2}) and the descriptor
    leg, against the hub replica at SALAD's production head on a 2-layer
    backbone (126 px: 81 tokens, more than the 64 clusters, as in
    production)."""

    @pytest.fixture(autouse=True)
    def _variant(self, monkeypatch):
        spec = dict(hidden_size=64, num_layers=2, num_heads=4)
        monkeypatch.setitem(DINOV2_VARIANTS, "test-14", spec)
        monkeypatch.setitem(JAX_DINOV2, "test-14", spec)

    def _hub(self):
        from test_parity_harness import TestDinov2SaladLegs as JaxLegs
        return JaxLegs()._hub_replica()

    def test_geopose_leg_passes(self, tmp_path):
        imgs, latlon, _ = _write_assets(str(tmp_path), n=4, size=126)
        hub = self._hub()
        torch.manual_seed(3)
        regressor = torch.nn.Sequential(
            torch.nn.Linear(8448, 512), torch.nn.ReLU(),
            torch.nn.Linear(512, 2)).eval()
        sd = {f"feature_extractor.{k}": v for k, v in hub.state_dict().items()}
        sd.update({f"regressor.{k}": v
                   for k, v in regressor.state_dict().items()})
        (tmp_path / "dinov2salad_geopose").mkdir()
        torch.save(sd, tmp_path / "dinov2salad_geopose" / "model_best.pth")
        mean, scale = latlon.mean(0), latlon.std(0)
        np.savez(tmp_path / "dinov2salad_geopose" / "latlon_scaler.npz",
                 mean=mean, scale=scale)
        with torch.no_grad():
            pred = regressor(hub(_norm_torch(imgs))).numpy() * scale + mean
        mse = float(((pred - latlon) ** 2).sum() / (2 * len(imgs)))
        _config(tmp_path, "dinov2salad_geopose", {
            "scaler": "latlon_scaler.npz",
            "golden": {"competition_loss": mse},
            "model_overrides": {"variant": "test-14"},
            "data_overrides": {"image_size": 126, "batch_size": 4,
                               "augment": "none"},
            "convert_overrides": {"depths": 2, "image_size": 126}})
        leg = _run(tmp_path, "dinov2salad_geopose")["legs"][
            "dinov2salad_geopose"]
        assert leg["status"] == "pass", leg
        assert abs(leg["metrics"]["competition_loss"] - mse) < 0.01 * mse

    def test_descriptor_leg_passes(self, tmp_path):
        os.makedirs(tmp_path / "salad")
        hub = self._hub()
        torch.save(hub.state_dict(), tmp_path / "salad" / "dino_salad.ckpt")
        rng = np.random.default_rng(4)
        imgs = rng.integers(0, 256, (4, 126, 126, 3), dtype=np.uint8)
        with torch.no_grad():
            want = hub(_norm_torch(imgs)).numpy()
        np.savez(tmp_path / "salad" / "reference_descriptors.npz",
                 images=imgs, descriptors=want)
        _config(tmp_path, "salad", {"model_overrides": {
            "variant": "test-14", "num_clusters": 64, "cluster_dim": 128,
            "token_dim": 256}})
        leg = _run(tmp_path, "salad")["legs"]["salad"]
        assert leg["status"] == "pass", leg
        assert leg["metrics"]["descriptor_cosine_min"] > 0.999
        assert leg["n_images"] == 4

    def test_descriptor_leg_without_its_dump_is_skipped(self, tmp_path):
        os.makedirs(tmp_path / "salad")
        torch.save(self._hub().state_dict(),
                   tmp_path / "salad" / "dino_salad.ckpt")
        leg = _run(tmp_path, "salad")["legs"]["salad"]
        assert leg["status"] == "skipped"
        assert "docs/PARITY.md" in leg["why"]


def test_missing_assets_skip_cleanly(tmp_path):
    _write_assets(str(tmp_path), n=2, size=56)
    report = _run(tmp_path, "")
    assert set(report["legs"]) == set(parity.DEFAULT_LEGS)
    assert all(leg["status"] == "skipped"
               for leg in report["legs"].values()), report


def test_default_legs_are_jax_goldens():
    assert parity.DEFAULT_LEGS == jax_parity.DEFAULT_LEGS


def test_cuda_without_a_card_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        parity.main(["--assets", str(tmp_path)])


def test_npz_scaler(tmp_path):
    p = str(tmp_path / "s.npz")
    np.savez(p, mean=np.array([219000.0, 143000.0]),
             scale=np.array([300.5, 95.25]))
    st = parity._load_scaler(p)
    assert st.mean.dtype == torch.float32
    np.testing.assert_array_equal(st.mean.numpy(), [219000.0, 143000.0])
    np.testing.assert_array_equal(st.scale.numpy(), [300.5, 95.25])


def test_sklearn_scaler_pickle_loads(tmp_path):
    """The real assets carry joblib-pickled sklearn StandardScalers
    (swin_attempt_2.py:139): the port reads them as JAX does."""
    joblib = pytest.importorskip("joblib")
    sklearn_pre = pytest.importorskip("sklearn.preprocessing")
    x = np.array([[219000.0, 143000.0], [220000.0, 145000.0],
                  [221000.0, 144000.0]])
    sk = sklearn_pre.StandardScaler().fit(x)
    p = str(tmp_path / "latlon_scaler.pkl")
    joblib.dump(sk, p)
    st = parity._load_scaler(p)
    want = jax_parity._load_scaler(p)
    np.testing.assert_array_equal(st.mean.numpy(), np.asarray(want.mean))
    np.testing.assert_array_equal(st.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_allclose(st.mean.numpy(), sk.mean_, rtol=1e-6)


def test_pickled_scaler_without_joblib_names_the_npz(tmp_path, monkeypatch):
    """The card's machine has neither joblib nor sklearn: the exit says
    how to give the scaler instead."""
    p = tmp_path / "latlon_scaler.pkl"
    p.write_bytes(b"not read")
    monkeypatch.setitem(sys.modules, "joblib", None)
    with pytest.raises(SystemExit, match=r"\.npz"):
        parity._load_scaler(str(p))
