"""The port's fused pipeline and `fuse` CLI (`geovpr_torch.pipeline.fused`,
`geovpr_torch.cli.fuse`) against the JAX package on the CPU:

- `resize_matrix` against `FusedPipeline._resize_matrix` (atol 2e-5) and
  `resize_for_head` (plain, crop folded, upscale) against
  `jax.image.resize` (rtol = atol = 1e-5, as tests/test_pipeline_cli.py);
- `DualGeometrySource` and `ImageFolderSource` batches equal to JAX's on
  non-square JPEG and PNG files written with PIL, a broken file included;
- `FusedPipeline` on small registered variants (a window-4 Swin geopose
  head, a window-7 Swin, an EfficientNet-B0 and a ConvNeXt angle head, a
  two-layer DINOv2 + SALAD with an index) against JAX's `FusedPipeline`
  on the same weights, f32, for each subset of the components and the
  dual geometry: geopose within 1e-4 of the scaler's scale, angles 1e-3
  degrees on the circle, retrieval scores within `SCORE_TOL` and indices
  equal where the scores are more than 2 `SCORE_TOL` apart, the CSVs
  byte-equal to `geovpr.pipeline.export`'s writers on the same arrays;
- `cli.fuse.main --device cpu` on run directories written by the port's
  `save_checkpoint`: the three CSVs, `--save-index` then `--load-index`,
  `--approx`, `--int8` and what it refuses.
"""

import csv
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.convnext as jconvnext
import geovpr.models.salad as jsalad
import geovpr.models.swin as jswin
import geovpr.pipeline.export as jexport
from geovpr.core.config import ModelConfig as JModelConfig
from geovpr.data.pipeline import DualGeometrySource as JDualGeometrySource
from geovpr.data.pipeline import ImageFolderSource as JImageFolderSource
from geovpr.models.salad import DinoV2Salad as JDinoV2Salad
from geovpr.objectives.angle_codec import SinCosCodec as JSinCosCodec
from geovpr.objectives.scaler import ScalerState as JScalerState
from geovpr.pipeline.fused import FusedPipeline as JFusedPipeline
from geovpr.retrieval.index import DescriptorIndex as JDescriptorIndex
from geovpr.train.model import RegressionModel as JRegressionModel
import geovpr_torch.cli.presets as tpresets
import geovpr_torch.models.convnext as tconvnext
import geovpr_torch.models.dinov2 as tdinov2
import geovpr_torch.models.swin as tswin
from geovpr_torch.cli.fuse import main as fuse_main
from geovpr_torch.data.pipeline import (ArraySource, DualGeometrySource,
                                        ImageFolderSource)
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.models.salad import DinoV2Salad
from geovpr_torch.objectives.angle_codec import SinCosCodec
from geovpr_torch.objectives.scaler import ScalerState
from geovpr_torch.pipeline.fused import (FusedPipeline, resize_for_head,
                                         resize_matrix)
from geovpr_torch.retrieval.index import DescriptorIndex

SWIN4 = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=4,
             image_size=64)
SWIN7 = dict(embed_dim=64, depths=(2, 2), num_heads=(2, 4), window_size=7,
             image_size=56)
CONVNEXT = dict(depths=(1, 1), dims=(32, 64))
DINO = dict(hidden_size=64, num_layers=2, num_heads=4)
# cosine scores of unit descriptors from two f32 models (measured 5.0e-8
# apart at most; the retrieve CLI test's 5e-3 is for two bf16 models)
SCORE_TOL = 1e-5
N_IMAGES, N_GALLERY, BATCH = 7, 12, 3


@pytest.fixture
def tiny_variants(monkeypatch):
    for mod in (jswin, tswin):
        monkeypatch.setitem(mod.SWIN_VARIANTS, "test-w4", SWIN4)
        monkeypatch.setitem(mod.SWIN_VARIANTS, "test-w7", SWIN7)
    for mod in (jconvnext, tconvnext):
        monkeypatch.setitem(mod.CONVNEXT_VARIANTS, "test", CONVNEXT)
    for mod in (jsalad, tdinov2):
        monkeypatch.setitem(mod.DINOV2_VARIANTS, "tiny", DINO)


# ------------------------------------------------------------- resize ----

@pytest.mark.parametrize("src,dst", [(384, 224), (384, 256), (256, 224),
                                     (224, 384), (48, 28), (48, 56),
                                     (518, 224), (7, 5)])
def test_resize_matrix_matches_jax(src, dst):
    want = JFusedPipeline._resize_matrix(src, dst)
    got = resize_matrix(src, dst)
    assert got.shape == want.shape == (dst, src) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("size,resize_to,out", [
    (28, 0, 28), (28, 32, 28), (56, 0, 56), (48, 0, 48), (32, 48, 32)])
def test_resize_for_head_matches_jax_image_resize(size, resize_to, out):
    """Downscale, the crop folded into the weight slice, upscale, the
    stream as is, and a crop of the stream itself (resize_to = S), against
    `jax.image.resize` (then the crop)."""
    x = np.random.default_rng(5).normal(size=(2, 48, 48, 3)).astype(
        np.float32)
    full = resize_to or size
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, full, full, 3),
                                       "bilinear"))
    off = (full - size) // 2
    want = want[:, off:off + size, off:off + size]
    got = resize_for_head(torch.from_numpy(x), size, resize_to)
    assert got.shape == (2, out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    jgot = JFusedPipeline._resize_for_head(jnp.asarray(x), size, resize_to)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5,
                               atol=1e-5)


def test_resize_for_head_keeps_tf32_setting():
    prev = torch.get_float32_matmul_precision()
    resize_for_head(torch.zeros(1, 8, 8, 3), 4)
    assert torch.get_float32_matmul_precision() == prev


# ------------------------------------------------------------ sources ----

def _write_images(root, n, seed=0, broken=True):
    """Non-square JPEGs and PNGs (landscape and portrait), and one broken
    file; returns the sorted names."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    names = []
    for i in range(n):
        h, w = (30, 44) if i % 2 else (47, 33)
        arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        name = f"t_{i:02d}." + ("png" if i % 3 == 0 else "jpg")
        Image.fromarray(arr).save(os.path.join(root, name))
        names.append(name)
    if broken:
        with open(os.path.join(root, "t_99.jpg"), "wb") as f:
            f.write(b"not an image")
        names.append("t_99.jpg")
    return sorted(names)


@pytest.mark.parametrize("kind", ["dual", "square", "resize_to"])
def test_sources_match_jax(tmp_path, kind):
    names = _write_images(str(tmp_path), 5)
    paths = [str(tmp_path / n) for n in names]
    targets = np.zeros((len(names), 1), np.float32)
    if kind == "dual":
        kw = dict(paths=paths, targets=targets, stream_size=40, alt_size=24,
                  alt_resize_to=28, filenames=names)
        got, want = DualGeometrySource(**kw), JDualGeometrySource(**kw)
    else:
        kw = dict(paths=paths, targets=targets, image_size=24,
                  filenames=names,
                  resize_to=28 if kind == "resize_to" else 0)
        got, want = ImageFolderSource(**kw), JImageFolderSource(**kw)
    idx = np.arange(len(names))
    g, w = got.get_batch(idx), want.get_batch(idx)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if kind == "dual":
        assert g["image"].shape == (6, 40, 40, 3)
        assert g["image_alt"].shape == (6, 24, 24, 3)
        assert not g["image"][-1].any() and not g["image_alt"][-1].any()
        assert got.image_size == 40


# ---------------------------------------------------- the pipeline ----

def _variables(jm, size, seed):
    """Random variables of the shapes flax's init gives (traced with
    `jax.eval_shape`, never compiled): kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.05^2), ConvNeXt's gamma N(0, 0.5^2), other parameters N(0,
    0.05^2), running means N(0, 0.1^2) and variances U(0.5, 1.5)."""
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
        if name == "gamma":
            return v * 0.5
        return v * 0.1 if name == "mean" else v * 0.05 + (name == "scale")
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _head(preset, variant, size, seed):
    """A preset's head on a small variant, the same weights on both sides:
    (JAX model, variables, port model), f32."""
    cfg = tpresets.build_preset(preset)
    mcfg = dataclasses.replace(cfg.model, variant=variant, image_size=size,
                               compute_dtype="float32")
    jm = JRegressionModel(config=JModelConfig(**dataclasses.asdict(mcfg)))
    variables = _variables(jm, size, seed)
    tm = RegressionModel(mcfg, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(variables))
    return jm, variables, tm.eval()


# component -> (preset, variant, input size, resize_to)
GEO = ("swin_b384_gemini2", "test-w4", 64, 0)
ANGLES = {"swin7": ("swin_t224_sincos_gemini", "test-w7", 56, 0),
          "effnet": ("efficientnet_sincos_gemini", "b0", 32, 40),
          "convnext": ("convnext_direct_maae", "test", 32, 0)}


def _pipelines(parts, rng):
    """JAX's and the port's FusedPipeline over the same weights, with the
    components named in `parts` ("geo", an ANGLES key with "+dual" for
    the dual geometry, "desc")."""
    jp = JFusedPipeline(batch_size=BATCH, top_k=4)
    tp = FusedPipeline(batch_size=BATCH, top_k=4, device="cpu")
    sizes = []
    if "geo" in parts:
        preset, variant, size, _ = GEO
        jm, v, tm = _head(preset, variant, size, 1)
        mean = np.array([219000.0, 143000.0], np.float32)
        scale = np.array([300.0, 120.0], np.float32)
        jp.geopose_model, jp.geopose_variables = jm, v
        jp.geopose_scaler = JScalerState(jnp.asarray(mean),
                                         jnp.asarray(scale))
        tp.geopose_model = tm
        tp.geopose_scaler = ScalerState(torch.from_numpy(mean),
                                        torch.from_numpy(scale))
        jp.geopose_size = tp.geopose_size = size
        sizes.append(size)
    for part in parts:
        key = part.split("+")[0]
        if key not in ANGLES:
            continue
        preset, variant, size, resize_to = ANGLES[key]
        jm, v, tm = _head(preset, variant, size, 2)
        cfg = tpresets.build_preset(preset)
        jp.angle_model, jp.angle_variables = jm, v
        tp.angle_model = tm
        if cfg.loss != "direct":
            jp.angle_codec = JSinCosCodec(cfg.codec_order)
            tp.angle_codec = SinCosCodec(cfg.codec_order)
        jp.angle_size = tp.angle_size = size
        jp.angle_resize_to = tp.angle_resize_to = resize_to
        sizes.append(max(size, resize_to))
    if "desc" in parts:
        x = np.zeros((1, 28, 28, 3), np.float32)
        jm = JDinoV2Salad(variant="tiny", image_size=28)
        v = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))
        prng = np.random.default_rng(3)
        v = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + prng.normal(size=a.shape).astype(
                np.float32) * 0.05, v)
        tm = DinoV2Salad(variant="tiny", image_size=28)
        tm.load_state_dict(state_dict_from_flax(v))
        db = rng.normal(size=(N_GALLERY, 8448)).astype(np.float32)
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        jp.descriptor_model, jp.descriptor_variables = jm, v
        jp.index = JDescriptorIndex(dim=8448, dtype=jnp.float32).build(db)
        tp.descriptor_model = tm.eval()
        tp.index = DescriptorIndex(dim=8448, dtype=torch.float32).build(db)
        jp.gallery_filenames = tp.gallery_filenames = [
            f"g_{i:03d}.jpg" for i in range(N_GALLERY)]
        jp.descriptor_size = tp.descriptor_size = 28
        sizes.append(28)
    return jp, tp, max(sizes)


def _close_angles(got, want, tol=1e-3):
    d = np.abs(got - want)
    assert np.minimum(d, 360 - d).max() <= tol


def _check_retrieval(got, want):
    np.testing.assert_allclose(got["retrieval_scores"],
                               want["retrieval_scores"], rtol=0,
                               atol=SCORE_TOL)
    checked = 0
    for q in range(want["retrieval_scores"].shape[0]):
        js = want["retrieval_scores"][q]
        for r in range(len(js)):
            gaps = [abs(js[r] - js[o]) for o in (r - 1, r + 1)
                    if 0 <= o < len(js)]
            if min(gaps) > 2 * SCORE_TOL:
                assert got["retrieval_indices"][q, r] == \
                    want["retrieval_indices"][q, r], (q, r)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("parts", [
    ("geo",), ("swin7",), ("convnext",), ("desc",),
    ("geo", "swin7", "desc"), ("geo", "effnet", "desc"),
    ("geo", "effnet+dual", "desc")])
def test_fused_pipeline_matches_jax(tiny_variants, tmp_path, parts):
    rng = np.random.default_rng(len(parts))
    jp, tp, stream = _pipelines(parts, rng)
    names = [f"img_{i:03d}.jpg" for i in range(N_IMAGES)]
    images = rng.integers(0, 256, (N_IMAGES, stream, stream, 3)).astype(
        np.uint8)
    targets = np.zeros((N_IMAGES, 1), np.float32)
    if any(p.endswith("+dual") for p in parts):
        # the angle head reads its own view as it is
        alt = rng.integers(0, 256, (N_IMAGES, 32, 32, 3)).astype(np.uint8)

        class Dual(ArraySource):
            def get_batch(self, idx):
                return {**super().get_batch(idx), "image_alt": alt[idx]}
        source = Dual(images, targets, names)
        for p in (jp, tp):
            p.angle_size = p.angle_resize_to = 0
    else:
        source = ArraySource(images, targets, names)
    want = jp.run(source)
    got = tp.run(source)
    assert set(got) == set(want)
    if "latlon" in want:
        assert got["latlon"].shape == (N_IMAGES, 2)
        np.testing.assert_allclose(
            got["latlon"], want["latlon"], rtol=0,
            atol=1e-4 * float(np.asarray(jp.geopose_scaler.scale).max()))
    if "angle" in want:
        assert got["angle"].shape == (N_IMAGES,)
        _close_angles(got["angle"], np.asarray(want["angle"]))
    if "descriptor" in want:
        _check_retrieval(got, want)

    written = tp.export(source, str(tmp_path / "port"))
    jfiles = {"geopose": (jexport.write_geopose_test_csv, "latlon"),
              "angle": (jexport.write_angle_test_csv, "angle")}
    for key, path in written.items():
        ref = str(tmp_path / f"ref_{key}.csv")
        if key == "retrieval":
            jexport.write_retrieval_matches_csv(
                ref, names, tp.gallery_filenames, got["retrieval_indices"],
                got["retrieval_scores"])
        else:
            writer, field = jfiles[key]
            writer(ref, names, got[field])
        assert open(path, "rb").read() == open(ref, "rb").read(), key
    assert set(written) == ({"geopose"} if "geo" in parts else set()) | (
        {"angle"} if any(p.split("+")[0] in ANGLES for p in parts)
        else set()) | ({"retrieval"} if "desc" in parts else set())


def test_fused_pipeline_resizes_on_the_device_of_its_stream():
    """The heads read the stream resized by `resize_for_head`, and the
    angle head's crop is folded in: the pipeline's angle equals the head
    on the cropped resize of the same normalised stream."""
    cfg = tpresets.build_preset("convnext_direct_maae")
    mcfg = dataclasses.replace(cfg.model, variant="base-224",
                               image_size=24, compute_dtype="float32")
    saved = tconvnext.CONVNEXT_VARIANTS["base-224"]
    tconvnext.CONVNEXT_VARIANTS["base-224"] = CONVNEXT
    try:
        from geovpr_torch.models.layers import init_weights_
        tm = init_weights_(RegressionModel(mcfg), torch.Generator()
                           .manual_seed(0)).eval()
    finally:
        tconvnext.CONVNEXT_VARIANTS["base-224"] = saved
    pipe = FusedPipeline(angle_model=tm, angle_size=24, angle_resize_to=28,
                         device="cpu")
    images = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8)
    got = pipe.forward(images)["angle"]
    from geovpr_torch.data.transforms import normalize
    with torch.inference_mode():
        raw = tm(normalize(resize_for_head(images.float() / 255.0, 24, 28)))
    torch.testing.assert_close(got, torch.remainder(raw[:, 0], 360.0))


# -------------------------------------------------------------- the CLI ----

@pytest.fixture
def tiny_presets(tiny_variants, monkeypatch):
    """The presets fuse reads, on the small variants and small images."""
    for name, (variant, size, resize_to) in {
            "swin_b384_gemini2": ("test-w4", 64, 0),
            "swin_t224_sincos_gemini": ("test-w7", 56, 0),
            "efficientnet_sincos_gemini": ("b0", 32, 40),
            "convnext_direct_maae": ("test", 32, 0)}.items():
        table = (tpresets.GEOPOSE_PRESETS if name in tpresets.GEOPOSE_PRESETS
                 else tpresets.ANGLE_PRESETS)
        cfg = table[name]
        monkeypatch.setitem(table, name, dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, image_size=size,
                                          batch_size=4,
                                          eval_resize_to=resize_to),
            model=dataclasses.replace(cfg.model, variant=variant)))


def _run_dir(root, preset, seed):
    """A run directory of the port's trainer format (`save_checkpoint`)
    holding a seeded random model, a fitted-looking scaler for geopose."""
    from geovpr_torch.cli.evaluate import build_model
    from geovpr_torch.train.checkpoint import save_checkpoint
    from geovpr_torch.train.state import TrainState, build_optimizer
    cfg = tpresets.build_preset(preset)
    model, scaler = build_model(cfg, "cpu", seed=seed)
    if scaler is None:
        scaler = ScalerState(torch.zeros(2), torch.ones(2))
    else:
        scaler = ScalerState(torch.tensor([219000.0, 143000.0]),
                             torch.tensor([300.0, 120.0]))
    run = os.path.join(root, f"run_{preset}")
    save_checkpoint(os.path.join(run, "best"), TrainState(
        step=0, model=model, opt=build_optimizer(model, cfg.optim),
        scaler=scaler, seed=seed), epoch=1)
    return run


@pytest.fixture
def fuse_data(tmp_path, tiny_presets):
    from PIL import Image
    root = str(tmp_path)
    test_dir = os.path.join(root, "test")
    names = _write_images(test_dir, N_IMAGES, seed=1, broken=False)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    rng = np.random.default_rng(2)
    with open(os.path.join(root, "gallery.csv"), "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i in range(N_GALLERY):
            nm = f"g_{i:03d}.jpg"
            Image.fromarray(rng.integers(0, 255, (36, 30, 3)).astype(
                np.uint8)).save(os.path.join(img_dir, nm))
            f.write(f"{nm},0,{219000.0 + i},{143000.0 + i},0.0,1\n")
    runs = {p: _run_dir(root, p, i) for i, p in enumerate(
        ("swin_b384_gemini2", "swin_t224_sincos_gemini",
         "efficientnet_sincos_gemini", "convnext_direct_maae"))}
    common = ["--test-dir", test_dir, "--device", "cpu",
              "--salad-variant", "tiny", "--salad-image-size", "28",
              "--top-k", "3"]
    gallery = ["--gallery-csv", os.path.join(root, "gallery.csv"),
               "--image-root", img_dir]
    return root, names, runs, common, gallery


def _fuse(argv, capsys):
    fuse_main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("angle", ["swin_t224_sincos_gemini",
                                   "efficientnet_sincos_gemini"])
def test_fuse_cli_writes_the_three_csvs(fuse_data, capsys, angle):
    """Geopose, angle and retrieval from one decode: a row per test image
    sorted by filename, finite values, k matches a row; the stream at the
    largest head size, the geopose head's; the geopose predictions equal
    to `run_evaluate`'s on the same run directory (the stream is its own
    size) within 1e-4 of the scaler's smaller scale, and EfficientNet's
    (the dual geometry) to its on the eval_resize_to view within 1e-3
    degrees; both run bf16 at other batch sizes."""
    from geovpr_torch.cli.evaluate import build_model, run_evaluate
    from geovpr_torch.cli.presets import objective_for
    root, names, runs, common, gallery = fuse_data
    out = _fuse(common + gallery + [
        "--geopose-preset", "swin_b384_gemini2",
        "--geopose-run", runs["swin_b384_gemini2"],
        "--angle-preset", angle, "--angle-run", runs[angle],
        "--out-dir", os.path.join(root, "out")], capsys)
    assert out["num_images"] == N_IMAGES and out["stream_size"] == 64
    geo = _rows(out["geopose_csv"])
    ang = _rows(out["angle_csv"])
    matches = _rows(out["retrieval_csv"])
    assert [r["filename"] for r in geo] == names
    assert [r["filename"] for r in ang] == names
    assert all(np.isfinite(float(v)) for r in geo for k, v in r.items()
               if k != "filename")
    assert all(0 <= float(r["predicted_angle_degrees"]) < 360 for r in ang)
    assert len(matches) == 3 * N_IMAGES
    assert [r["rank"] for r in matches[:3]] == ["1", "2", "3"]

    test_paths = [os.path.join(root, "test", n) for n in names]
    for preset in ("swin_b384_gemini2",) + (
            (angle,) if angle.startswith("efficient") else ()):
        cfg = tpresets.build_preset(preset)
        model, scaler = build_model(cfg, "cpu", run_dir=runs[preset])
        geo = preset.startswith("swin")
        src = ImageFolderSource(
            paths=test_paths,
            targets=np.zeros((N_IMAGES, 2) if geo else N_IMAGES, np.float32),
            image_size=cfg.data.image_size, filenames=names,
            resize_to=cfg.data.eval_resize_to)
        ev, _ = run_evaluate(model, scaler, src, batch_size=4,
                             out_dir=os.path.join(root, f"ev_{preset}"),
                             device="cpu", test_source=src,
                             objective=objective_for(cfg))
        want = _rows(ev["test_csv"])
        got = _rows(out["geopose_csv"] if geo else out["angle_csv"])
        assert [r["filename"] for r in got] == \
            [r["filename"] for r in want] == names
        cols = [k for k in want[0] if k != "filename"]
        g, w = (np.array([[float(r[k]) for k in cols] for r in rows])
                for rows in (got, want))
        if geo:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * 120.0)
        else:
            _close_angles(g[:, 0], w[:, 0])


def test_fuse_cli_save_then_load_index(fuse_data, capsys):
    """--save-index then --load-index (no gallery CSV) write the same
    matches; --approx is accepted and searched exactly; the saved index
    loads in the JAX package."""
    from geovpr.retrieval.index import load_index as j_load_index
    root, names, runs, common, gallery = fuse_data
    idx = os.path.join(root, "gallery.npz")
    a = _fuse(common + gallery + ["--save-index", idx, "--out-dir",
                                  os.path.join(root, "a")], capsys)
    b = _fuse(common + ["--load-index", idx, "--out-dir",
                        os.path.join(root, "b")], capsys)
    c = _fuse(common + ["--load-index", idx, "--approx", "0.95",
                        "--out-dir", os.path.join(root, "c")], capsys)
    assert set(a) == {"num_images", "stream_size", "retrieval_csv"}
    ra, rb, rc = (_rows(o["retrieval_csv"]) for o in (a, b, c))
    assert ra == rb == rc
    assert {r["match_filename"] for r in ra} <= {
        f"g_{i:03d}.jpg" for i in range(N_GALLERY)}
    index, meta = j_load_index(idx)
    assert index.size == N_GALLERY
    assert list(meta["filenames"]) == [f"g_{i:03d}.jpg"
                                       for i in range(N_GALLERY)]


def test_fuse_cli_int8(fuse_data, capsys):
    """--int8: window-12 Swin geopose, ConvNeXt angles and SALAD in w8a8
    (calibrated on the first test / gallery batch), an int8 index; finite
    outputs in every CSV. EfficientNet stays bf16 with JAX's note."""
    root, names, runs, common, gallery = fuse_data
    out = _fuse(common + gallery + [
        "--int8", "--geopose-preset", "swin_b384_gemini2",
        "--geopose-run", runs["swin_b384_gemini2"],
        "--angle-preset", "convnext_direct_maae",
        "--angle-run", runs["convnext_direct_maae"],
        "--out-dir", os.path.join(root, "int8")], capsys)
    assert len(_rows(out["geopose_csv"])) == N_IMAGES
    assert all(np.isfinite(float(r["predicted_angle_degrees"]))
               for r in _rows(out["angle_csv"]))
    assert len(_rows(out["retrieval_csv"])) == 3 * N_IMAGES
    fuse_main(common + ["--int8", "--angle-preset",
                        "efficientnet_sincos_gemini", "--angle-run",
                        runs["efficientnet_sincos_gemini"], "--out-dir",
                        os.path.join(root, "eff")])
    assert "note: --int8 skipped for the angle component (family " \
        "'efficientnet' has no int8 path)" in capsys.readouterr().out


def test_fuse_cli_int8_window7_angle(fuse_data, capsys):
    """--int8 with the window-7 Swin angle head alone: its attention halves
    on the torch int8 ops, its MLP halves on K3's plain version."""
    root, names, runs, common, gallery = fuse_data
    out = _fuse(common + [
        "--int8", "--angle-preset", "swin_t224_sincos_gemini",
        "--angle-run", runs["swin_t224_sincos_gemini"],
        "--out-dir", os.path.join(root, "w7")], capsys)
    assert out["stream_size"] == 56
    rows = _rows(out["angle_csv"])
    assert [r["filename"] for r in rows] == names
    assert all(0 <= float(r["predicted_angle_degrees"]) < 360 for r in rows)


@pytest.mark.parametrize("extra,match", [
    (["--geopose-preset", "swin_b384_gemini2"], "must be given together"),
    (["--angle-run", "x"], "must be given together"),
    (["--gallery-csv", "g.csv"], "requires --image-root"),
    ([], "need at least one component"),
    (["--load-index", "x.npz", "--device", "cuda"], "no CUDA device"),
])
def test_fuse_cli_refuses(tmp_path, extra, match):
    if "--device" in extra and torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--test-dir", str(tmp_path)] + extra
    if "--device" not in extra:
        argv += ["--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        fuse_main(argv)


def test_fuse_cli_refuses_a_missing_checkpoint(fuse_data):
    root, names, runs, common, gallery = fuse_data
    with pytest.raises(SystemExit, match="no checkpoint 'latest'"):
        fuse_main(common + ["--geopose-preset", "swin_b384_gemini2",
                            "--geopose-run", runs["swin_b384_gemini2"],
                            "--checkpoint", "latest", "--out-dir",
                            os.path.join(root, "out")])
