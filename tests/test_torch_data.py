"""The port's copies of the JAX package's host data code — `Manifest` /
`load_manifest` and `ImageFolderSource` (PIL and native) — held to the
originals:
the same manifest from the same CSV, the same uint8 pixels from the same
JPEG and PNG files (an unreadable file included)."""

import os

import numpy as np
import pytest

from geovpr.data.manifest import load_manifest as j_load_manifest
from geovpr.data.pipeline import ImageFolderSource as JSource
from geovpr_torch.data.manifest import load_manifest
from geovpr_torch.data.pipeline import ImageFolderSource


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    names = []
    for i, (ext, size) in enumerate([(".jpg", (40, 30)), (".png", (25, 50)),
                                     (".jpeg", (32, 32)), (".png", (7, 9))]):
        name = f"img_{i}{ext}"
        arr = rng.integers(0, 255, (size[1], size[0], 3)).astype(np.uint8)
        Image.fromarray(arr).save(root / name)
        names.append(name)
    (root / "broken.jpg").write_bytes(b"not an image")
    names.append("broken.jpg")
    with open(root / "labels.csv", "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i, n in enumerate(names + ["missing.jpg"]):
            f.write(f"{n},0,{219000.5 + i},{143000.25 - i},{370.0 + i},"
                    f"{i % 3}\n")
    return str(root)


@pytest.mark.parametrize("screen", [True, False])
def test_manifest_matches_jax(image_dir, screen):
    csv_path = os.path.join(image_dir, "labels.csv")
    want = j_load_manifest(csv_path, image_dir, screen_missing_files=screen)
    got = load_manifest(csv_path, image_dir, screen_missing_files=screen)
    assert got.filenames == want.filenames
    assert len(got) == len(want) == (5 if screen else 6)
    for field in ("latitude", "longitude", "angle", "region_id", "latlon"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.paths() == want.paths()
    sel = got.select([2, 0])
    assert sel.filenames == want.select([2, 0]).filenames


@pytest.mark.parametrize("resize_to", [0, 36])
def test_image_folder_source_matches_jax(image_dir, resize_to):
    """Same pixels for JPEG and PNG, square resize and short-side resize +
    centre crop; the unreadable file is a black frame on both sides."""
    m = load_manifest(os.path.join(image_dir, "labels.csv"), image_dir)
    kw = dict(paths=m.paths(), targets=np.asarray(m.latlon, np.float32),
              image_size=24, resize_to=resize_to, filenames=m.filenames)
    idx = np.arange(len(m))
    want = JSource(**kw).get_batch(idx)
    got = ImageFolderSource(**kw).get_batch(idx)
    assert got["image"].dtype == np.uint8
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["target"], want["target"])
    assert not got["image"][m.filenames.index("broken.jpg")].any()


@pytest.mark.parametrize("resize_to", [0, 36])
def test_image_folder_source_refuses_the_native_decoder(image_dir,
                                                        resize_to):
    """`decoder="native"`, once refused, decodes: the JPEGs with the port's
    libjpeg decoder, the PNGs and the unreadable file through the PIL
    fallback, the same pixels as JAX's `ImageFolderSource(decoder=
    "native")` (tests/test_torch_data_cache_decoder.py holds the decoders
    themselves equal)."""
    m = load_manifest(os.path.join(image_dir, "labels.csv"), image_dir)
    kw = dict(paths=m.paths(), targets=np.asarray(m.latlon, np.float32),
              image_size=24, resize_to=resize_to, filenames=m.filenames,
              decoder="native", num_threads=2)
    idx = np.arange(len(m))
    want = JSource(**kw).get_batch(idx)
    got = ImageFolderSource(**kw).get_batch(idx)
    np.testing.assert_array_equal(got["image"], want["image"])
    assert not got["image"][m.filenames.index("broken.jpg")].any()
