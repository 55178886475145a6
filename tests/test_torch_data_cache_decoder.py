"""The port's decoded-image cache (`CachedImageSource`) and native JPEG
decoder (`geovpr_torch.data.decoder`) against the JAX package's.

The cache: the same batches as JAX's `CachedImageSource` over the same
inner source, in RAM and in a `.npy` memmap; each row decoded once, on its
first touch; an all-black decode (the failure sentinel) left uncached and
retried. The decoder: the port's library, built from its own copy of the
C++ source (byte for byte `native/decoder.cpp`), decodes seeded JPEGs of
several sizes and aspects to the same bytes as JAX's `decode_batch`
(both libraries built here from that source with the flags of
`native/Makefile`), square and with `resize_short`; a corrupt buffer is a
zeroed frame with ok False; where the compiler is missing the port raises
instead of decoding with PIL.
"""

import io
from pathlib import Path

import numpy as np
import pytest

import geovpr.data.decoder as jdec
from geovpr.data.pipeline import ArraySource as JArraySource
from geovpr.data.pipeline import CachedImageSource as JCached
from geovpr_torch.data import decoder as tdec
from geovpr_torch.data.pipeline import CachedImageSource, cached_source

REPO = Path(__file__).resolve().parent.parent


class _Inner:
    """An image source that counts the rows it decodes and fails (a black
    frame) on the rows in `fail` until `fail` is emptied."""

    def __init__(self, n=6, size=8, fail=()):
        rng = np.random.default_rng(0)
        self.images = rng.integers(1, 256, (n, size, size, 3)).astype(
            np.uint8)
        self.targets = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
        self.image_size = size
        self.filenames = [f"{i}.jpg" for i in range(n)]
        self.fail = set(fail)
        self.decoded = []

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx):
        self.decoded.extend(int(i) for i in idx)
        img = self.images[idx].copy()
        for j, i in enumerate(idx):
            if int(i) in self.fail:
                img[j] = 0
        return {"image": img, "target": self.targets[idx]}


@pytest.mark.parametrize("memmap", [False, True])
def test_cached_source_matches_jax(tmp_path, memmap):
    """Three epochs of batches (a repeated row in one batch included)
    through the port's and JAX's cache: the same images and targets each
    time; each row decoded once; row 2 fails in the first epoch, stays
    uncached and is decoded again (and kept) in the second."""
    order = [np.array([3, 0, 3]), np.array([2, 5]), np.array([1, 4, 0])]
    out = {}
    for name, cls in (("port", CachedImageSource), ("jax", JCached)):
        inner = _Inner(fail={2})
        path = str(tmp_path / f"{name}.npy") if memmap else ""
        src = cls(inner, cache_path=path)
        assert len(src) == 6 and src.image_size == 8
        assert src.filenames == inner.filenames
        batches = []
        for epoch in range(3):
            batches.append([src.get_batch(idx) for idx in order])
            if epoch == 0:
                inner.fail.clear()
        out[name] = (batches, inner.decoded)
        if memmap:
            cache = np.load(path)
            np.testing.assert_array_equal(cache, inner.images)
    (got, got_dec), (want, want_dec) = out["port"], out["jax"]
    assert got_dec == want_dec
    # each row once, row 2 twice (its first decode failed)
    assert sorted(got_dec) == [0, 1, 2, 2, 3, 4, 5]
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["target"], w["target"])
    assert not got[0][1]["image"][0].any()          # the failed decode
    np.testing.assert_array_equal(got[1][1]["image"][0],
                                  _Inner().images[2])


def test_cached_source_wraps_by_config(tmp_path):
    inner = _Inner()
    assert cached_source(inner, "", "train") is inner
    assert cached_source(None, "ram", "val") is None
    ram = cached_source(inner, "ram", "train")
    assert isinstance(ram, CachedImageSource) and not ram.cache_path
    assert cached_source(ram, "ram", "train") is ram
    disk = cached_source(inner, str(tmp_path / "c"), "val")
    assert disk.cache_path == str(tmp_path / "c") + ".val.npy"
    arrays = JArraySource(inner.images, inner.targets)   # no image_size
    assert cached_source(arrays, "ram", "train") is arrays


def _jpegs(rng, sizes, quality=90):
    from PIL import Image
    out = []
    for w, h in sizes:
        # smooth content, as photographs have, plus noise
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([(xx * 255 // max(w - 1, 1)),
                         (yy * 255 // max(h - 1, 1)),
                         ((xx + yy) * 127 // max(w + h - 2, 1))], -1)
        img = np.clip(base + rng.integers(-20, 21, (h, w, 3)), 0, 255)
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG",
                                                   quality=quality)
        out.append(buf.getvalue())
    return out


SIZES = [(640, 480), (480, 640), (300, 300), (97, 211), (2000, 1500),
         (24, 24)]


@pytest.mark.parametrize("resize_short", [0, 256])
def test_native_decode_matches_jax(resize_short):
    assert jdec.native_available(), "JAX's native decoder did not build"
    bufs = _jpegs(np.random.default_rng(0), SIZES)
    want, want_ok = jdec.decode_batch(bufs, 224, 224, threads=3,
                                      resize_short=resize_short)
    got, ok = tdec.decode_batch(bufs, 224, 224, threads=3,
                                resize_short=resize_short)
    assert ok.all() and want_ok.all()
    assert got.dtype == np.uint8 and got.shape == (len(SIZES), 224, 224, 3)
    np.testing.assert_array_equal(got, want)
    again, _ = tdec.decode_batch(bufs, 224, 224, threads=1,
                                 resize_short=resize_short)
    np.testing.assert_array_equal(again, got)


def test_native_decode_corrupt_input(tmp_path):
    """A truncated JPEG, bytes that are no image, an empty buffer and a
    missing file: zeroed frames with ok False beside a good decode."""
    good = _jpegs(np.random.default_rng(1), [(64, 48)])[0]
    bufs = [good, good[: len(good) // 3], b"not an image", b""]
    imgs, ok = tdec.decode_batch(bufs, 32, 32, threads=2)
    want, want_ok = jdec.decode_batch(bufs, 32, 32, threads=2)
    assert ok.tolist() == want_ok.tolist()
    assert ok[0] and not ok[2] and not ok[3]
    for j in np.flatnonzero(~ok):
        assert not imgs[j].any()
    np.testing.assert_array_equal(imgs, want)
    (tmp_path / "a.jpg").write_bytes(good)
    imgs, ok = tdec.decode_files([str(tmp_path / "a.jpg"),
                                  str(tmp_path / "missing.jpg")], 32, 32)
    assert ok.tolist() == [True, False] and not imgs[1].any()


def test_native_decoder_raises_without_a_compiler(tmp_path, monkeypatch):
    """No library built yet and no compiler: `load_library`, and an
    `ImageFolderSource(decoder="native")`, raise naming the compiler, every
    time, rather than decode with PIL."""
    from geovpr_torch.data.pipeline import ImageFolderSource

    monkeypatch.setattr(tdec, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tdec, "_lib", None)
    monkeypatch.setattr(tdec, "_error", None)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    for _ in range(2):
        with pytest.raises(tdec.NativeDecoderUnavailable,
                           match="C\\+\\+ compiler.*no-such-compiler-here"):
            tdec.load_library()
    with pytest.raises(tdec.NativeDecoderUnavailable, match="compiler"):
        ImageFolderSource(paths=[], targets=np.zeros((0, 2), np.float32),
                          decoder="native")
    with pytest.raises(tdec.NativeDecoderUnavailable):
        tdec.decode_batch([b""], 8, 8)


def test_native_decoder_names_a_missing_libjpeg(tmp_path, monkeypatch):
    """What a failed build lacked is read from the compiler's output
    (jpeglib.h, or libjpeg.so for the linker); a source that includes a
    header no system has fails the build with the compiler's log."""
    src = tmp_path / "jpeg_decoder.cpp"
    src.write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(tdec, "SOURCE", src)
    monkeypatch.setattr(tdec, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tdec, "_lib", None)
    monkeypatch.setattr(tdec, "_error", None)
    log = "fatal error: jpeglib.h: No such file or directory"
    assert "jpeglib.h" in tdec._missing(log)
    assert "libjpeg.so" in tdec._missing("ld: cannot find -ljpeg")
    with pytest.raises(tdec.NativeDecoderUnavailable,
                       match="could not be built"):
        tdec.load_library()


def test_decoder_source_is_a_copy_of_the_native_one():
    assert (REPO / "geovpr_torch" / "csrc" / "jpeg_decoder.cpp"
            ).read_bytes() == (REPO / "native" / "decoder.cpp").read_bytes()
    assert tdec.SOURCE == REPO / "geovpr_torch" / "csrc" / "jpeg_decoder.cpp"
    assert tdec.libjpeg_version() == jdec._load_library(
    ).geovpr_decoder_version()
