"""Input pipeline of the port: in-memory and disk sources, the decoded-image
cache, static-shape batching and host-to-device prefetch (the counterparts
of `geovpr.data.pipeline`'s `ArraySource`, `ImageFolderSource`,
`DualGeometrySource`, `CachedImageSource`, `iterate_batches` and
`prefetch_to_device`).

The host code repeats the JAX package's so that the port runs where
neither jax nor `geovpr` is installed; tests hold it to the originals.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class ArraySource:
    """In-memory image source (synthetic data, tests, pre-decoded shards)."""

    images: np.ndarray          # (N, H, W, 3) uint8
    targets: np.ndarray         # (N, T) float32
    filenames: Optional[list[str]] = None

    def __len__(self):
        return self.images.shape[0]

    def get_batch(self, idx: np.ndarray) -> dict:
        return {"image": self.images[idx], "target": self.targets[idx]}


@dataclasses.dataclass
class ImageFolderSource:
    """Disk-backed source: decodes JPEG/PNG in a thread pool at
    batch-fetch time and resizes on the host (bilinear), as the original.
    An unreadable file becomes a black frame, the reference's fallback
    (`geovpr/data/pipeline.py:72-79`). `decoder="pil"` decodes with PIL;
    `decoder="native"` with the port's libjpeg batch decoder
    (`geovpr_torch.data.decoder`), built when the source is made, which
    raises `NativeDecoderUnavailable` where it cannot be built; a file
    libjpeg rejects (a PNG, a corrupt JPEG) is decoded with PIL, as JAX's
    source does."""

    paths: Sequence[str]
    targets: np.ndarray
    image_size: int = 224
    num_threads: int = 8
    filenames: Optional[list[str]] = None
    decoder: str = "pil"
    # resize the short side to `resize_to`, then centre-crop `image_size`;
    # 0 is a plain square resize
    resize_to: int = 0

    def __post_init__(self):
        if self.decoder == "native":
            from geovpr_torch.data.decoder import load_library
            load_library()
        elif self.decoder != "pil":
            raise ValueError(f"decoder={self.decoder!r}: 'pil' or 'native'")
        self._pool = concurrent.futures.ThreadPoolExecutor(self.num_threads)

    def __len__(self):
        return len(self.paths)

    def _decode(self, path: str) -> np.ndarray:
        try:
            return self._decode_inner(path)
        except Exception:
            return np.zeros((self.image_size, self.image_size, 3), np.uint8)

    def _decode_inner(self, path: str) -> np.ndarray:
        from PIL import Image
        with Image.open(path) as img:
            img = img.convert("RGB")
            if self.resize_to:
                w, h = img.size
                short = min(w, h)
                nw, nh = (round(w * self.resize_to / short),
                          round(h * self.resize_to / short))
                img = img.resize((nw, nh), Image.BILINEAR)
                left = (nw - self.image_size) // 2
                top = (nh - self.image_size) // 2
                img = img.crop((left, top, left + self.image_size,
                                top + self.image_size))
            else:
                img = img.resize((self.image_size, self.image_size),
                                 Image.BILINEAR)
            return np.asarray(img, np.uint8)

    def get_batch(self, idx: np.ndarray) -> dict:
        paths = [self.paths[i] for i in idx]
        if self.decoder == "native":
            from geovpr_torch.data.decoder import decode_files
            imgs, ok = decode_files(paths, self.image_size, self.image_size,
                                    threads=self.num_threads,
                                    resize_short=self.resize_to)
            for j in np.flatnonzero(~ok):
                imgs[j] = self._decode(paths[j])
            return {"image": imgs, "target": self.targets[idx]}
        imgs = list(self._pool.map(self._decode, paths))
        return {"image": np.stack(imgs), "target": self.targets[idx]}


@dataclasses.dataclass
class DualGeometrySource:
    """One decode, two geometries per image (the counterpart of
    `geovpr.data.pipeline.DualGeometrySource`): batches hold the square
    `image` stream (a bilinear resize to `stream_size`, the geometry every
    geopose head trained on) and `image_alt`, a short-side bilinear resize
    to `alt_resize_to` and a centre crop of `alt_size`, EfficientNet's
    eval transform Resize(256)+CenterCrop(224). The fused pipeline feeds
    `image_alt` to the angle head as it is, so that its field of view on a
    non-square photo is the one it was evaluated on. A failed decode gives
    black frames, as the reference's fallback."""

    paths: Sequence[str]
    targets: np.ndarray
    stream_size: int
    alt_size: int
    alt_resize_to: int
    num_threads: int = 8
    filenames: Optional[list[str]] = None

    def __post_init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(self.num_threads)
        self.image_size = self.stream_size

    def __len__(self):
        return len(self.paths)

    def _decode(self, path: str):
        from PIL import Image
        try:
            with Image.open(path) as img:
                img = img.convert("RGB")
                square = np.asarray(
                    img.resize((self.stream_size, self.stream_size),
                               Image.BILINEAR), np.uint8)
                w, h = img.size
                short = min(w, h)
                nw = round(w * self.alt_resize_to / short)
                nh = round(h * self.alt_resize_to / short)
                resized = img.resize((nw, nh), Image.BILINEAR)
                left = (nw - self.alt_size) // 2
                top = (nh - self.alt_size) // 2
                alt = np.asarray(
                    resized.crop((left, top, left + self.alt_size,
                                  top + self.alt_size)), np.uint8)
                return square, alt
        except Exception:
            return (np.zeros((self.stream_size, self.stream_size, 3),
                             np.uint8),
                    np.zeros((self.alt_size, self.alt_size, 3), np.uint8))

    def get_batch(self, idx: np.ndarray) -> dict:
        pairs = list(self._pool.map(self._decode,
                                    [self.paths[i] for i in idx]))
        return {"image": np.stack([p[0] for p in pairs]),
                "image_alt": np.stack([p[1] for p in pairs]),
                "target": self.targets[idx]}


@dataclasses.dataclass
class CachedImageSource:
    """The decoded, resized uint8 images of an inner source, cached
    (`geovpr/data/pipeline.py:180-220`): the first touch of a row decodes
    it, every later epoch reads the cache, in RAM or (`cache_path`) in a
    `.npy` memmap on disk for a dataset larger than memory. An all-black
    frame, the decode-failure sentinel, stays uncached, so that a transient
    read error is retried the next epoch rather than kept for good."""

    inner: object
    cache_path: str = ""   # "" keeps the cache in RAM

    def __post_init__(self):
        n = len(self.inner)
        s = self.inner.image_size
        shape = (n, s, s, 3)
        if self.cache_path:
            self._cache = np.lib.format.open_memmap(
                self.cache_path, mode="w+", dtype=np.uint8, shape=shape)
        else:
            self._cache = np.zeros(shape, np.uint8)
        self._have = np.zeros(n, bool)
        self.filenames = getattr(self.inner, "filenames", None)
        self.targets = self.inner.targets
        self.image_size = s

    def __len__(self):
        return len(self.inner)

    def get_batch(self, idx: np.ndarray) -> dict:
        missing = np.unique(idx[~self._have[idx]])
        if missing.size:
            decoded = self.inner.get_batch(missing)
            self._cache[missing] = decoded["image"]
            ok = decoded["image"].reshape(len(missing), -1).any(axis=1)
            self._have[missing] = ok
        return {"image": self._cache[idx], "target": self.targets[idx]}


def cached_source(source, cache: str, role: str):
    """`source` behind a `CachedImageSource` as `data.cache_decoded` asks:
    "" leaves it as it is, "ram" caches in memory, anything else is a path
    prefix and the cache the memmap `{cache}.{role}.npy` (one file per
    role: a train and a val cache in one file would truncate each other).
    A source that decodes nothing (no `image_size`, as `ArraySource`) or is
    cached already is left as it is."""
    if (not cache or source is None or isinstance(source, CachedImageSource)
            or not hasattr(source, "image_size")):
        return source
    return CachedImageSource(source, "" if cache == "ram"
                             else f"{cache}.{role}.npy")


def iterate_batches(source, batch_size: int, shuffle: bool = False,
                    seed: int = 0, epoch: int = 0,
                    drop_remainder: bool = False) -> Iterator[dict]:
    """Yield static-shape batches, in order or (`shuffle`) in the order of
    numpy's `default_rng(seed + epoch)`, the JAX package's exactly; the
    final partial batch is dropped (`drop_remainder`) or padded by
    repeating its last row, `mask` marks the real rows and `_indices` holds
    their source indices."""
    n = len(source)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, stop, batch_size):
        idx = order[start:start + batch_size]
        valid = idx.shape[0]
        if valid < batch_size:
            idx = np.concatenate([idx, np.repeat(idx[-1:],
                                                 batch_size - valid)])
        batch = source.get_batch(idx)
        batch["mask"] = np.arange(batch_size) < valid
        batch["_indices"] = idx[:valid]
        yield batch


def prefetch_to_device(iterator, device, depth: int = 2, mesh=None):
    """Copy each batch's arrays to `device` while earlier batches are still
    being consumed. On CUDA the host arrays are staged in pinned memory and
    copied with `non_blocking=True` on the current stream, so the copy of
    batch i+1 overlaps the compute of batch i. Keys starting with "_" (host
    metadata such as `_indices`) pass through untouched.

    With a `mesh` (`geovpr/data/pipeline.py:250-287`) a batch whose rows do
    not divide the data shards is first padded by repeating row 0 with the
    mask false (those rows still enter BatchNorm's batch statistics, as
    in JAX), and each rank takes its rows."""
    from geovpr_torch.parallel.mesh import pad_batch_to_multiple, shard_rows

    device = torch.device(device)
    pin = device.type == "cuda"
    queue = collections.deque()

    def put(batch):
        host = {k: v for k, v in batch.items() if not k.startswith("_")}
        rows = slice(None)
        if mesh is not None:
            shards = mesh.axis_size("data")
            n = next(iter(host.values())).shape[0]
            if n % shards:
                old_mask = host.get("mask")
                host, pad_mask = pad_batch_to_multiple(host, shards)
                host["mask"] = (pad_mask if old_mask is None
                                else np.logical_and(host["mask"], pad_mask))
            rows = shard_rows(mesh, next(iter(host.values())).shape[0])
        out = {}
        for k in dict.fromkeys([*batch, *host]):
            if k.startswith("_"):
                out[k] = batch[k]
                continue
            t = torch.from_numpy(np.ascontiguousarray(host[k][rows]))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        return out

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) > depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
