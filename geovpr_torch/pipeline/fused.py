"""Fused end-to-end inference pipeline of the port (the counterpart of
`geovpr.pipeline.fused`).

One decoded image stream feeds up to three heads in one forward per
batch on the device, and the host sees only their final arrays:

    images -> resize -> normalize -> DINOv2+SALAD -> descriptors -> top-k
                                 \\-> geopose net  -> (lat, lon)
                                 \\-> angle net    -> heading

Every head runs its own kernels, as `cli.retrieve` and `cli.evaluate` run
them: DINOv2 K1 (K2 and K3 in w8a8), Swin-B-384 K4 (K5 and K3) and K6,
Swin-T-224 K7 (its w8a8 half torch ops, as JAX's is XLA, and K3) and K6,
ConvNeXt K3 in w8a8. The stream arrives at the largest head size; each
head gets its bilinear resize on the device as two separable f32 matmuls
against `resize_matrix`, the weights `jax.image.resize` uses (with
antialiasing on a downscale, which `F.interpolate` does not do by
default), and the Resize(256)+CenterCrop(224) crop folded into the weight
slice. JAX computes this resize in XLA, outside any kernel, so it is
`torch.matmul` here, in full f32 (no TF32).

With a `mesh` (`geovpr/pipeline/fused.py:68`, `:178-196`) every rank runs
its rows of each batch and the outputs are gathered over `data`, so every
rank holds every image's results; the index is the sharded one, and rank 0
writes the CSVs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Any, Optional

import numpy as np
import torch

from geovpr_torch.data.pipeline import iterate_batches, prefetch_to_device
from geovpr_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, normalize
from geovpr_torch.parallel.mesh import (barrier, broadcast_object,
                                        gather_rows, is_writer)
from geovpr_torch.pipeline.export import (write_angle_test_csv,
                                          write_geopose_test_csv)
from geovpr_torch.retrieval.index import write_retrieval_matches_csv


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """The (dst, src) row matrix of `jax.image.resize(..., "bilinear")` on
    one axis: the triangle kernel of `scale_and_translate` at the sample
    points f = (i + 0.5) src/dst - 0.5, widened by src/dst on a downscale
    (antialias), each row normalised to sum 1 and zeroed where f falls
    outside [-0.5, src - 0.5]."""
    scale = src / dst
    f = (np.arange(dst) + 0.5) * scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(f[:, None] - np.arange(src)[None, :])
                   / max(scale, 1.0))
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    w[(f < -0.5) | (f > src - 0.5)] = 0.0
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _head_weights(src: int, size: int, resize_to: int,
                  device: torch.device) -> torch.Tensor:
    """The (size, src) f32 weights of one head's resize on `device`: rows
    [off, off + size) of the (resize_to, src) matrix with a crop, else the
    (size, src) matrix; made outside inference mode, as the cache hands it
    to every later call."""
    if resize_to:
        off = (resize_to - size) // 2
        w = resize_matrix(src, resize_to)[off:off + size]
    else:
        w = resize_matrix(src, size)
    with torch.inference_mode(False), torch.no_grad():
        return torch.from_numpy(np.ascontiguousarray(w)).to(device)


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matmuls in full precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def resize_for_head(x: torch.Tensor, size: int,
                    resize_to: int = 0) -> torch.Tensor:
    """One head's view of the square (B, S, S, C) stream: resized to `size`
    (0: the stream as is), or with `resize_to` resized to `resize_to` and
    centre-cropped to `size`, the crop folded into the weight slice (exact
    by linearity; the resize_to^2 image never exists). Two separable
    matmuls in x's dtype (`geovpr/pipeline/fused.py:99-123`)."""
    s = x.shape[1]
    if resize_to and size:
        if resize_to == s:
            off = (resize_to - size) // 2
            return x[:, off:off + size, off:off + size, :]
        w = _head_weights(s, size, resize_to, x.device)
    elif size and size != s:
        w = _head_weights(s, size, 0, x.device)
    else:
        return x
    w = w.to(x.dtype)
    with _full_f32_matmul():
        y = torch.einsum("th,bhwc->btwc", w, x)
        return torch.einsum("tw,bhwc->bhtc", w, y)


@dataclasses.dataclass
class FusedPipeline:
    """The three inference heads over one image stream. Each component is
    a model (in eval mode on `device`) with its postprocessing: the
    geopose `RegressionModel` and its target scaler, the angle
    `RegressionModel` and its codec (None: a direct degrees head), the
    `DinoV2Salad` descriptor model and the gallery index. Any component may
    be None; the pipeline emits what it has. `device` is the caller's:
    there is no fallback to the CPU."""

    geopose_model: Any = None
    geopose_scaler: Any = None
    angle_model: Any = None
    angle_codec: Any = None
    descriptor_model: Any = None
    index: Any = None
    # filenames of the index rows, for retrieval_matches.csv
    gallery_filenames: Optional[list] = None
    top_k: int = 5
    mean: tuple = IMAGENET_MEAN
    std: tuple = IMAGENET_STD
    batch_size: int = 64
    device: Any = "cuda"
    # each head's input size (0: the stream as is) and the angle head's
    # Resize(angle_resize_to)+CenterCrop(angle_size) eval geometry
    geopose_size: int = 0
    angle_size: int = 0
    descriptor_size: int = 0
    angle_resize_to: int = 0
    mesh: Any = None

    def __post_init__(self):
        self.device = torch.device(self.device)

    def _head_input(self, x_scaled: torch.Tensor, size: int,
                    resize_to: int = 0) -> torch.Tensor:
        """Resize first, then normalize: the two commute up to rounding
        (the rows sum to one), and the resize reads the raw stream."""
        return normalize(resize_for_head(x_scaled, size, resize_to),
                         self.mean, self.std)

    @torch.inference_mode()
    def forward(self, images: torch.Tensor,
                images_alt: Optional[torch.Tensor] = None) -> dict:
        """One batch on the device: uint8 (or float) NHWC images (and the
        angle head's own view `images_alt`) -> {"latlon" (B, 2), "angle"
        (B,), "descriptor" (B, D)} for the components present."""
        x = images.float()
        if images.dtype == torch.uint8:
            x = x / 255.0
        out = {}
        if self.geopose_model is not None:
            preds = self.geopose_model(self._head_input(x, self.geopose_size))
            if self.geopose_scaler is not None:
                preds = self.geopose_scaler.inverse_transform(preds)
            out["latlon"] = preds
        if self.angle_model is not None:
            if images_alt is not None:
                ang_x = normalize(images_alt, self.mean, self.std)
            else:
                ang_x = self._head_input(x, self.angle_size,
                                         self.angle_resize_to)
            raw = self.angle_model(ang_x)
            out["angle"] = (self.angle_codec.decode(raw)
                            if self.angle_codec is not None
                            else torch.remainder(raw[..., 0], 360.0))
        if self.descriptor_model is not None:
            out["descriptor"] = self.descriptor_model(self._head_input(
                x, self.descriptor_size)).pooled.float()
        return out

    def run(self, source) -> dict[str, np.ndarray]:
        """Every component over `source`: dense arrays in source order, and
        the top-k matches where an index is attached."""
        n = len(source)
        results: dict[str, np.ndarray] = {}
        for batch in prefetch_to_device(
                iterate_batches(source, self.batch_size), self.device,
                mesh=self.mesh):
            idx = batch["_indices"]
            out = self.forward(batch["image"], batch.get("image_alt"))
            for key, val in out.items():
                if self.mesh is not None:
                    val = gather_rows(val, self.mesh)
                val = val.cpu().numpy()[:len(idx)]
                if key not in results:
                    results[key] = np.zeros((n,) + val.shape[1:], val.dtype)
                results[key][idx] = val
        if self.index is not None and "descriptor" in results:
            scores, nbrs = self.index.search(results["descriptor"],
                                             k=self.top_k)
            results["retrieval_scores"] = scores.cpu().numpy()
            results["retrieval_indices"] = nbrs.cpu().numpy()
        return results

    def export(self, source, out_dir: str,
               filenames: Optional[list[str]] = None) -> dict[str, str]:
        """Run, then write the submission CSVs sorted as `source` is:
        `test_predictions_sorted.csv`, `test_pred.csv` and
        `retrieval_matches.csv`, for the components present (rank 0
        writes; every rank returns the paths)."""
        names = filenames or source.filenames
        results = self.run(source)
        written = (self._write(results, out_dir, names)
                   if is_writer(self.mesh) else None)
        barrier(self.mesh)
        return broadcast_object(written, self.mesh)

    def _write(self, results: dict, out_dir: str, names) -> dict:
        os.makedirs(out_dir, exist_ok=True)
        written = {}
        if "latlon" in results:
            path = os.path.join(out_dir, "test_predictions_sorted.csv")
            write_geopose_test_csv(path, names, results["latlon"])
            written["geopose"] = path
        if "angle" in results:
            path = os.path.join(out_dir, "test_pred.csv")
            write_angle_test_csv(path, names, results["angle"])
            written["angle"] = path
        if "retrieval_indices" in results:
            path = os.path.join(out_dir, "retrieval_matches.csv")
            write_retrieval_matches_csv(
                path, names, self.gallery_filenames,
                results["retrieval_indices"], results["retrieval_scores"])
            written["retrieval"] = path
        return written
