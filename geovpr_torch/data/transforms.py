"""Device-side image transforms (the port of `geovpr.data.transforms`):
`normalize` and the training augmentations on [0, 1] NHWC float images.

Each augmentation is a *draw* (crop boxes, flip decisions, jitter factors,
angles, noise), taken from an explicit `torch.Generator`, and a *pixel
function* of those draws, so that a test can feed the JAX package's draws
to the pixel functions (JAX's threefry and torch's generators never give
the same numbers). Bilinear resampling matches
`jax.scipy.ndimage.map_coordinates(order=1)`: four corners, summed in its
order, out-of-range corners clamped (`nearest`) or counted as 0
(`constant`). `build_augment` gives the pipelines `geo_light` (crop, flip,
jitter; `swin_finetuning_2.py:78-82`) and `geo_heavy` (flip, jitter,
rotate 15, Gaussian noise; `swin_attempt_3.py:60-69`) and `angle_rot`
(rotate 45, affine zoom and shift, jitter; `dino_v2_gemini.py:57-62`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """uint8/float images (B, H, W, 3) -> normalised float32."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def bilinear_sample(images: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                    mode: str) -> torch.Tensor:
    """images (B, H, W, C) sampled at (sy, sx) (B, Ho, Wo) with
    `map_coordinates(order=1)`'s arithmetic, per channel; mode "nearest"
    or "constant" (cval 0)."""
    b, h, w, c = images.shape
    flat = images.reshape(b, h * w, c)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    out = None
    for yi, wy in ((y0, 1.0 - wy1), (y0 + 1, wy1)):
        for xi, wx in ((x0, 1.0 - wx1), (x0 + 1, wx1)):
            yc = yi.clamp(0, h - 1).long()
            xc = xi.clamp(0, w - 1).long()
            idx = (yc * w + xc).reshape(b, -1, 1).expand(-1, -1, c)
            v = torch.gather(flat, 1, idx).reshape(*sy.shape, c)
            if mode == "constant":
                valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                v = torch.where(valid[..., None], v, torch.zeros_like(v))
            elif mode != "nearest":
                raise ValueError(f"unknown mode {mode!r}")
            term = (wy * wx)[..., None] * v
            out = term if out is None else out + term
    return out


# ------------------------------------------------------- resized crop --

def draw_resized_crop(gen: torch.Generator, batch: int,
                      scale=(0.8, 1.0), ratio=(0.9, 1.1),
                      device=None) -> dict:
    """Per image: area fraction, aspect ratio, and the crop's offsets as
    uniform [0, 1) fractions of the free room."""
    return dict(area=_uniform(gen, (batch,), *scale, device),
                aspect=_uniform(gen, (batch,), *ratio, device),
                yu=_uniform(gen, (batch,), 0.0, 1.0, device),
                xu=_uniform(gen, (batch,), 0.0, 1.0, device))


def resized_crop(images, area, aspect, yu, xu) -> torch.Tensor:
    """Crop each image to its box and resize back to (H, W), bilinear with
    edge clamping (torchvision RandomResizedCrop analog)."""
    b, h, w, _ = images.shape
    ch = torch.clamp(torch.sqrt(area / aspect) * h, 1.0, h)
    cw = torch.clamp(torch.sqrt(area * aspect) * w, 1.0, w)
    y0, x0 = yu * (h - ch), xu * (w - cw)
    yy = torch.linspace(0.0, 1.0, h, device=images.device)
    xx = torch.linspace(0.0, 1.0, w, device=images.device)
    sy = (y0[:, None] + yy[None] * (ch[:, None] - 1.0))[:, :, None]
    sx = (x0[:, None] + xx[None] * (cw[:, None] - 1.0))[:, None, :]
    return bilinear_sample(images, sy.expand(b, h, w), sx.expand(b, h, w),
                           "nearest")


# --------------------------------------------------------------- flip --

def draw_flip(gen, batch: int, p: float = 0.5, device=None) -> torch.Tensor:
    return torch.rand((batch,), generator=gen, device=device) < p


def flip(images, flipped) -> torch.Tensor:
    """Horizontal flip of the images where `flipped` (B,) is true."""
    return torch.where(flipped[:, None, None, None],
                       torch.flip(images, dims=(2,)), images)


# ------------------------------------------------------------- jitter --

def draw_jitter(gen, batch: int, brightness=0.2, contrast=0.2,
                saturation=0.2, device=None) -> dict:
    return {k: _uniform(gen, (batch,), 1.0 - s, 1.0 + s, device)
            for k, s in (("brightness", brightness), ("contrast", contrast),
                         ("saturation", saturation))}


def color_jitter(images, brightness, contrast, saturation) -> torch.Tensor:
    """Brightness, contrast, saturation in JAX's order: scale; blend with
    the image's mean; blend with the channel-mean gray (Queue 3)."""
    def f(v):
        return v[:, None, None, None]

    x = images * f(brightness)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * f(contrast) + mean
    gray = x.mean(dim=-1, keepdim=True)
    return (x - gray) * f(saturation) + gray


# ------------------------------------------------------------- rotate --

def draw_rotate(gen, batch: int, max_degrees: float = 15.0,
                device=None) -> torch.Tensor:
    """Angles in radians, uniform in +-max_degrees."""
    return _uniform(gen, (batch,), -max_degrees, max_degrees,
                    device) * (math.pi / 180.0)


def rotate(images, angles) -> torch.Tensor:
    """Rotation of each image about its centre, bilinear, zero fill."""
    b, h, w, _ = images.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=images.device),
        torch.arange(w, dtype=torch.float32, device=images.device),
        indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(angles)[:, None, None], torch.sin(angles)[:, None,
                                                                    None]
    sy = cy + (yy - cy) * cos - (xx - cx) * sin
    sx = cx + (yy - cy) * sin + (xx - cx) * cos
    return bilinear_sample(images, sy, sx, "constant")


# ------------------------------------------------------------- affine --

def draw_affine(gen, batch: int, height: int, width: int,
                translate=(0.1, 0.1), scale=(0.9, 1.1),
                device=None) -> dict:
    """Per image: the zoom s and the shift in pixels, tx up to
    translate[0] * width and ty up to translate[1] * height, in
    `random_affine`'s order (`geovpr/data/transforms.py:155-187`)."""
    return dict(s=_uniform(gen, (batch,), *scale, device),
                tx=_uniform(gen, (batch,), -translate[0], translate[0],
                            device) * width,
                ty=_uniform(gen, (batch,), -translate[1], translate[1],
                            device) * height)


def affine(images, s, tx, ty) -> torch.Tensor:
    """torchvision RandomAffine(degrees=0) analog: each output pixel read
    from its source by the inverse map about the centre ((h-1)/2,
    (w-1)/2), shift then unzoom, bilinear, zero fill."""
    b, h, w, _ = images.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=images.device),
        torch.arange(w, dtype=torch.float32, device=images.device),
        indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    s, tx, ty = s[:, None, None], tx[:, None, None], ty[:, None, None]
    sy = cy + (yy - cy - ty) / s
    sx = cx + (xx - cx - tx) / s
    return bilinear_sample(images, sy, sx, "constant")


# ---------------------------------------------------------- gauss noise --

def draw_gauss_noise(gen, shape, var_range=(10.0, 50.0), p: float = 0.2,
                     device=None) -> dict:
    """Per image: whether noise applies and its variance on the 0-255
    scale; the standard-normal noise of every pixel."""
    b = shape[0]
    return dict(apply=torch.rand((b,), generator=gen, device=device) < p,
                var=_uniform(gen, (b,), *var_range, device),
                noise=torch.randn(shape, generator=gen, device=device))


def gauss_noise(images, apply, var, noise) -> torch.Tensor:
    """albumentations GaussNoise analog: + noise * sqrt(var) / 255, clipped
    to [0, 1], on the images where `apply` is true."""
    std01 = torch.sqrt(var) / 255.0
    noisy = torch.clamp(images + noise * std01[:, None, None, None], 0.0, 1.0)
    return torch.where(apply[:, None, None, None], noisy, images)


def _global_draws(b: int, rows):
    """(draw size, take): with `rows` = (offset, global batch) the draws
    cover the global batch and `take` keeps this rank's b rows of each,
    so a data-parallel step draws what one process would; else b and the
    identity."""
    if rows is None:
        return b, lambda d: d
    offset, n = rows

    def take(d):
        if isinstance(d, dict):
            return {k: v[offset:offset + b] for k, v in d.items()}
        return d[offset:offset + b]
    return n, take


def build_augment(name: str):
    """The pipeline of `DataConfig.augment`: fn(gen, images, rows=None) ->
    (images, flipped (B,) bool), on [0, 1] float images; `rows` places a
    rank's rows in the global batch (`_global_draws`)."""
    if name == "none":
        return lambda gen, images, rows=None: (images, torch.zeros(
            images.shape[0], dtype=torch.bool, device=images.device))

    def light(gen, images, rows=None):
        b, dev = images.shape[0], images.device
        n, take = _global_draws(b, rows)
        x = resized_crop(images, **take(draw_resized_crop(gen, n,
                                                          device=dev)))
        flipped = take(draw_flip(gen, n, device=dev))
        x = flip(x, flipped)
        return color_jitter(x, **take(draw_jitter(gen, n, device=dev))), \
            flipped

    def heavy(gen, images, rows=None):
        b, dev = images.shape[0], images.device
        n, take = _global_draws(b, rows)
        flipped = take(draw_flip(gen, n, device=dev))
        x = color_jitter(flip(images, flipped),
                         **take(draw_jitter(gen, n, device=dev)))
        x = rotate(x, take(draw_rotate(gen, n, 15.0, device=dev)))
        # the per-pixel noise too is drawn over the global batch
        return gauss_noise(x, **take(draw_gauss_noise(
            gen, (n,) + tuple(x.shape[1:]), device=dev))), flipped

    def rot(gen, images, rows=None):
        # the image rotation does not remap the heading target, as in JAX
        # (a turn about the optical axis changes roll, not heading)
        b, h, w, _ = images.shape
        dev = images.device
        n, take = _global_draws(b, rows)
        x = rotate(images, take(draw_rotate(gen, n, 45.0, device=dev)))
        x = affine(x, **take(draw_affine(gen, n, h, w, device=dev)))
        return color_jitter(x, **take(draw_jitter(gen, n, device=dev))), \
            torch.zeros(b, dtype=torch.bool, device=dev)

    pipelines = {"geo_light": light, "geo_heavy": heavy, "angle_rot": rot}
    if name in pipelines:
        return pipelines[name]
    raise ValueError(f"unknown augment pipeline {name!r}")
