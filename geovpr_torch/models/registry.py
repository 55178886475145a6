"""Backbone registry: ModelConfig -> torch module (the port of
`geovpr.models.registry`)."""

from __future__ import annotations

import torch

from geovpr_torch.core.config import ModelConfig


def supports_int8(family: str) -> bool:
    """Families with a w8a8 serving path in the JAX package (its
    `supports_int8`): the ViTs and Swin quantize attention and MLPs,
    ConvNeXt its channel MLPs; EfficientNet has none (bandwidth-bound and
    BN-based, so cheaper matmul math buys nothing). The port serves all of
    them."""
    return family in ("swin", "dinov2", "dinov2_salad", "convnext")


def check_int8_serving(cfg: ModelConfig) -> None:
    """The one rule for whether the port serves `cfg` in w8a8: ValueError
    where the JAX package has no int8 path either (`supports_int8`)."""
    if not supports_int8(cfg.family):
        raise ValueError(
            f"family {cfg.family!r} has no int8 serving path "
            "(supported: swin, dinov2, dinov2_salad, convnext)")


def build_backbone(cfg: ModelConfig, dtype: torch.dtype = torch.float32, *,
                   int8: bool = False, device=None, train: bool = False):
    """`int8` builds the w8a8 serving model (to be calibrated before use),
    where `check_int8_serving` allows it and raises otherwise. `train`
    builds the training model, parameters held in f32 and cast to `dtype`
    in the forward: Swin (window 12 on the training kernels K9a-K9c,
    window 7 on JAX's XLA route), DINOv2 on K8a-K8c, DINOv2 + SALAD
    (frozen: its serving forward, K1, under no grad; unfrozen: its
    backbone on K8a-K8c and the head under autograd) and the CNNs on
    cuDNN and cuBLAS under autograd, as JAX trains them on XLA; an unknown
    family is a ValueError. `cfg.remat` recomputes each block in the
    backward for the transformer families; the CNN families take none, as
    in JAX (`geovpr/models/registry.py:27-31`, `:64-69`)."""
    family = cfg.family
    if int8:
        check_int8_serving(cfg)
    kw = dict(dtype=dtype, device=device, int8_attn=int8, int8_mlp=int8)
    pdt = torch.float32 if train else None
    if family == "efficientnet":
        from geovpr_torch.models.efficientnet import EfficientNetB0
        if cfg.variant != "b0":
            raise ValueError(f"unknown efficientnet variant {cfg.variant!r}")
        return EfficientNetB0(dtype=dtype, device=device, param_dtype=pdt)
    if family == "convnext":
        from geovpr_torch.models.convnext import CONVNEXT_VARIANTS, ConvNeXt
        if cfg.variant not in CONVNEXT_VARIANTS:
            raise ValueError(f"unknown convnext variant {cfg.variant!r}")
        return ConvNeXt(**CONVNEXT_VARIANTS[cfg.variant], dtype=dtype,
                        device=device, int8_mlp=int8, param_dtype=pdt)
    if family == "swin":
        from geovpr_torch.models.swin import SWIN_VARIANTS, SwinTransformer
        if cfg.variant not in SWIN_VARIANTS:
            raise ValueError(f"unknown swin variant {cfg.variant!r}")
        spec = SWIN_VARIANTS[cfg.variant]
        if cfg.image_size and cfg.image_size != spec["image_size"]:
            raise ValueError(
                f"swin variant {cfg.variant!r} is fixed at "
                f"{spec['image_size']}px (window partitioning); got "
                f"image_size={cfg.image_size}")
        if train:   # JAX's SwinTransformer default (`swin.py:843`)
            spec = {"drop_path_rate": 0.1, **spec}
        return SwinTransformer(**spec, **kw, param_dtype=pdt,
                               remat=cfg.remat)
    if family == "dinov2":
        from geovpr_torch.models.dinov2 import DINOV2_VARIANTS, DinoV2
        if cfg.variant not in DINOV2_VARIANTS:
            raise ValueError(f"unknown dinov2 variant {cfg.variant!r}")
        return DinoV2(**DINOV2_VARIANTS[cfg.variant],
                      image_size=cfg.image_size or 224, **kw,
                      param_dtype=pdt, remat=cfg.remat)
    if family == "dinov2_salad":
        from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
        from geovpr_torch.models.salad import DinoV2Salad
        if cfg.variant not in DINOV2_VARIANTS:
            raise ValueError(f"unknown dinov2_salad variant {cfg.variant!r}")
        return DinoV2Salad(variant=cfg.variant,
                           image_size=cfg.image_size or 224, **kw,
                           param_dtype=pdt, remat=cfg.remat)
    raise ValueError(f"unknown model family {family!r}")
