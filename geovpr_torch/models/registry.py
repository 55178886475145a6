"""Backbone registry: ModelConfig -> torch module (the port of
`geovpr.models.registry` for the families the port serves: swin, dinov2,
dinov2_salad; efficientnet and convnext come with the angle-head slice)."""

from __future__ import annotations

import torch

from geovpr_torch.core.config import ModelConfig

NOT_PORTED = ("efficientnet", "convnext")


def build_backbone(cfg: ModelConfig, dtype: torch.dtype = torch.float32, *,
                   int8: bool = False, device=None):
    """Every family the port builds has a w8a8 serving path (`int8`)."""
    family = cfg.family
    if family in NOT_PORTED:
        raise NotImplementedError(
            f"model family {family!r} is not ported yet (ROADMAP Queue 1 "
            "item 8, the angle heads)")
    kw = dict(dtype=dtype, device=device, int8_attn=int8, int8_mlp=int8)
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
        return SwinTransformer(**spec, **kw)
    if family == "dinov2":
        from geovpr_torch.models.dinov2 import DINOV2_VARIANTS, DinoV2
        if cfg.variant not in DINOV2_VARIANTS:
            raise ValueError(f"unknown dinov2 variant {cfg.variant!r}")
        return DinoV2(**DINOV2_VARIANTS[cfg.variant],
                      image_size=cfg.image_size or 224, **kw)
    if family == "dinov2_salad":
        from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
        from geovpr_torch.models.salad import DinoV2Salad
        if cfg.variant not in DINOV2_VARIANTS:
            raise ValueError(f"unknown dinov2_salad variant {cfg.variant!r}")
        return DinoV2Salad(variant=cfg.variant,
                           image_size=cfg.image_size or 224, **kw)
    raise ValueError(f"unknown model family {family!r}")
