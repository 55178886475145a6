"""Backbone + pooling + head (the serving forward of
`geovpr/train/model.py::RegressionModel`).

`pooling` picks the feature the head reads: "pooler" the backbone's
`pooled` (the mean of tokens for Swin and EfficientNet, its LayerNorm for
ConvNeXt, CLS for DINOv2), "mean" the f32
mean over the full last hidden state (CLS included for ViTs), "cls" the CLS
token; the SALAD descriptor is always the feature of `dinov2_salad`.
Submodules are `backbone` and `head`, as in the flax tree. The head holds
f32 weights and emits f32. `train=True` builds the training model
(`registry.build_backbone(train=True)`): the backbone's parameters in
f32, cast to the compute dtype in the forward.

`freeze_backbone` (the frozen-descriptor path,
`geovpr/train/model.py:58-64`) runs the backbone under `torch.no_grad()`,
JAX's `stop_gradient` on the pooled feature: that is the serving forward
(K1, and SALAD for `dinov2_salad`), since no preset gives DINOv2 a
DropPath rate. `pooled_features` and `head_only` are the two halves the
frozen-feature cache of the training loop runs apart.
"""

from __future__ import annotations

import torch
from torch import nn

from geovpr_torch.core.config import ModelConfig
from geovpr_torch.heads.regression import build_head
from geovpr_torch.models.registry import build_backbone


def feature_dim(backbone: nn.Module, family: str) -> int:
    """The head's input width: 1,280 for EfficientNet-B0, the last stage's
    width for Swin and ConvNeXt, 8,448 for the SALAD descriptor, the hidden
    size for DINOv2."""
    if family in ("swin", "efficientnet", "convnext"):
        return backbone.num_features
    if family == "dinov2_salad":
        return backbone.descriptor_dim
    return backbone.hidden_size


class RegressionModel(nn.Module):
    def __init__(self, config: ModelConfig,
                 dtype: torch.dtype = torch.float32, int8: bool = False,
                 device=None, train: bool = False):
        super().__init__()
        self.config = config
        self.backbone = build_backbone(config, dtype, int8=int8,
                                       device=device, train=train)
        self.head = build_head(config.head,
                               feature_dim(self.backbone, config.family),
                               config.out_dim, hidden=config.head_hidden,
                               dropout=config.head_dropout, device=device)

    def pool(self, out) -> torch.Tensor:
        if self.config.family == "dinov2_salad":
            return out.pooled
        if self.config.pooling == "cls" and out.cls is not None:
            return out.cls
        if self.config.pooling == "mean" and out.tokens is not None:
            tok_sum = out.tokens.float().sum(dim=1)
            n = out.tokens.shape[1]
            if out.cls is not None:
                return (tok_sum + out.cls.float()) / (n + 1)
            return tok_sum / n
        return out.pooled

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised NHWC images -> (B, out_dim) f32."""
        if self.config.freeze_backbone:
            with torch.no_grad():
                feats = self.pooled_features(images)
        else:
            feats = self.pooled_features(images)
        return self.head_only(feats)

    def pooled_features(self, images: torch.Tensor) -> torch.Tensor:
        """The feature the head reads: backbone, then the pooling."""
        return self.pool(self.backbone(images))

    def head_only(self, feats: torch.Tensor) -> torch.Tensor:
        """The head on precomputed `pooled_features`."""
        return self.head(feats)
