"""EfficientNet-B0 backbone, serving and training forward (the port of
`geovpr.models.efficientnet`, NHWC input).

torchvision `efficientnet_b0`: stem Conv3x3/s2 -> 7 MBConv stages (1x1
expand, depthwise, squeeze-excite 0.25 of the block's input channels, 1x1
project, residual where stride 1 and the width is kept) -> head Conv1x1 to
1280 -> `pooled`, the f32 mean over positions. Stochastic depth (a
`DropPath` on each residual block's branch, the rate 0.2 i / 16 for
block i, as `geovpr/models/efficientnet.py:117-119`, `:137-147`)
draws only in training mode and is the identity at serving.

Numerics follow the JAX module: every conv runs in the compute dtype on
its input cast to it; each BatchNorm (eps 1e-3, running statistics) runs
in f32 and SiLU on that f32, so the stream between convs and between
blocks is f32 (`ConvBNAct`). The port has no kernel of its own here: the
convolutions are cuDNN's, as the JAX package leaves them to XLA. Inside,
the stream is NCHW-shaped in `torch.channels_last` memory, the NHWC layout
cuDNN serves bf16 convolutions best in (and the input's own, so the entry
permute is free).

Training (`param_dtype` f32, the model in training mode): every conv
weight is held in f32 and cast to the compute dtype per call, in the same
channels-last memory; each BatchNorm normalizes with the batch's
statistics and moves its running ones as flax does (`layers.BatchNorm`),
so the training step carries them as JAX's `batch_stats`.

Submodules are named as the flax scopes (`stem`, `stage{s}_block{b}` with
`expand`, `dw`, `se`, `project`, `head`; each `conv`, `bn`), so the weight
bridge maps the trees one to one.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from geovpr_torch.models.backbone import BackboneOutput
from geovpr_torch.models.layers import ConvBNAct, DropPath, SqueezeExcite


@dataclasses.dataclass(frozen=True)
class MBConvSpec:
    expand_ratio: int
    kernel: int
    stride: int
    in_ch: int
    out_ch: int
    layers: int


# torchvision efficientnet_b0 inverted-residual setting
B0_STAGES: Sequence[MBConvSpec] = (
    MBConvSpec(1, 3, 1, 32, 16, 1),
    MBConvSpec(6, 3, 2, 16, 24, 2),
    MBConvSpec(6, 5, 2, 24, 40, 2),
    MBConvSpec(6, 3, 2, 40, 80, 3),
    MBConvSpec(6, 5, 1, 80, 112, 3),
    MBConvSpec(6, 5, 2, 112, 192, 4),
    MBConvSpec(6, 3, 1, 192, 320, 1),
)

BN_EPS = 1e-3  # torchvision EfficientNet's BatchNorm eps
STOCHASTIC_DEPTH = 0.2  # JAX's EfficientNetB0 default, every preset's


class MBConv(nn.Module):
    def __init__(self, spec: MBConvSpec, stride: int, in_ch: int,
                 conv_padding: str = "torch",
                 dtype: torch.dtype = torch.float32, device=None,
                 drop_path: float = 0.0,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(bn_eps=BN_EPS, dtype=dtype, device=device,
                  param_dtype=param_dtype)
        expanded = in_ch * spec.expand_ratio
        self.expand = (ConvBNAct(in_ch, expanded, 1, **kw)
                       if spec.expand_ratio != 1 else None)
        self.dw = ConvBNAct(expanded, expanded, spec.kernel, stride,
                            groups=expanded, conv_padding=conv_padding, **kw)
        # torchvision's squeeze width: the block's INPUT channels / 4
        self.se = SqueezeExcite(expanded, max(1, in_ch // 4), dtype=dtype,
                                device=device, param_dtype=param_dtype)
        self.project = ConvBNAct(expanded, spec.out_ch, 1, use_act=False,
                                 **kw)
        self.residual = stride == 1 and in_ch == spec.out_ch
        # only a residual block has a branch to drop (JAX creates no
        # DropPath elsewhere, so draws line up block for block)
        self.drop_path = DropPath(drop_path) if self.residual else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.expand is None else self.expand(x)
        h = self.project(self.se(self.dw(h)))
        return self.drop_path(h) + x if self.residual else h


class EfficientNetB0(nn.Module):
    """NHWC images -> (B, 1280) pooled features (f32) and the head's
    (B, h*w, 1280) f32 map as `tokens`. `param_dtype` (f32 in a training
    build) holds the conv weights; `dtype` is the compute dtype."""

    def __init__(self, conv_padding: str = "torch",
                 dtype: torch.dtype = torch.float32, device=None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.stem = ConvBNAct(3, 32, 3, stride=2, conv_padding=conv_padding,
                              bn_eps=BN_EPS, **kw)
        self.layers: list[str] = []
        total = sum(spec.layers for spec in B0_STAGES)
        for s, spec in enumerate(B0_STAGES):
            for i in range(spec.layers):
                name = f"stage{s}_block{i}"
                self.add_module(name, MBConv(
                    spec, spec.stride if i == 0 else 1,
                    spec.in_ch if i == 0 else spec.out_ch, conv_padding,
                    drop_path=STOCHASTIC_DEPTH * len(self.layers) / total,
                    **kw))
                self.layers.append(name)
        self.head = ConvBNAct(B0_STAGES[-1].out_ch, 1280, 1, bn_eps=BN_EPS,
                              **kw)
        self.num_features = 1280
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> BackboneOutput:
        """x: (B, H, W, 3) NHWC images."""
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.stem(x)
        for name in self.layers:
            x = getattr(self, name)(x)
        x = self.head(x)                                  # f32
        tokens = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])
        return BackboneOutput(pooled=tokens.mean(dim=1), tokens=tokens)
