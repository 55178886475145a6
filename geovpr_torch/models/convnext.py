"""ConvNeXt backbone, serving forward (the port of `geovpr.models.convnext`,
NHWC input).

HF `ConvNextModel`: stem Conv k4/s4 + LN; per block depthwise 7x7 (padding
3) -> LN -> channel MLP (Linear 4x -> GELU -> Linear) -> LayerScale `gamma`
-> +residual (the PRE-dwconv stream); between stages LN + Conv k2/s2;
`pooled` = LN(f32 mean over positions). LayerNorm eps is 1e-6, but 1e-12 on
the pooler LN, which runs in f32 (HF `layer_norm_eps`). The stem and
downsample convs have no padding: flax's default "SAME" pads zero where the
side is a multiple of the stride, as at every supported image size.

The MLP is the port's `Mlp`, whose `gelu_fast` is tanh-approximate in bf16
and erf-exact in f32, as the JAX module's. The port has no kernel of its
own here: the convolutions are cuDNN's (the depthwise one in
`torch.channels_last` memory, so that the NHWC stream needs no copy around
it) and the MLP cuBLAS's, as the JAX package leaves them to XLA. Submodules
are named as the flax scopes (`stem`, `stem_norm`, `downsample{s}_norm`,
`downsample{s}_conv`, `stage{s}_block{b}` with `dwconv`, `norm`, `mlp`,
`gamma`; `pool_norm`).
"""

from __future__ import annotations

import torch
from torch import nn

from geovpr_torch.models.backbone import BackboneOutput
from geovpr_torch.models.layers import LayerNorm, Mlp

CONVNEXT_VARIANTS = {
    "tiny-224": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "base-224": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
}

LN_EPS = 1e-6
POOL_LN_EPS = 1e-12


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A conv on an NHWC (B, H, W, C) stream, returning NHWC."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layerscale_init: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.layerscale_init = layerscale_init
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim,
                                dtype=dtype, device=device)
        self.norm = LayerNorm(dim, LN_EPS, device=device)
        self.mlp = Mlp(dim, 4 * dim, dim, dtype=dtype, device=device)
        self.gamma = nn.Parameter(torch.empty(dim, device=device))

    def _init_weights(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.gamma.fill_(self.layerscale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mlp(self.norm(_conv_nhwc(self.dwconv, x)))
        return x + h * self.gamma.to(h.dtype)


class ConvNeXt(nn.Module):
    def __init__(self, depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.stem = nn.Conv2d(3, dims[0], 4, stride=4, **kw)
        self.stem_norm = LayerNorm(dims[0], LN_EPS, device=device)
        self.depths = tuple(depths)
        for s, depth in enumerate(depths):
            if s > 0:
                self.add_module(f"downsample{s}_norm",
                                LayerNorm(dims[s - 1], LN_EPS, device=device))
                self.add_module(f"downsample{s}_conv", nn.Conv2d(
                    dims[s - 1], dims[s], 2, stride=2, **kw))
            for b in range(depth):
                self.add_module(f"stage{s}_block{b}",
                                ConvNeXtBlock(dims[s], **kw))
        self.pool_norm = LayerNorm(dims[-1], POOL_LN_EPS, device=device)
        self.num_features = dims[-1]
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> BackboneOutput:
        """x: (B, H, W, 3) NHWC images."""
        x = self.stem_norm(_conv_nhwc(self.stem, x.to(self.dtype)))
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f"downsample{s}_norm")(x)
                x = _conv_nhwc(getattr(self, f"downsample{s}_conv"), x)
            for b in range(depth):
                x = getattr(self, f"stage{s}_block{b}")(x)
        tokens = x.reshape(x.shape[0], -1, x.shape[-1]).float()
        return BackboneOutput(pooled=self.pool_norm(tokens.mean(dim=1)),
                              tokens=tokens)
