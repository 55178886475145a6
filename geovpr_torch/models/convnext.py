"""ConvNeXt backbone, serving and training forward (the port of
`geovpr.models.convnext`, NHWC input).

HF `ConvNextModel`: stem Conv k4/s4 + LN; per block depthwise 7x7 (padding
3) -> LN -> channel MLP (Linear 4x -> GELU -> Linear) -> LayerScale `gamma`
-> +residual (the PRE-dwconv stream); between stages LN + Conv k2/s2;
`pooled` = LN(f32 mean over positions). LayerNorm eps is 1e-6, but 1e-12 on
the pooler LN, which runs in f32 (HF `layer_norm_eps`). The stem and
downsample convs have no padding: flax's default "SAME" pads zero where the
side is a multiple of the stride, as at every supported image size.

The MLP is the port's `Mlp`, whose `gelu_fast` is tanh-approximate in bf16
and erf-exact in f32, as the JAX module's. The convolutions are cuDNN's
(the depthwise one in `torch.channels_last` memory, so that the NHWC
stream needs no copy around it) and the bf16 MLP cuBLAS's, as the JAX
package leaves them to XLA. The w8a8 serving model (`int8_mlp`, the
port of `Mlp(fused=..., fused_residual=x)`, `geovpr/models/convnext.py:
71-75`) runs each block's LN -> int8 MLP -> gamma -> +residual as kernel
K3 (`geovpr_torch.ops.mlp_int8.fused_mlp_block_int8`), LN's eps 1e-6
folded in and the PRE-dwconv stream as its separate `residual`; the
`Mlp`'s calibration points (`a_in`, `a_mid`) are recorded on the float
path, as for the transformers (`geovpr_torch.models.quantize`). Submodules
are named as the flax scopes (`stem`, `stem_norm`, `downsample{s}_norm`,
`downsample{s}_conv`, `stage{s}_block{b}` with `dwconv`, `norm`, `mlp`,
`gamma`; `pool_norm`).

Training (`param_dtype` f32): the stem, downsample and depthwise convs,
the MLP, the LayerNorms and `gamma` hold f32 parameters, cast to the
stream's compute dtype per call (the conv weights in channels-last
memory), so the bf16 MLP runs under autograd with `gelu_fast`'s tanh. JAX
trains ConvNeXt on XLA: its int8 `Mlp` runs only where `deterministic`
(`geovpr/models/convnext.py:71-75`), so K3 stays serving-only. Each
block's branch passes a `DropPath` at JAX's `linspace(0, drop_path_rate,
total)` rate (`:79`, `:100-101`); the registry passes no rate, as JAX's
does, so it is the identity at the presets.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from geovpr_torch.models.backbone import BackboneOutput
from geovpr_torch.models.layers import (DropPath, LayerNorm, Mlp, QuantBlock,
                                        conv2d)
from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                       mlp_block_int8_reference)

CONVNEXT_VARIANTS = {
    "tiny-224": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "base-224": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
}

LN_EPS = 1e-6
POOL_LN_EPS = 1e-12


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A conv on an NHWC (B, H, W, C) stream in the stream's dtype (the
    weight and bias cast to it), returning NHWC."""
    dt = x.dtype
    return conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt),
                  conv.bias.to(dt), conv.stride, conv.padding,
                  conv.dilation, conv.groups).permute(0, 2, 3, 1)


class ConvNeXtBlock(QuantBlock):
    """dwconv 7x7 -> LN -> channel MLP -> LayerScale `gamma` -> +residual
    (the pre-dwconv stream). `int8_mlp` selects the w8a8 MLP half (K3),
    its state the JAX "quant" entries of the block's `mlp`, folded once per
    installed state (see `QuantBlock`); `use_kernels=False` runs K3's
    plain version."""

    def __init__(self, dim: int, layerscale_init: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None,
                 int8_mlp: bool = False, drop_path: float = 0.0):
        super().__init__()
        self.layerscale_init = layerscale_init
        self.use_kernels = True
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim,
                                dtype=dtype, device=device)
        self.norm = LayerNorm(dim, LN_EPS, device=device)
        self.mlp = Mlp(dim, 4 * dim, dim, dtype=dtype, device=device,
                       int8=int8_mlp)
        self.drop_path = DropPath(drop_path)
        self.gamma = nn.Parameter(torch.empty(dim, device=device))
        self._k3: dict | None = None
        self._init_quant(dim, False, int8_mlp)

    def _init_weights(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.gamma.fill_(self.layerscale_init)

    @torch.no_grad()
    def fold_int8(self) -> None:
        """Fold the static scales into K3's arguments, with the block's
        LayerNorm and LayerScale."""
        if self.mlp.int8:
            self._k3 = self._fold("k3", self.mlp.int8_args(
                self.norm.weight, self.norm.bias, self.gamma))
            self._k3["inv_a_mid"] = float(1.0 / self.mlp.a_mid_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_nhwc(self.dwconv, x)
        if self.mlp.int8 and not self.calibrating:
            mlp = (fused_mlp_block_int8 if self.use_kernels
                   else mlp_block_int8_reference)
            return mlp(h.contiguous(), **self._folded_args(self._k3),
                       ln_eps=LN_EPS, residual=x.contiguous())
        h = self.mlp(self.norm(h))
        return x + self.drop_path(h * self.gamma.to(h.dtype))


class ConvNeXt(nn.Module):
    """`param_dtype` (f32 in a training build) holds the parameters;
    `dtype` is the compute dtype of the stream."""

    def __init__(self, depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
                 dtype: torch.dtype = torch.float32, device=None,
                 int8_mlp: bool = False, drop_path_rate: float = 0.0,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=param_dtype or dtype, device=device)
        rates = np.linspace(0, drop_path_rate, sum(depths))
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
                self.add_module(f"stage{s}_block{b}", ConvNeXtBlock(
                    dims[s], **kw, int8_mlp=int8_mlp,
                    drop_path=float(rates[sum(depths[:s]) + b])))
        self.pool_norm = LayerNorm(dims[-1], POOL_LN_EPS, device=device)
        self.num_features = dims[-1]
        self.to(memory_format=torch.channels_last)

    @property
    def blocks(self) -> list[nn.Module]:
        """Every block, in order (the modules whose `use_kernels` selects
        kernel or plain path)."""
        return [getattr(self, f"stage{s}_block{b}")
                for s, depth in enumerate(self.depths)
                for b in range(depth)]

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
