"""Swin Transformer backbone, serving and training forward (the port of
`geovpr.models.swin`, NHWC input).

Architecture (HF `SwinModel`): patch embed conv k4/s4 -> LayerNorm; per
block LN -> window MSA (relative-position bias from the (2w-1)^2 table,
additive -100 mask on shifted windows) -> +residual -> LN -> MLP(4x GELU)
-> +residual, with shift = window//2 on odd blocks of a stage (none where
the stage is one window wide); PatchMerging between stages; final LN;
`pooled` = f32 mean over tokens. LayerNorm eps is 1e-5 throughout
(`swin.py:52`), not DINOv2's 1e-6.

Layout: the token stream stays in raster (B, L, C) order from the patch
embed to the final LN. The JAX package keeps it window-partitioned across
a stage (`repartition`, `merge_gather`) or in its "alternating" rolled
layout, both built for Mosaic and VMEM; here the window partition and the
cyclic shift are the attention kernel's row addressing (K4/K5,
`geovpr_torch/csrc/swin_attn.cu`; K7's raster mode at window 7,
`csrc/window_attn.cu`), and the stage boundary reads the 2x2
neighbours from raster rows (K6, `csrc/patch_merge.cu`). No relayout copy
runs on the serving path.

Each block's attention half is one call of
`geovpr_torch.ops.swin_block.fused_swin_attn_block` (K4 on CUDA tensors)
where the window holds a multiple of 16 tokens (window 12); at window 7
(N = 49, Swin-T-224) it is the JAX package's unfused half, LN and the q/k/v
and out projections as torch ops around
`geovpr_torch.ops.window_attention.window_attention_raster` (K7, which reads
the windows out of the raster qkv and writes the context back in raster
order), as JAX runs `window_attention_pallas` there (`fused_window_ok`). On the w8a8 path
(`int8_attn`, `int8_mlp`) the attention half is
`fused_swin_attn_block_int8` (K5) at window 12 and
`swin_attn_block_int8_unfused` at window 7 (torch ops: int8 q.k^T scores,
the f32 softmax, P.V on bf16 P, the int8 projections, as JAX runs its XLA
fallback there), and the MLP half, LN included, is
`geovpr_torch.ops.mlp_int8.fused_mlp_block_int8` (K3, no LayerScale, so
gamma = ones) at both windows. Every boundary is
`geovpr_torch.ops.patch_merge.fused_patch_merge` (K6). `use_kernels=False` selects the plain versions on
any device. The patch-embed conv, the bf16 MLP half and the LayerNorms
outside the kernels are plain torch ops, as the JAX package leaves them to
XLA. Calibration (`calib` dicts, set by `geovpr_torch.models.quantize`)
runs the unfused float attention, as the JAX calibration pass does.

Training (grad enabled, window 12): each block's attention half is
`geovpr_torch.ops.swin_block.fused_swin_attn_train` (K9a forward, K9c or
K9b backward), y = proj(W-MSA(LN(x))) with the residual and DropPath added
outside, as JAX's train path does (`swin.py:554-558`); the MLP half and
the LayerNorms are torch ops under autograd, and the stage boundaries run
the plain PatchMerging (JAX trains on XLA's LN + Dense there; K6 is
forward only). `remat` recomputes each block's activations in the
backward (`layers.remat_call`, JAX's `nn.remat` on `SwinBlock`,
`swin.py:878`; not the boundaries), so K9a runs once more a block a step.
DropPath rates rise linearly from 0 to `drop_path_rate`
over the blocks (`swin.py:875`); the training build passes JAX's 0.1
(`swin.py:843`), a serving build has none. A training build holds its
parameters in `param_dtype` (f32) and casts them to the compute dtype in
the forward, as flax keeps f32 params and computes in `dtype`; a serving
build has `param_dtype = dtype`, so its casts are no-ops.

Training at window 7 (grad enabled, Swin-T-224) takes JAX's route there:
JAX's `SwinBlock` keeps its window kernel for the deterministic forward
(`pallas_ok`, `geovpr/models/swin.py:389-391`) and trains on the unfused
XLA half (`_window_attn_apply`, `:299-328`). Here that is
`swin_attn_block_unfused` with `window_attention` (scaled scores, the
max-shifted softmax) on the gathered windows, returning the branch, and
`x + DropPath(branch)` with the mask drawn per image (`residual_drop`,
`:441-451`): torch ops under autograd, no K7 launch. Validation keeps K7's
raster entry and K6.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from geovpr_torch.models.backbone import BackboneOutput
from geovpr_torch.models.layers import (DropPath, LayerNorm, Mlp, QuantBlock,
                                        conv2d, lecun_normal_, remat_call)
from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                       mlp_block_int8_reference)
from geovpr_torch.ops.patch_merge import (fused_patch_merge,
                                          patch_merge_reference)
from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                         fused_swin_attn_block_int8,
                                         fused_swin_attn_train,
                                         fused_window_ok,
                                         swin_attn_block_int8_reference,
                                         swin_attn_block_int8_unfused,
                                         swin_attn_block_reference,
                                         swin_attn_block_unfused)
from geovpr_torch.ops.window_attention import (  # noqa: F401 (re-exported)
    relative_position_index, shifted_window_labels, shifted_window_mask,
    window_attention_raster, window_attention_raster_reference,
    window_partition, window_reverse)

SWIN_VARIANTS = {
    "tiny-224": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                     window_size=7, image_size=224),
    "base-224": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                     window_size=7, image_size=224),
    "base-384": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                     window_size=12, image_size=384),
}

LN_EPS = 1e-5


class SwinAttention(nn.Module):
    """Parameters of the attention half: qkv_weight (C, 3C) with q|k|v
    column blocks and proj_weight (C, C), (in, out) in the compute dtype;
    f32 biases; the f32 relative-position bias table ((2w-1)^2, H), zeros
    at init as in JAX."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.qkv_weight = nn.Parameter(
            torch.empty(dim, 3 * dim, dtype=dtype, device=device))
        self.qkv_bias = nn.Parameter(torch.empty(3 * dim, device=device))
        self.proj_weight = nn.Parameter(
            torch.empty(dim, dim, dtype=dtype, device=device))
        self.proj_bias = nn.Parameter(torch.empty(dim, device=device))
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads, device=device))

    def _init_weights(self, generator: torch.Generator) -> None:
        d = self.proj_weight.shape[0]
        lecun_normal_(self.qkv_weight, d, generator)
        lecun_normal_(self.proj_weight, d, generator)
        with torch.no_grad():
            self.qkv_bias.zero_()
            self.proj_bias.zero_()
            self.relative_position_bias_table.zero_()


class SwinBlock(QuantBlock):
    """One Swin block on the raster (B, L, C) stream of a stage of side
    `resolution`. `int8_attn` / `int8_mlp` select the w8a8 halves (K5 / K3),
    their state the JAX "quant" collection's entries of this block, folded
    once per installed state (see `QuantBlock`)."""

    def __init__(self, dim: int, num_heads: int, resolution: int,
                 window: int, shift: int, use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 int8_attn: bool = False, int8_mlp: bool = False,
                 drop_path: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.resolution, self.window, self.shift = resolution, window, shift
        self.use_kernels = use_kernels
        self.drop_path = DropPath(drop_path)
        self.norm1 = LayerNorm(dim, LN_EPS, device=device)
        self.attn = SwinAttention(dim, num_heads, window, dtype, device)
        self.norm2 = LayerNorm(dim, LN_EPS, device=device)
        self.mlp = Mlp(dim, 4 * dim, dtype=dtype, device=device,
                       int8=int8_mlp)
        self._k5: dict | None = None
        self._k3: dict | None = None
        self._init_quant(dim, int8_attn, int8_mlp)

    @torch.no_grad()
    def fold_int8(self) -> None:
        """Fold the static scales into K5's and K3's arguments (no
        LayerScale: K3's gamma is ones)."""
        if self.int8_attn:
            self._k5 = self._fold("k5", self._attn_int8_fold(False))
        if self.mlp.int8:
            self._k3 = self._fold("k3", self.mlp.int8_args(
                self.norm2.weight, self.norm2.bias,
                torch.ones_like(self.norm2.weight)))
            self._k3["inv_a_mid"] = float(1.0 / self.mlp.a_mid_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        geom = dict(num_heads=self.num_heads, resolution=self.resolution,
                    window=self.window, shift=self.shift, ln_eps=LN_EPS)
        table = self.attn.relative_position_bias_table
        calibrating = self.calibrating
        if self.int8_attn and not calibrating:
            args = dict(self._folded_args(self._k5), table=table, **geom)
            if not fused_window_ok(self.window):
                x = swin_attn_block_int8_unfused(x, **args)
            else:
                x = self._int8_attention(
                    fused_swin_attn_block_int8 if self.use_kernels
                    else swin_attn_block_int8_reference, x, **args)
        else:
            dt = x.dtype
            args = (x, self.norm1.weight, self.norm1.bias,
                    self.attn.qkv_weight.to(dt), self.attn.qkv_bias,
                    self.attn.proj_weight.to(dt), self.attn.proj_bias, table)
            if calibrating:
                x = swin_attn_block_unfused(*args, **geom, calib=self.calib)
            elif torch.is_grad_enabled() and fused_window_ok(self.window):
                x = x + self.drop_path(fused_swin_attn_train(
                    *args, **geom, kernels=self.use_kernels))
            elif torch.is_grad_enabled():
                x = x + self.drop_path(swin_attn_block_unfused(
                    *args, **geom, residual=False))
            elif fused_window_ok(self.window):
                attn = (fused_swin_attn_block if self.use_kernels
                        else swin_attn_block_reference)
                x = attn(*args, **geom)
            else:
                x = swin_attn_block_unfused(*args, **geom, attention=(
                    window_attention_raster if self.use_kernels
                    else window_attention_raster_reference))
        if self.mlp.int8 and not calibrating:
            mlp = (fused_mlp_block_int8 if self.use_kernels
                   else mlp_block_int8_reference)
            return mlp(x, **self._folded_args(self._k3), ln_eps=LN_EPS)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """Swin downsample: 2x2 concat [x00, x10, x01, x11] -> LN(4C) ->
    Linear(4C -> 2C, no bias); the reduction weight is held (in, out),
    (4C, 2C), as K6 takes it."""

    def __init__(self, dim: int, resolution: int, use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.resolution = resolution
        self.use_kernels = use_kernels
        self.norm = LayerNorm(4 * dim, LN_EPS, device=device)
        self.reduction_weight = nn.Parameter(
            torch.empty(4 * dim, 2 * dim, dtype=dtype, device=device))

    def _init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.reduction_weight, self.reduction_weight.shape[0],
                      generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """K6 on the serving path; the plain version under grad (K6 is
        forward only, and JAX trains on XLA's LN + Dense here)."""
        merge = (fused_patch_merge if self.use_kernels
                 and not torch.is_grad_enabled() else patch_merge_reference)
        return merge(x, self.norm.weight, self.norm.bias,
                     self.reduction_weight.to(x.dtype), self.resolution,
                     LN_EPS)


class SwinTransformer(nn.Module):
    """Submodules are named as the flax scopes (`patch_embed`,
    `embed_norm`, `stage{s}_block{b}`, `stage{s}_downsample`, `norm`), so
    the weight bridge maps the trees one to one."""

    def __init__(self, embed_dim: int = 128, depths=(2, 2, 18, 2),
                 num_heads=(4, 8, 16, 32), window_size: int = 12,
                 image_size: int = 384, patch_size: int = 4,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 int8_attn: bool = False, int8_mlp: bool = False,
                 drop_path_rate: float = 0.0,
                 param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        pdt = param_dtype or dtype
        res = image_size // patch_size
        if res % window_size:
            raise ValueError(
                f"patch grid {res} not divisible by window {window_size}")
        self.patch_size = patch_size
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size,
                                     stride=patch_size, dtype=pdt,
                                     device=device)
        self.embed_norm = LayerNorm(embed_dim, LN_EPS, device=device)
        self.layers: list[str] = []
        dprates = np.linspace(0, drop_path_rate, sum(depths))
        dim = embed_dim
        for s, depth in enumerate(depths):
            win = min(window_size, res)
            for i in range(depth):
                shift = 0 if i % 2 == 0 or res <= window_size \
                    else window_size // 2
                name = f"stage{s}_block{i}"
                self.add_module(name, SwinBlock(
                    dim, num_heads[s], res, win, shift, use_kernels, pdt,
                    device, int8_attn=int8_attn, int8_mlp=int8_mlp,
                    drop_path=float(dprates[sum(depths[:s]) + i])))
                self.layers.append(name)
            if s < len(depths) - 1:
                name = f"stage{s}_downsample"
                self.add_module(name, PatchMerging(dim, res, use_kernels,
                                                   pdt, device))
                self.layers.append(name)
                dim *= 2
                res //= 2
        self.norm = LayerNorm(dim, LN_EPS, device=device)
        self.num_features = dim

    @property
    def blocks(self) -> list[nn.Module]:
        """Every block and boundary with a kernel, in order (the modules
        whose `use_kernels` selects kernel or plain path)."""
        return [getattr(self, n) for n in self.layers]

    def forward(self, x: torch.Tensor) -> BackboneOutput:
        """x: (B, H, W, 3) NHWC images."""
        conv, dt = self.patch_embed, self.dtype
        x = conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt),
                   conv.bias.to(dt), stride=self.patch_size)
        x = self.embed_norm(x.flatten(2).transpose(1, 2).contiguous())
        remat = self.remat and torch.is_grad_enabled()
        for name in self.layers:
            layer = getattr(self, name)
            x = (remat_call(layer, x) if remat and isinstance(layer, SwinBlock)
                 else layer(x))
        tokens = self.norm(x).float()
        return BackboneOutput(pooled=tokens.mean(dim=1), tokens=tokens)
