"""DINOv2 ViT backbone (the port of `geovpr.models.dinov2`, NHWC input).

Per layer: LN(eps 1e-6) -> MHSA -> out proj -> LayerScale -> +res, then
LN -> MLP(4x GELU) -> LayerScale -> +res; final LN; `pooled` = CLS token.

The attention half of every block is one call of
`geovpr_torch.ops.mhsa.fused_mhsa_block` (kernel K1 on CUDA tensors); on
the w8a8 serving path (`int8_attn`, `int8_mlp`) the attention half is
`fused_mhsa_block_int8` (K2) and the whole MLP half, LN included, is
`geovpr_torch.ops.mlp_int8.fused_mlp_block_int8` (K3). `use_kernels=False`
selects the plain versions on any device, as `use_pallas=False` does in
JAX. The patch-embed conv and the bf16 MLP half are plain torch ops, as the
JAX package leaves them to XLA. Matrices are held in `param_dtype` (q|k|v
fused into one (D, 3D) weight once, at load) and cast to the compute dtype
in the forward, LayerNorm, attention-bias and LayerScale vectors in f32.

Training (grad enabled) routes the attention half as JAX does
(`geovpr/models/dinov2.py:158-172`): with DropPath inert (rate 0, or the
module in eval mode) it is `fused_mhsa_block_train` (K8a forward; K8c
backward, or K8b where the f32 weight-gradient accumulators fail JAX's
size gate `bwd_all_ok`, as at large-14, D = 1024); with a DropPath rate in
training mode it is JAX's XLA route, `mhsa_attention_unfused` as torch
ops, LayerScale, DropPath and the residual. The MLP half stays torch ops under autograd, with DropPath on its
branch, as JAX leaves it to XLA. DropPath has one rate in every block,
`drop_path_rate` (JAX's default 0, `dinov2.py:402`, which every preset
keeps). A training build holds its parameters in f32 (`param_dtype`), as
Swin's does; a serving build has `param_dtype = dtype`, so its casts are
no-ops.

`remat` recomputes each block's activations in the backward
(`layers.remat_call`, JAX's `nn.remat` per block, `dinov2.py:467`): the
block's K8a launches run once more in each training step.

Not ported: resident padding (`geovpr/models/dinov2.py:437-480`), which
pads the token stream to the TPU's 16-row sublane quantum across the block
stack so that the per-layer pad/slice copies around the Mosaic kernel
vanish. K1-K3 mask keys past N inside the kernel and take any row count,
so those copies never exist here.
"""

from __future__ import annotations

import torch
from torch import nn

from geovpr_torch.models.backbone import BackboneOutput
from geovpr_torch.models.layers import (DropPath, LayerNorm, Mlp,
                                        QuantBlock, conv2d, lecun_normal_,
                                        normal_, remat_call)
from geovpr_torch.ops.mhsa import (fused_mhsa_block, fused_mhsa_block_int8,
                                   fused_mhsa_block_train,
                                   mhsa_attention_unfused,
                                   mhsa_block_int8_reference,
                                   mhsa_block_reference)
from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                       mlp_block_int8_reference)

DINOV2_VARIANTS = {
    "small-14": dict(hidden_size=384, num_layers=12, num_heads=6),
    "base-14": dict(hidden_size=768, num_layers=12, num_heads=12),
    "large-14": dict(hidden_size=1024, num_layers=24, num_heads=16),
}

LN_EPS = 1e-6


class Attention(nn.Module):
    """Parameters of the attention half: qkv_weight (D, 3D) with q|k|v
    column blocks and proj_weight (D, D), both (in, out) as the kernel takes
    them, in the parameter dtype; f32 biases."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.qkv_weight = nn.Parameter(
            torch.empty(dim, 3 * dim, dtype=dtype, device=device))
        self.qkv_bias = nn.Parameter(torch.empty(3 * dim, device=device))
        self.proj_weight = nn.Parameter(
            torch.empty(dim, dim, dtype=dtype, device=device))
        self.proj_bias = nn.Parameter(torch.empty(dim, device=device))

    def _init_weights(self, generator: torch.Generator) -> None:
        d = self.proj_weight.shape[0]
        # q, k and v are three (D, D) Dense kernels in JAX, each lecun-normal
        # with fan-in D: the fused weight draws the same distribution
        lecun_normal_(self.qkv_weight, d, generator)
        lecun_normal_(self.proj_weight, d, generator)
        with torch.no_grad():
            self.qkv_bias.zero_()
            self.proj_bias.zero_()


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1.0, device=None):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.empty(dim, device=device))

    def _init_weights(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.gamma.fill_(self.init_value)


class DinoV2Block(QuantBlock):
    """One pre-LN ViT block. `int8_attn` / `int8_mlp` select the w8a8
    serving halves (K2 / K3 on CUDA tensors, their plain versions on the
    CPU or with `use_kernels=False`); their state is the JAX "quant"
    collection's entries of this block (`attn_*` buffers here, the MLP's
    on `self.mlp`), folded into the kernels' arguments once, whenever it
    is installed (`load_state_dict`, `geovpr_torch.models.quantize`).
    With `calib` set to a dict the block runs the float plain path and
    records the attention amaxes (`attn_x`, `attn_q`, `attn_k`, `attn_v`,
    `attn_ctx`) there, as JAX's calibration pass does."""

    def __init__(self, dim: int, num_heads: int, layerscale_init: float = 1.0,
                 use_kernels: bool = True, dtype: torch.dtype = torch.float32,
                 device=None, int8_attn: bool = False, int8_mlp: bool = False,
                 drop_path: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernels = use_kernels
        self.drop_path = DropPath(drop_path)
        self.norm1 = LayerNorm(dim, LN_EPS, device=device)
        self.attn = Attention(dim, dtype, device=device)
        self.ls1 = LayerScale(dim, layerscale_init, device=device)
        self.norm2 = LayerNorm(dim, LN_EPS, device=device)
        self.mlp = Mlp(dim, 4 * dim, dtype=dtype, device=device,
                       int8=int8_mlp)
        self.ls2 = LayerScale(dim, layerscale_init, device=device)
        self._k2: dict | None = None
        self._k3: dict | None = None
        self._init_quant(dim, int8_attn, int8_mlp)

    @torch.no_grad()
    def fold_int8(self) -> None:
        """Fold the static scales into K2's and K3's arguments (once per
        installed quant state, not per call), held as non-persistent
        buffers so that `.to(device)` moves them."""
        if self.int8_attn:
            self._k2 = self._fold("k2", dict(self._attn_int8_fold(True),
                                             gamma=self.ls1.gamma.float()))
        if self.mlp.int8:
            self._k3 = self._fold("k3", self.mlp.int8_args(
                self.norm2.weight, self.norm2.bias, self.ls2.gamma))
            self._k3["inv_a_mid"] = float(1.0 / self.mlp.a_mid_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        calibrating = self.calibrating
        if self.int8_attn and not calibrating:
            attn = (fused_mhsa_block_int8 if self.use_kernels
                    else mhsa_block_int8_reference)
            x = self._int8_attention(attn, x, **self._folded_args(self._k2),
                                     num_heads=self.num_heads, ln_eps=LN_EPS)
        else:
            dt = x.dtype
            args = (x, self.norm1.weight, self.norm1.bias,
                    self.attn.qkv_weight.to(dt), self.attn.qkv_bias,
                    self.attn.proj_weight.to(dt), self.attn.proj_bias)
            gamma = self.ls1.gamma
            dropping = self.drop_path.rate > 0 and self.training
            if calibrating:
                x = mhsa_block_reference(*args, gamma, self.num_heads, LN_EPS,
                                         calib=self.calib)
            elif torch.is_grad_enabled() and dropping:
                h = mhsa_attention_unfused(*args, self.num_heads, LN_EPS)
                x = x + self.drop_path(h * gamma.to(dt))
            elif torch.is_grad_enabled():
                x = fused_mhsa_block_train(*args, gamma, self.num_heads,
                                           LN_EPS, kernels=self.use_kernels)
            else:
                attn = (fused_mhsa_block if self.use_kernels
                        else mhsa_block_reference)
                x = attn(*args, gamma, self.num_heads, LN_EPS)
        if self.mlp.int8 and not calibrating:
            mlp = (fused_mlp_block_int8 if self.use_kernels
                   else mlp_block_int8_reference)
            return mlp(x, **self._folded_args(self._k3), ln_eps=LN_EPS)
        h = self.mlp(self.norm2(x))
        return x + self.drop_path(h * self.ls2.gamma.to(h.dtype))


class DinoV2(nn.Module):
    def __init__(self, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, patch_size: int = 14,
                 image_size: int = 224, layerscale_init: float = 1.0,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 int8_attn: bool = False, int8_mlp: bool = False,
                 drop_path_rate: float = 0.0,
                 param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        pdt = param_dtype or dtype
        self.remat = remat
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.patch_size = patch_size
        self.num_patches = (image_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, hidden_size, patch_size,
                                     stride=patch_size, dtype=pdt,
                                     device=device)
        self.cls_token = nn.Parameter(
            torch.empty(1, 1, hidden_size, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.num_patches + 1, hidden_size, device=device))
        self.blocks = nn.ModuleList(
            DinoV2Block(hidden_size, num_heads, layerscale_init, use_kernels,
                        pdt, device, int8_attn=int8_attn, int8_mlp=int8_mlp,
                        drop_path=drop_path_rate) for _ in range(num_layers))
        self.norm = LayerNorm(hidden_size, LN_EPS, device=device)

    def _init_weights(self, generator: torch.Generator) -> None:
        normal_(self.cls_token, 0.02, generator)
        normal_(self.pos_embed, 0.02, generator)

    def forward(self, x: torch.Tensor) -> BackboneOutput:
        """x: (B, H, W, 3) NHWC images."""
        conv, dt = self.patch_embed, self.dtype
        b = x.shape[0]
        x = conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt),
                   conv.bias.to(dt), stride=self.patch_size)  # (B, D, h, w)
        x = x.flatten(2).transpose(1, 2)                      # (B, h*w, D)
        x = torch.cat([self.cls_token.to(dt).expand(b, -1, -1), x], dim=1)
        x = (x + self.pos_embed.to(dt)).contiguous()
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = remat_call(blk, x) if remat else blk(x)
        x = self.norm(x)
        return BackboneOutput(pooled=x[:, 0], tokens=x[:, 1:], cls=x[:, 0])
