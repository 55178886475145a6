"""DINOv2 + SALAD global-descriptor model (the port of `geovpr.models.salad`).

SALAD head: per-token features 768 -> 512 -> cluster_dim (128), per-token
cluster scores 768 -> 512 -> num_clusters (64), CLS global token
768 -> 512 -> token_dim (256); log-domain Sinkhorn with a learnable dustbin;
V[b,c,d] = sum_n P[b,c,n] f[b,n,d]; intra-cluster L2, flatten, concat with
the L2-normed global token, final L2 -> 64*128 + 256 = 8448 dims.

int8 serving (`int8=True` on the head, `int8_mlp` on the model): the two
token-wide fc1 matmuls (feat and score, 768 -> 512) share one input and so
one static activation scale `a_tokens_scale`, and run as exact int8 x int8
products through `torch._int_mm`, as JAX runs them as an XLA dot outside any
kernel; the fc2s, the CLS path and Sinkhorn stay in the compute dtype / f32.

A training build (`param_dtype` f32) holds the Dense layers in f32 and
casts them to the compute dtype per call, as the other families' training
builds do. With the backbone frozen it runs under no grad (the serving
forward, K1); unfrozen, the backbone trains as a `dinov2` backbone does
(K8a forward, K8c backward a block; with `remat` each block recomputed, as
JAX's `DinoV2Salad(remat=)` remats its backbone's blocks) and the head,
Sinkhorn included, runs under autograd in the dtypes JAX gives it: the
Dense layers in the compute dtype, the assignment and aggregation in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from geovpr_torch.models.backbone import BackboneOutput
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS, DinoV2
from geovpr_torch.models.layers import (linear, normalize_l2,
                                        register_quant_buffers)
from geovpr_torch.ops.quant import (act_scale, amax_into, int_mm,
                                    quantize_act, quantize_weight)
from geovpr_torch.ops.sinkhorn import salad_assignment

_INT8_FC1 = ("feat_fc1", "score_fc1")


class SaladHead(nn.Module):
    def __init__(self, in_dim: int = 768, num_clusters: int = 64,
                 cluster_dim: int = 128, token_dim: int = 256,
                 hidden: int = 512, sinkhorn_iters: int = 3,
                 dtype: torch.dtype = torch.float32, device=None,
                 int8: bool = False, param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.sinkhorn_iters = sinkhorn_iters
        self.int8 = int8
        self.calib: dict | None = None

        def dense(i, o):
            return nn.Linear(i, o, dtype=param_dtype or dtype, device=device)

        self.feat_fc1 = dense(in_dim, hidden)
        self.score_fc1 = dense(in_dim, hidden)
        self.feat_fc2 = dense(hidden, cluster_dim)
        self.score_fc2 = dense(hidden, num_clusters)
        self.token_fc1 = dense(in_dim, hidden)
        self.token_fc2 = dense(hidden, token_dim)
        self.dustbin = nn.Parameter(torch.empty((), device=device))
        if int8:
            f32 = torch.float32
            register_quant_buffers(self, (
                ("a_tokens_scale", (), f32, 1.0),
                *(spec for p in _INT8_FC1 for spec in (
                    (f"{p}_kernel_q", (in_dim, hidden), torch.int8, 0),
                    (f"{p}_kernel_scale", (hidden,), f32, 1.0),
                    (f"{p}_bias", (hidden,), f32, 0.0)))))

    def _init_weights(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.dustbin.fill_(1.0)

    def quant_state(self, amax: dict) -> dict:
        """The JAX "quant" entries of the head from its calibration amax
        (`geovpr/models/quantize.py:48-59`)."""
        out = {"a_tokens_scale": act_scale(amax["a_tokens"])}
        for p in _INT8_FC1:
            fc = getattr(self, p)
            out[f"{p}_kernel_q"], out[f"{p}_kernel_scale"] = \
                quantize_weight(fc.weight.t())
            out[f"{p}_bias"] = fc.bias.detach().float().cpu()
        return out

    def _fc1_int8(self, tokens: torch.Tensor):
        """feat and score fc1 + ReLU as w8a8 products on one quantized copy
        of the tokens (`geovpr/models/salad.py:77-94`)."""
        b, n, c = tokens.shape
        a_t = self.a_tokens_scale
        xq = quantize_act(tokens.float().reshape(-1, c), a_t)
        outs = []
        for p in _INT8_FC1:
            y = (int_mm(xq, getattr(self, f"{p}_kernel_q")).float()
                 * (a_t * getattr(self, f"{p}_kernel_scale"))
                 + getattr(self, f"{p}_bias"))
            outs.append(torch.relu(y).reshape(b, n, -1).to(self.dtype))
        return outs

    def forward(self, tokens: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        """tokens: (B, N, C) patch features; cls: (B, C). -> (B, 8448)."""
        tokens = tokens.to(self.dtype)
        if self.calib is not None:
            amax_into(self.calib, "a_tokens", tokens)
        if self.int8 and self.calib is None:
            f1, s1 = self._fc1_int8(tokens)
        else:
            f1 = F.relu(linear(tokens, self.feat_fc1))
            s1 = F.relu(linear(tokens, self.score_fc1))
        f = linear(f1, self.feat_fc2)
        s = linear(s1, self.score_fc2)
        t = linear(F.relu(linear(cls.to(self.dtype), self.token_fc1)),
                   self.token_fc2)
        # scores to (B, M clusters, N tokens)
        p = salad_assignment(s.transpose(1, 2).float(), self.dustbin,
                             num_iters=self.sinkhorn_iters)
        v = torch.einsum("bcn,bnd->bcd", p, f.float())
        v = normalize_l2(v, dim=-1)                    # intra-cluster L2
        out = torch.cat([normalize_l2(t.float()), v.flatten(1)], dim=-1)
        return normalize_l2(out)                       # unit norm


class DinoV2Salad(nn.Module):
    """Full descriptor model: DINOv2 -> SALAD -> (B, descriptor_dim) unit
    vectors. Input NHWC float images (already normalised). `int8_attn` and
    `int8_mlp` select the w8a8 serving path as in JAX (`int8_mlp` also
    quantizes the SALAD fc1s); its state comes from
    `geovpr_torch.models.quantize.quantize_for_serving` or a state_dict."""

    def __init__(self, variant: str = "base-14", image_size: int = 224,
                 num_clusters: int = 64, cluster_dim: int = 128,
                 token_dim: int = 256, sinkhorn_iters: int = 3,
                 use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 int8_attn: bool = False, int8_mlp: bool = False,
                 param_dtype: torch.dtype | None = None,
                 remat: bool = False):
        super().__init__()
        cfg = DINOV2_VARIANTS[variant]
        self.dtype = dtype
        self.num_clusters = num_clusters
        self.cluster_dim = cluster_dim
        self.token_dim = token_dim
        self.backbone = DinoV2(**cfg, image_size=image_size,
                               use_kernels=use_kernels, dtype=dtype,
                               device=device, int8_attn=int8_attn,
                               int8_mlp=int8_mlp, param_dtype=param_dtype,
                               remat=remat)
        self.salad = SaladHead(cfg["hidden_size"], num_clusters, cluster_dim,
                               token_dim, sinkhorn_iters=sinkhorn_iters,
                               dtype=dtype, device=device, int8=int8_mlp,
                               param_dtype=param_dtype)

    @property
    def descriptor_dim(self) -> int:
        return self.num_clusters * self.cluster_dim + self.token_dim

    def forward(self, x: torch.Tensor) -> BackboneOutput:
        out = self.backbone(x)
        desc = self.salad(out.tokens, out.cls)
        return BackboneOutput(pooled=desc, tokens=out.tokens, cls=out.cls)
