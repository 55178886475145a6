"""PyTorch checkpoint -> flax-layout parameter tree (the port's copy of
`geovpr/models/convert_torch.py`, layout for layout).

The reference obtains all weights from pretrained torch checkpoints
(torchvision `efficientnet_b0(weights=IMAGENET1K_V1)`
`efficientnet_finetuning.py:53`; HF `SwinModel.from_pretrained`
`swin_attempt_2.py:117`; HF `Dinov2Model` `dinov2salad_finetuning_2.py:117`;
HF `ConvNextModel` `convnext_finetuning.py:58`; torch.hub SALAD
`dinov2salad_finetuning.py:19`). These converters map such state dicts onto
the nested numpy tree of flax variables that the JAX package's models take,
so one converted file serves both packages: `models/convert_jax.py::
state_dict_from_flax` stays the one bridge from that tree into the port's
modules, and `convert_jax.save_flax_msgpack` writes it as flax does.

Conventions:
- conv kernels:      torch (O, I, kH, kW)  -> flax (kH, kW, I, O)
- depthwise convs:   torch (C, 1, kH, kW)  -> flax (kH, kW, 1, C)
- linear weights:    torch (O, I)          -> flax (I, O)
- batchnorm:         weight/bias -> scale/bias params;
                     running_mean/var -> batch_stats mean/var

The one computed leaf is a DINOv2 position table resized to another patch
grid (`_interp_pos_embed`): JAX resizes it with `jax.image.resize(...,
"bicubic")`, Keys' cubic (a = -0.5) antialiased on a downscale, which is
`torch.nn.functional.interpolate(mode="bicubic", antialias=True)`; the
two agree within 1e-5 (`tests/test_torch_convert.py`). Every other leaf
is the checkpoint's own values, transposed.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _conv(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _linear(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (1, 0))


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


class _TreeBuilder:
    """Accumulates flat (path, array) pairs into nested dicts."""

    def __init__(self):
        self.params: dict[str, Any] = {}
        self.batch_stats: dict[str, Any] = {}

    def _set(self, root: dict, path: str, value: np.ndarray):
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def p(self, path: str, value):
        self._set(self.params, path, _np(value))

    def bs(self, path: str, value):
        self._set(self.batch_stats, path, _np(value))

    def conv_bn(self, prefix_flax: str, sd: Mapping, prefix_torch: str):
        """Map a torchvision Conv2dNormActivation (conv at .0, BN at .1)."""
        self.p(f"{prefix_flax}/conv/kernel", _conv(_np(sd[f"{prefix_torch}.0.weight"])))
        self.p(f"{prefix_flax}/bn/scale", sd[f"{prefix_torch}.1.weight"])
        self.p(f"{prefix_flax}/bn/bias", sd[f"{prefix_torch}.1.bias"])
        self.bs(f"{prefix_flax}/bn/mean", sd[f"{prefix_torch}.1.running_mean"])
        self.bs(f"{prefix_flax}/bn/var", sd[f"{prefix_torch}.1.running_var"])

    def variables(self) -> dict:
        out = {"params": self.params}
        if self.batch_stats:
            out["batch_stats"] = self.batch_stats
        return out


def convert_efficientnet_b0(state_dict: Mapping[str, Any]) -> dict:
    """torchvision efficientnet_b0 state_dict -> EfficientNetB0 variables.

    torchvision layout: features.0 stem, features.1..7 MBConv stages,
    features.8 head conv; inside an MBConv, `block.{i}` is
    [expand?, dw, SE, project] (expand present iff expand_ratio != 1).
    """
    from geovpr_torch.models.efficientnet import B0_STAGES

    tb = _TreeBuilder()
    sd = state_dict
    tb.conv_bn("stem", sd, "features.0")

    for stage_i, spec in enumerate(B0_STAGES):
        for layer_i in range(spec.layers):
            t = f"features.{stage_i + 1}.{layer_i}.block"
            f = f"stage{stage_i}_block{layer_i}"
            idx = 0
            if spec.expand_ratio != 1:
                tb.conv_bn(f"{f}/expand", sd, f"{t}.{idx}")
                idx += 1
            tb.conv_bn(f"{f}/dw", sd, f"{t}.{idx}")
            idx += 1
            tb.p(f"{f}/se/fc1/kernel", _conv(_np(sd[f"{t}.{idx}.fc1.weight"])))
            tb.p(f"{f}/se/fc1/bias", sd[f"{t}.{idx}.fc1.bias"])
            tb.p(f"{f}/se/fc2/kernel", _conv(_np(sd[f"{t}.{idx}.fc2.weight"])))
            tb.p(f"{f}/se/fc2/bias", sd[f"{t}.{idx}.fc2.bias"])
            idx += 1
            tb.conv_bn(f"{f}/project", sd, f"{t}.{idx}")

    tb.conv_bn("head", sd, "features.8")
    return tb.variables()


def convert_swin_hf(state_dict: Mapping[str, Any], depths) -> dict:
    """HF `SwinModel` state_dict -> SwinTransformer variables.

    HF layout (modeling_swin): embeddings.patch_embeddings.projection,
    embeddings.norm, encoder.layers.{s}.blocks.{b}.{layernorm_before,
    attention.self.{query,key,value,relative_position_bias_table},
    attention.output.dense, layernorm_after, intermediate.dense,
    output.dense}, encoder.layers.{s}.downsample.{norm,reduction},
    final layernorm. The pooler has no weights (adaptive avg pool).
    """
    tb = _TreeBuilder()
    sd = state_dict

    def ln(f, t):
        tb.p(f"{f}/scale", sd[f"{t}.weight"])
        tb.p(f"{f}/bias", sd[f"{t}.bias"])

    def dense(f, t, bias=True):
        tb.p(f"{f}/kernel", _linear(_np(sd[f"{t}.weight"])))
        if bias:
            tb.p(f"{f}/bias", sd[f"{t}.bias"])

    tb.p("patch_embed/kernel",
         _conv(_np(sd["embeddings.patch_embeddings.projection.weight"])))
    tb.p("patch_embed/bias", sd["embeddings.patch_embeddings.projection.bias"])
    ln("embed_norm", "embeddings.norm")

    for s, depth in enumerate(depths):
        for b in range(depth):
            t = f"encoder.layers.{s}.blocks.{b}"
            f = f"stage{s}_block{b}"
            ln(f"{f}/norm1", f"{t}.layernorm_before")
            dense(f"{f}/attn/query", f"{t}.attention.self.query")
            dense(f"{f}/attn/key", f"{t}.attention.self.key")
            dense(f"{f}/attn/value", f"{t}.attention.self.value")
            tb.p(f"{f}/attn/relative_position_bias_table",
                 sd[f"{t}.attention.self.relative_position_bias_table"])
            dense(f"{f}/attn/proj", f"{t}.attention.output.dense")
            ln(f"{f}/norm2", f"{t}.layernorm_after")
            dense(f"{f}/mlp/fc1", f"{t}.intermediate.dense")
            dense(f"{f}/mlp/fc2", f"{t}.output.dense")
        if s < len(depths) - 1:
            ln(f"stage{s}_downsample/norm", f"encoder.layers.{s}.downsample.norm")
            dense(f"stage{s}_downsample/reduction",
                  f"encoder.layers.{s}.downsample.reduction", bias=False)

    ln("norm", "layernorm")
    return tb.variables()


def convert_convnext_hf(state_dict: Mapping[str, Any], depths) -> dict:
    """HF `ConvNextModel` state_dict -> ConvNeXt variables."""
    tb = _TreeBuilder()
    sd = state_dict

    def ln(f, t):
        tb.p(f"{f}/scale", sd[f"{t}.weight"])
        tb.p(f"{f}/bias", sd[f"{t}.bias"])

    tb.p("stem/kernel", _conv(_np(sd["embeddings.patch_embeddings.weight"])))
    tb.p("stem/bias", sd["embeddings.patch_embeddings.bias"])
    ln("stem_norm", "embeddings.layernorm")

    for s, depth in enumerate(depths):
        if s > 0:
            ln(f"downsample{s}_norm", f"encoder.stages.{s}.downsampling_layer.0")
            tb.p(f"downsample{s}_conv/kernel",
                 _conv(_np(sd[f"encoder.stages.{s}.downsampling_layer.1.weight"])))
            tb.p(f"downsample{s}_conv/bias",
                 sd[f"encoder.stages.{s}.downsampling_layer.1.bias"])
        for b in range(depth):
            t = f"encoder.stages.{s}.layers.{b}"
            f = f"stage{s}_block{b}"
            tb.p(f"{f}/dwconv/kernel", _conv(_np(sd[f"{t}.dwconv.weight"])))
            tb.p(f"{f}/dwconv/bias", sd[f"{t}.dwconv.bias"])
            ln(f"{f}/norm", f"{t}.layernorm")
            # HF's pwconv1/pwconv2 land in the shared Mlp module (fc1/fc2),
            # the channel MLP that K3 serves in w8a8
            tb.p(f"{f}/mlp/fc1/kernel", _linear(_np(sd[f"{t}.pwconv1.weight"])))
            tb.p(f"{f}/mlp/fc1/bias", sd[f"{t}.pwconv1.bias"])
            tb.p(f"{f}/mlp/fc2/kernel", _linear(_np(sd[f"{t}.pwconv2.weight"])))
            tb.p(f"{f}/mlp/fc2/bias", sd[f"{t}.pwconv2.bias"])
            tb.p(f"{f}/gamma", sd[f"{t}.layer_scale_parameter"])

    ln("pool_norm", "layernorm")
    return tb.variables()


def convert_dinov2_hf(state_dict: Mapping[str, Any], num_layers: int = 12,
                      target_grid: int | None = None) -> dict:
    """HF `Dinov2Model` state_dict -> DinoV2 variables.

    If `target_grid` (patches per side) differs from the checkpoint's grid,
    the patch position embeddings are bicubically resized — mirroring HF's
    `interpolate_pos_encoding` (modeling_dinov2) done once at import instead
    of every forward.
    """
    tb = _TreeBuilder()
    sd = state_dict

    def ln(f, t):
        tb.p(f"{f}/scale", sd[f"{t}.weight"])
        tb.p(f"{f}/bias", sd[f"{t}.bias"])

    def dense(f, t):
        tb.p(f"{f}/kernel", _linear(_np(sd[f"{t}.weight"])))
        tb.p(f"{f}/bias", sd[f"{t}.bias"])

    tb.p("cls_token", sd["embeddings.cls_token"])
    pos = _np(sd["embeddings.position_embeddings"])  # (1, N+1, D)
    if target_grid is not None:
        pos = _interp_pos_embed(pos, target_grid)
    tb.p("pos_embed", pos)
    tb.p("patch_embed/kernel",
         _conv(_np(sd["embeddings.patch_embeddings.projection.weight"])))
    tb.p("patch_embed/bias", sd["embeddings.patch_embeddings.projection.bias"])

    for i in range(num_layers):
        t = f"encoder.layer.{i}"
        f = f"block{i}"
        ln(f"{f}/norm1", f"{t}.norm1")
        dense(f"{f}/attn/query", f"{t}.attention.attention.query")
        dense(f"{f}/attn/key", f"{t}.attention.attention.key")
        dense(f"{f}/attn/value", f"{t}.attention.attention.value")
        dense(f"{f}/attn/proj", f"{t}.attention.output.dense")
        tb.p(f"{f}/ls1/gamma", sd[f"{t}.layer_scale1.lambda1"])
        ln(f"{f}/norm2", f"{t}.norm2")
        dense(f"{f}/mlp/fc1", f"{t}.mlp.fc1")
        dense(f"{f}/mlp/fc2", f"{t}.mlp.fc2")
        tb.p(f"{f}/ls2/gamma", sd[f"{t}.layer_scale2.lambda1"])

    ln("norm", "layernorm")
    return tb.variables()


def convert_efficientnet_hf(state_dict: Mapping[str, Any]) -> dict:
    """HF `EfficientNetModel` (b0 config) state_dict -> EfficientNetB0
    variables. Use with ``EfficientNetB0(conv_padding="tf")`` — HF follows
    the original TF implementation's asymmetric SAME padding for stride-2
    convs, unlike torchvision.
    """
    from geovpr_torch.models.efficientnet import B0_STAGES

    def bn(tb, f, sd, t):
        tb.p(f"{f}/bn/scale", sd[f"{t}.weight"])
        tb.p(f"{f}/bn/bias", sd[f"{t}.bias"])
        tb.bs(f"{f}/bn/mean", sd[f"{t}.running_mean"])
        tb.bs(f"{f}/bn/var", sd[f"{t}.running_var"])

    tb = _TreeBuilder()
    sd = state_dict
    tb.p("stem/conv/kernel", _conv(_np(sd["embeddings.convolution.weight"])))
    bn(tb, "stem", sd, "embeddings.batchnorm")

    block_num = 0
    for stage_i, spec in enumerate(B0_STAGES):
        for layer_i in range(spec.layers):
            t = f"encoder.blocks.{block_num}"
            f = f"stage{stage_i}_block{layer_i}"
            if spec.expand_ratio != 1:
                tb.p(f"{f}/expand/conv/kernel",
                     _conv(_np(sd[f"{t}.expansion.expand_conv.weight"])))
                bn(tb, f"{f}/expand", sd, f"{t}.expansion.expand_bn")
            tb.p(f"{f}/dw/conv/kernel",
                 _conv(_np(sd[f"{t}.depthwise_conv.depthwise_conv.weight"])))
            bn(tb, f"{f}/dw", sd, f"{t}.depthwise_conv.depthwise_norm")
            tb.p(f"{f}/se/fc1/kernel",
                 _conv(_np(sd[f"{t}.squeeze_excite.reduce.weight"])))
            tb.p(f"{f}/se/fc1/bias", sd[f"{t}.squeeze_excite.reduce.bias"])
            tb.p(f"{f}/se/fc2/kernel",
                 _conv(_np(sd[f"{t}.squeeze_excite.expand.weight"])))
            tb.p(f"{f}/se/fc2/bias", sd[f"{t}.squeeze_excite.expand.bias"])
            tb.p(f"{f}/project/conv/kernel",
                 _conv(_np(sd[f"{t}.projection.project_conv.weight"])))
            bn(tb, f"{f}/project", sd, f"{t}.projection.project_bn")
            block_num += 1

    tb.p("head/conv/kernel", _conv(_np(sd["encoder.top_conv.weight"])))
    bn(tb, "head", sd, "encoder.top_bn")
    return tb.variables()


def _interp_pos_embed(pos: np.ndarray, target_grid: int) -> np.ndarray:
    """Bicubic-resize (1, 1+g*g, D) position embeddings to a new grid, in
    f32: Keys' cubic with a = -0.5, antialiased when it shrinks, as
    `jax.image.resize(..., "bicubic")` computes it. Without `antialias`
    torch's bicubic is another kernel (a = -0.75, no widening on a
    downscale)."""
    src_grid = int(round((pos.shape[1] - 1) ** 0.5))
    if src_grid == target_grid:
        return pos
    import torch
    import torch.nn.functional as F

    d = pos.shape[-1]
    patch = torch.from_numpy(np.ascontiguousarray(
        pos[:, 1:].reshape(1, src_grid, src_grid, d), np.float32))
    patch = F.interpolate(patch.permute(0, 3, 1, 2),
                          size=(target_grid, target_grid), mode="bicubic",
                          align_corners=False, antialias=True)
    patch = patch.permute(0, 2, 3, 1).numpy().reshape(
        1, target_grid * target_grid, d)
    return np.concatenate([pos[:, :1], patch], axis=1)


def convert_dinov2_facebook(state_dict: Mapping[str, Any],
                            num_layers: int = 12,
                            target_grid: int | None = None,
                            prefix: str = "") -> dict:
    """facebookresearch/dinov2 ViT state_dict (fused qkv, `blocks.N.*`
    naming — the backbone inside `torch.hub.load("serizba/salad", ...)`,
    `dinov2salad/dinov2salad_finetuning.py:19`) -> DinoV2 variables.

    The fused `attn.qkv` weight (3D, D) is split into the separate
    query/key/value kernels of the flax layout (the bridge fuses them
    again); position embeddings are bicubically resized to `target_grid`
    at import time (the hub model does this per forward).
    """
    tb = _TreeBuilder()
    sd = {k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)}

    def ln(f, t):
        tb.p(f"{f}/scale", sd[f"{t}.weight"])
        tb.p(f"{f}/bias", sd[f"{t}.bias"])

    tb.p("cls_token", sd["cls_token"])
    pos = _np(sd["pos_embed"])
    if target_grid is not None:
        pos = _interp_pos_embed(pos, target_grid)
    tb.p("pos_embed", pos)
    tb.p("patch_embed/kernel", _conv(_np(sd["patch_embed.proj.weight"])))
    tb.p("patch_embed/bias", sd["patch_embed.proj.bias"])

    for i in range(num_layers):
        t = f"blocks.{i}"
        f = f"block{i}"
        ln(f"{f}/norm1", f"{t}.norm1")
        qkv_w = _np(sd[f"{t}.attn.qkv.weight"])   # (3D, D) torch layout
        qkv_b = _np(sd[f"{t}.attn.qkv.bias"])
        d = qkv_w.shape[1]
        for j, name in enumerate(("query", "key", "value")):
            tb.p(f"{f}/attn/{name}/kernel",
                 _linear(qkv_w[j * d:(j + 1) * d]))
            tb.p(f"{f}/attn/{name}/bias", qkv_b[j * d:(j + 1) * d])
        tb.p(f"{f}/attn/proj/kernel", _linear(_np(sd[f"{t}.attn.proj.weight"])))
        tb.p(f"{f}/attn/proj/bias", sd[f"{t}.attn.proj.bias"])
        tb.p(f"{f}/ls1/gamma", sd[f"{t}.ls1.gamma"])
        ln(f"{f}/norm2", f"{t}.norm2")
        tb.p(f"{f}/mlp/fc1/kernel", _linear(_np(sd[f"{t}.mlp.fc1.weight"])))
        tb.p(f"{f}/mlp/fc1/bias", sd[f"{t}.mlp.fc1.bias"])
        tb.p(f"{f}/mlp/fc2/kernel", _linear(_np(sd[f"{t}.mlp.fc2.weight"])))
        tb.p(f"{f}/mlp/fc2/bias", sd[f"{t}.mlp.fc2.bias"])
        tb.p(f"{f}/ls2/gamma", sd[f"{t}.ls2.gamma"])

    ln("norm", "norm")
    return tb.variables()


def _conv1x1(w) -> np.ndarray:
    """torch Conv2d 1x1 weight (out, in, 1, 1) -> Dense kernel (in, out)."""
    w = _np(w)
    return np.transpose(w[:, :, 0, 0], (1, 0))


def convert_salad_hub(state_dict: Mapping[str, Any],
                      num_layers: int = 12,
                      target_grid: int = 16) -> dict:
    """`torch.hub.load("serizba/salad", "dinov2_salad")` VPRModel state_dict
    -> DinoV2Salad variables.

    The hub model (the frozen descriptor black box of
    `dinov2salad/dinov2salad_finetuning.py:19,92`) is
    `backbone` (facebookresearch dinov2 ViT-B/14) + `aggregator` (SALAD):
    two 1x1-conv MLPs for per-token features (768->512->cluster_dim) and
    cluster scores (768->512->num_clusters), a Linear MLP for the global
    token (768->512->token_dim), and a scalar `dust_bin`. Prefixes are
    auto-detected so both `backbone.*` and `backbone.model.*` layouts load.
    """
    sd = dict(state_dict)
    bb_prefix = next((k[:-len("cls_token")] for k in sd
                      if k.endswith("cls_token")), None)
    agg_prefix = next((k[:-len("dust_bin")] for k in sd
                       if k.endswith("dust_bin")), None)
    if bb_prefix is None or agg_prefix is None:
        raise ValueError("state_dict does not look like a serizba/salad "
                         "VPRModel (no cls_token / dust_bin keys)")

    backbone = convert_dinov2_facebook(sd, num_layers=num_layers,
                                       target_grid=target_grid,
                                       prefix=bb_prefix)

    tb = _TreeBuilder()
    tb.params["backbone"] = backbone["params"]
    a = agg_prefix
    tb.p("salad/feat_fc1/kernel", _conv1x1(sd[f"{a}cluster_features.0.weight"]))
    tb.p("salad/feat_fc1/bias", sd[f"{a}cluster_features.0.bias"])
    tb.p("salad/feat_fc2/kernel", _conv1x1(sd[f"{a}cluster_features.2.weight"]))
    tb.p("salad/feat_fc2/bias", sd[f"{a}cluster_features.2.bias"])
    tb.p("salad/score_fc1/kernel", _conv1x1(sd[f"{a}score.0.weight"]))
    tb.p("salad/score_fc1/bias", sd[f"{a}score.0.bias"])
    tb.p("salad/score_fc2/kernel", _conv1x1(sd[f"{a}score.2.weight"]))
    tb.p("salad/score_fc2/bias", sd[f"{a}score.2.bias"])
    tb.p("salad/token_fc1/kernel", _linear(_np(sd[f"{a}token_features.0.weight"])))
    tb.p("salad/token_fc1/bias", sd[f"{a}token_features.0.bias"])
    tb.p("salad/token_fc2/kernel", _linear(_np(sd[f"{a}token_features.2.weight"])))
    tb.p("salad/token_fc2/bias", sd[f"{a}token_features.2.bias"])
    tb.p("salad/dustbin", np.asarray(_np(sd[f"{a}dust_bin"])).reshape(()))
    return tb.variables()
