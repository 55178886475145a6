"""The port's two w8a8 paths without a kernel of their own, against the JAX
package on the CPU, the same weights and the same JAX-calibrated "quant"
collection on both sides (carried over by `state_dict_from_flax`):

- the window-7 Swin attention half (`swin_attn_block_int8_unfused`, torch
  ops, as JAX's is its XLA fallback `SwinBlock._attention_int8`), shifted
  and unshifted, a block at a time, and a whole tiny window-7 Swin with K3's
  plain version in every MLP half;
- the w8a8 ConvNeXt block (dwconv -> K3 with LN, gamma and the pre-dwconv
  stream as its separate residual) against JAX's `Mlp(fused=...,
  fused_residual=x)` XLA path, and a whole tiny ConvNeXt;
- the port's own calibration of ConvNeXt against JAX's
  `quantize_for_serving`, and the serving rule (`check_int8_serving`).

Bounds are set from measured values with a margin, as in
`test_torch_int8_model.py`: both sides quantize the same values but a few
land on the other side of an int8 rounding (the port folds 1/a into the
LN scale, JAX multiplies it apart) and each flip moves what it feeds by a
dequant step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.convnext as jconvnext
from geovpr.models.quantize import quantize_for_serving as j_quantize
from geovpr.models.swin import SwinBlock as JSwinBlock
from geovpr.models.swin import SwinTransformer as JSwin
from geovpr_torch.core.config import ModelConfig
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.convnext import ConvNeXt, ConvNeXtBlock
from geovpr_torch.models.quantize import quantize_for_serving
from geovpr_torch.models.registry import check_int8_serving
from geovpr_torch.models.swin import SwinBlock, SwinTransformer
from geovpr_torch.ops import swin_block as sb
from torch_int8_modes import set_int8_mode

SWIN7 = dict(embed_dim=64, depths=(2, 2), num_heads=(2, 4), window_size=7,
             image_size=56)
CONVNEXT = dict(depths=(2, 1), dims=(32, 64))


def _params(model, x, seed):
    """JAX init plus noise, so that no LayerNorm is the identity, the
    relative-position tables are not zero and ConvNeXt's gamma is far off
    its 1e-6 init (a fault in the MLP branch cannot hide under the
    residual)."""
    rng = np.random.default_rng(seed)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))

    def noisy(path, a):
        a = np.asarray(a)
        noise = rng.normal(size=a.shape).astype(np.float32)
        if path[-1].key == "gamma":
            return noise * 0.5
        return a + noise * 0.05
    return {"params": jax.tree_util.tree_map_with_path(noisy, v["params"])}


def _port(module, variables):
    res = module.load_state_dict(state_dict_from_flax(variables),
                                 strict=False)
    params = {n for n, _ in module.named_parameters()}
    assert not res.unexpected_keys
    assert not [k for k in res.missing_keys if k in params]
    return module.eval()


def _cosine(got, want):
    g = got.reshape(-1, got.shape[-1]).float().numpy()
    w = np.asarray(want, np.float32).reshape(g.shape)
    return (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                              * np.linalg.norm(w, axis=-1))


@pytest.mark.parametrize("shift", [0, 3])
def test_window7_int8_half_matches_jax_fallback(shift):
    """One window-7 block at resolution 14 (four windows), w8a8 attention
    and the float MLP on both sides, so that the attention half alone
    differs: the whole block's output within 1e-3 of its scale (max
    |error|) and a cosine of 0.99999 per token (measured 2.4e-7 and
    0.9999998: no int8 rounding flipped on these inputs)."""
    c, heads, res = 64, 2, 14
    x = np.random.default_rng(shift).normal(size=(2, res * res, c)).astype(
        np.float32)
    jm = JSwinBlock(dim=c, num_heads=heads, resolution=res, window=7,
                    shift=shift, int8_attn=True)
    vq = j_quantize(jm, _params(jm, x, shift), [jnp.asarray(x)])
    del vq["quant"]["mlp"]          # the MLP half stays float
    want = np.asarray(jax.jit(jm.apply)(vq, jnp.asarray(x)))
    tm = _port(SwinBlock(c, heads, res, 7, shift, int8_attn=True), vq)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-3 * np.abs(want).max(), err
    assert _cosine(got, want).min() >= 0.99999


@pytest.mark.parametrize("shift", [0, 3])
def test_window7_int8_half_arithmetic(shift):
    """`swin_attn_block_int8_unfused` against the fallback's arithmetic
    written out with numpy on the gathered windows: the same int8 scores,
    exactly, and the output to f32 rounding."""
    c, heads, res, w = 64, 2, 14, 7
    gen = torch.Generator().manual_seed(10 + shift)
    x = torch.randn(2, res * res, c, generator=gen)
    args = dict(
        ln_scale_q=torch.rand(c, generator=gen) * 40 + 20,
        ln_bias_q=torch.randn(c, generator=gen) * 5,
        wqkv_q_t=torch.randint(-127, 128, (3 * c, c), generator=gen,
                               dtype=torch.int8),
        sqkv_eff=torch.rand(3 * c, generator=gen) * 2e-3,
        bqkv_eff=torch.randn(3 * c, generator=gen),
        wo_q_t=torch.randint(-127, 128, (c, c), generator=gen,
                             dtype=torch.int8),
        so_eff=torch.rand(c, generator=gen) * 1e-4,
        bo=torch.randn(c, generator=gen) * 0.1,
        table=torch.randn(13 * 13, heads, generator=gen),
        num_heads=heads, resolution=res, window=w, shift=shift, cs=0.01)
    got = sb.swin_attn_block_int8_unfused(x, **args)

    xf = x.numpy().astype(np.float64)
    mu = xf.mean(-1, keepdims=True)
    xn = (xf - mu) / np.sqrt(((xf - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
    xq = np.clip(np.round(xn * args["ln_scale_q"].numpy()
                          + args["ln_bias_q"].numpy()), -127, 127)
    qkv = (xq.reshape(-1, c) @ args["wqkv_q_t"].numpy().T.astype(np.float64)
           * args["sqkv_eff"].numpy() + args["bqkv_eff"].numpy())
    qkv = torch.from_numpy(qkv.reshape(2, res * res, 3 * c)).float()
    q, k, v = sb._windows_qkv(qkv, res, w, shift, heads)
    s = sb._exact_bmm(sb.round_clip_int8(q), sb.round_clip_int8(k)
                      .transpose(-1, -2)) * 0.01
    s = sb.add_bias_mask(s, sb.relative_position_bias(args["table"], w),
                         sb.shift_mask(res, w, shift))
    ctx = torch.softmax(s, -1).bfloat16().float() @ v.bfloat16().float()
    ctx = sb._raster_ctx(ctx.bfloat16(), res, w, shift).float()
    ctxq = np.clip(np.round(ctx.numpy().reshape(-1, c)), -127, 127)
    out = (ctxq @ args["wo_q_t"].numpy().T.astype(np.float64)
           * args["so_eff"].numpy() + args["bo"].numpy())
    want = out.reshape(2, res * res, c) + xf
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("mode", ["int8_pv", "bf16_scores"])
def test_window7_int8_half_matches_jax_fallback_in_mode(monkeypatch, mode,
                                                       shift):
    """`test_window7_int8_half_matches_jax_fallback` in the two other
    attention modes, each package folding the JAX-calibrated state in that
    mode (`INT8_PV`, `INT8_QK_SCORES` set in both): the same bounds
    (measured 2.8e-7 of the scale and 0.9999998 in both modes: no int8
    rounding flipped)."""
    set_int8_mode(monkeypatch, mode)
    c, heads, res = 64, 2, 14
    x = np.random.default_rng(shift).normal(size=(2, res * res, c)).astype(
        np.float32)
    jm = JSwinBlock(dim=c, num_heads=heads, resolution=res, window=7,
                    shift=shift, int8_attn=True)
    vq = j_quantize(jm, _params(jm, x, shift), [jnp.asarray(x)])
    del vq["quant"]["mlp"]          # the MLP half stays float
    want = np.asarray(jax.jit(jm.apply)(vq, jnp.asarray(x)))
    tm = _port(SwinBlock(c, heads, res, 7, shift, int8_attn=True), vq)
    assert (tm._k5["cs"] is None) == (mode == "bf16_scores")
    assert (tm._k5["cpv"] is None) == (mode != "int8_pv")
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-3 * np.abs(want).max(), err
    assert _cosine(got, want).min() >= 0.99999


def test_window7_int8_model_matches_jax_fallback():
    """A whole tiny window-7 Swin (stage 0 at resolution 14 with a shifted
    block, stage 1 one window wide), w8a8 attention and MLP halves, f32,
    against JAX's XLA fallbacks: cosine 0.9995 on the pooled features and
    0.995 per token (measured 0.99999 and 0.99977)."""
    x = np.random.default_rng(3).normal(size=(3, 56, 56, 3)).astype(
        np.float32)
    jm = JSwin(**SWIN7, int8_mlp=True, int8_attn=True)
    vq = j_quantize(jm, _params(jm, x, 3), [jnp.asarray(x)])
    want = jax.jit(jm.apply)(vq, jnp.asarray(x))
    tm = _port(SwinTransformer(**SWIN7, int8_attn=True, int8_mlp=True), vq)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert _cosine(got.pooled, want.pooled).min() >= 0.9995
    assert _cosine(got.tokens, want.tokens).min() >= 0.995


def test_window7_int8_port_calibration_serves():
    """The port calibrates a window-7 Swin through its float path and then
    serves it: the attention halves on the torch int8 ops, the MLP halves
    on K3's plain version; pooled features within a cosine of 0.999 of the
    float model's (measured 0.99987)."""
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 56, 56, 3)).astype(np.float32))
    jm = JSwin(**SWIN7)
    v = _params(jm, x.numpy(), 4)
    tf = _port(SwinTransformer(**SWIN7), v)
    t8 = _port(SwinTransformer(**SWIN7, int8_attn=True, int8_mlp=True), v)
    quant = quantize_for_serving(t8, [x])
    assert set(quant["stage0_block1"]) >= {"attn_a_q", "attn_wqkv_q", "mlp"}
    with torch.inference_mode():
        want, got = tf(x).pooled, t8(x).pooled
    assert _cosine(got, want).min() >= 0.999


def _jax_convnext_block(dim):
    return jconvnext.ConvNeXtBlock(dim=dim, int8_mlp=True)


def test_convnext_int8_block_matches_jax_fused_residual():
    """One ConvNeXt block, w8a8, f32: the port's dwconv -> K3's plain
    version with the pre-dwconv stream as the residual against JAX's
    `Mlp(fused=..., fused_residual=x)` XLA path: max |error| within 1e-4 of
    the output's scale and cosine 0.99999 per position (measured 6.1e-8
    and 0.9999999); and K3's residual is the pre-dwconv stream, not the
    dwconv's output (the branch alone, output minus x, at cosine 0.9999;
    measured 0.9999998)."""
    dim = 32
    x = np.random.default_rng(7).normal(size=(2, 8, 8, dim)).astype(
        np.float32)
    jm = _jax_convnext_block(dim)
    vq = j_quantize(jm, _params(jm, x, 7), [jnp.asarray(x)])
    want = np.asarray(jax.jit(jm.apply)(vq, jnp.asarray(x)))
    tm = _port(ConvNeXtBlock(dim, int8_mlp=True), vq)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err
    assert _cosine(got, want).min() >= 0.99999
    # the residual is x: subtracting it leaves gamma * MLP, which the
    # dwconv's output as the residual would not
    branch = got.numpy() - x
    assert _cosine(torch.from_numpy(branch), want - x).min() >= 0.9999


def test_convnext_int8_model_matches_jax_fallback():
    """A whole tiny ConvNeXt, w8a8 channel MLPs, f32, against JAX's
    fallback: pooled and per-position cosines 0.99999 (measured 0.9999999
    and 0.9999998)."""
    x = np.random.default_rng(8).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    jm = jconvnext.ConvNeXt(**CONVNEXT, int8_mlp=True)
    vq = j_quantize(jm, _params(jm, x, 8), [jnp.asarray(x)])
    want = jax.jit(jm.apply)(vq, jnp.asarray(x))
    tm = _port(ConvNeXt(**CONVNEXT, int8_mlp=True), vq)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert _cosine(got.pooled, want.pooled).min() >= 0.99999
    assert _cosine(got.tokens, want.tokens).min() >= 0.99999


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_convnext_port_calibration_matches_jax():
    """The port's ConvNeXt calibration (the `Mlp`s' `a_in`, `a_mid` on the
    float path) and weight quantization against JAX's: the same keys,
    scales to 1e-5 relative, int8 kernels equal but for rare .5 ties; the
    calibrated model then serves (K3's plain version) near the float
    model (pooled cosine 0.999, measured 0.99995)."""
    x = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jm = jconvnext.ConvNeXt(**CONVNEXT, int8_mlp=True)
    v = _params(jm, x, 9)
    want = _flat(j_quantize(jm, v, [jnp.asarray(x)])["quant"])
    tm = _port(ConvNeXt(**CONVNEXT, int8_mlp=True), v)
    got = _flat(quantize_for_serving(tm, [torch.from_numpy(x)]))
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=str(k))
    tf = _port(ConvNeXt(**CONVNEXT), v)
    with torch.inference_mode():
        pooled, pooled8 = tf(torch.from_numpy(x)).pooled, \
            tm(torch.from_numpy(x)).pooled
    assert _cosine(pooled8, pooled).min() >= 0.999


@pytest.mark.parametrize("family,variant", [
    ("swin", "tiny-224"), ("swin", "base-224"), ("swin", "base-384"),
    ("convnext", "base-224"), ("dinov2", "base-14")])
def test_check_int8_serving_allows_every_jax_family(family, variant):
    check_int8_serving(ModelConfig(family=family, variant=variant))


def test_check_int8_serving_refuses_efficientnet():
    with pytest.raises(ValueError, match="no int8 serving path"):
        check_int8_serving(ModelConfig(family="efficientnet", variant="b0"))
