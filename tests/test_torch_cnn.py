"""The port's EfficientNet-B0 and ConvNeXt against the JAX modules on the
CPU, the same weights on both sides through the weight bridge: random
values of flax init's shapes for every parameter, and for EfficientNet
random running statistics (`batch_stats` means off 0, variances off 1), so
that every BatchNorm input matters.

- EfficientNet-B0 at its full widths on 32 x 32 images, ConvNeXt with its
  depths and widths shrunk (two stages) on 32 x 32 images; f32 and bf16;
- the bridge: `batch_stats` carried into the BatchNorm buffers, depthwise
  kernels (kh, kw, 1, C) through the same 4-D transpose as any conv, the
  squeeze-excite 1x1 convs, ConvNeXt's `gamma`; `strict` loading with
  nothing missing or left over;
- flax's "SAME" padding of ConvNeXt's stem and downsample convs is zero at
  the supported image size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geovpr.models.convnext import ConvNeXt as JConvNeXt
from geovpr.models.efficientnet import EfficientNetB0 as JEfficientNet
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.convnext import ConvNeXt
from geovpr_torch.models.efficientnet import EfficientNetB0

TINY_CONVNEXT = dict(depths=(1, 2), dims=(32, 64))


def _images(b, size, seed):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(
        np.float32)


def _variables(jm, x, seed):
    """Random variables of the shapes flax's init gives, traced with
    `jax.eval_shape` and never compiled (compiling EfficientNet's init
    costs ~10 s a process): kernels N(0, 1/fan_in), norm scales 1 +
    N(0, 0.05^2), other parameters N(0, 0.05^2), running means N(0, 0.1^2)
    and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed),
                            jnp.asarray(x[:1]))

    def draw(path, a):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        v = rng.normal(size=a.shape).astype(np.float32)
        if name == "kernel":
            return v / np.float32(np.sqrt(np.prod(a.shape[:-1])))
        return v * 0.1 if name == "mean" else v * 0.05 + (name == "scale")
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _port(cls, kwargs, variables, dtype):
    tm = cls(**kwargs, dtype=dtype)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return tm.eval()


def _cosine(got, want):
    g = got.float().numpy().reshape(got.shape[0], -1)
    w = np.asarray(want, np.float32).reshape(g.shape)
    return (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                              * np.linalg.norm(w, axis=-1))


CASES = {
    "efficientnet": (JEfficientNet, EfficientNetB0, {}, 32),
    "convnext": (JConvNeXt, ConvNeXt, TINY_CONVNEXT, 32),
}


@functools.lru_cache(maxsize=None)
def _case(family):
    """Images and random variables of one family, made once per test
    process."""
    jcls, _, kwargs, size = CASES[family]
    x = _images(2, size, 0)
    return x, _variables(jcls(**kwargs), x, 0)


# f32: the same arithmetic (BatchNorm as one scale and shift in torch, as
# (x - mean) * scale + bias in flax), 16 and 3 blocks deep -> 1e-5 on
# features of size <= ~4 (measured 2.1e-7 and 7.2e-7). bf16: both sides
# round every conv output (flax before its bias add, torch after it), so
# single elements move by a few bf16 steps -> cosine >= 0.9999 on the
# pooled features and the token maps (measured 0.999998 and 0.99998).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["efficientnet", "convnext"])
def test_matches_jax(family, dtype):
    jcls, tcls, kwargs, _ = CASES[family]
    x, v = _case(family)
    want = jax.jit(jcls(**kwargs, dtype=getattr(jnp, dtype)).apply)(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = _port(tcls, kwargs, v, getattr(torch, dtype))(
            torch.from_numpy(x))
    assert got.pooled.dtype == torch.float32
    assert got.pooled.shape == want.pooled.shape
    assert got.tokens.shape == want.tokens.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.pooled.numpy(),
                                   np.asarray(want.pooled), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.tokens.numpy(),
                                   np.asarray(want.tokens), rtol=0, atol=1e-5)
    else:
        assert _cosine(got.pooled, want.pooled).min() >= 0.9999
        assert _cosine(got.tokens, want.tokens).min() >= 0.9999


def test_bridge_carries_batch_stats_and_depthwise_kernels():
    """`strict=True` in `_port`: every parameter and buffer came from the
    flax tree. Spot checks of the layouts."""
    _, v = _case("efficientnet")
    sd = _port(EfficientNetB0, {}, v, torch.float32).state_dict()
    p, bs = v["params"], v["batch_stats"]
    blk = p["stage1_block0"]
    np.testing.assert_array_equal(          # depthwise (3, 3, 1, 96)
        sd["stage1_block0.dw.conv.weight"].numpy(),
        np.transpose(blk["dw"]["conv"]["kernel"], (3, 2, 0, 1)))
    assert sd["stage1_block0.dw.conv.weight"].shape == (96, 1, 3, 3)
    np.testing.assert_array_equal(
        sd["stage1_block0.se.fc1.weight"].numpy()[:, :, 0, 0],
        blk["se"]["fc1"]["kernel"][0, 0].T)
    np.testing.assert_array_equal(sd["stage1_block0.se.fc2.bias"].numpy(),
                                  blk["se"]["fc2"]["bias"])
    np.testing.assert_array_equal(
        sd["stage1_block0.project.bn.running_var"].numpy(),
        bs["stage1_block0"]["project"]["bn"]["var"])
    np.testing.assert_array_equal(sd["head.bn.running_mean"].numpy(),
                                  bs["head"]["bn"]["mean"])
    np.testing.assert_array_equal(sd["stem.bn.weight"].numpy(),
                                  p["stem"]["bn"]["scale"])

    _, v = _case("convnext")
    sd = _port(ConvNeXt, TINY_CONVNEXT, v, torch.float32).state_dict()
    p = v["params"]
    np.testing.assert_array_equal(          # depthwise (7, 7, 1, 64)
        sd["stage1_block1.dwconv.weight"].numpy(),
        np.transpose(p["stage1_block1"]["dwconv"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["stage1_block1.gamma"].numpy(),
                                  p["stage1_block1"]["gamma"])
    np.testing.assert_array_equal(sd["downsample1_conv.weight"].numpy(),
                                  np.transpose(p["downsample1_conv"]["kernel"],
                                               (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["pool_norm.weight"].numpy(),
                                  p["pool_norm"]["scale"])


def test_convnext_same_padding_is_zero():
    """flax's "SAME" for the stem (k4/s4) and the downsamples (k2/s2) at
    224 x 224, the padding-free convs of the port."""
    side = 224
    pads = [jax.lax.padtype_to_pads((side, side), (4, 4), (4, 4), "SAME")]
    side //= 4
    for _ in range(3):
        pads.append(jax.lax.padtype_to_pads((side, side), (2, 2), (2, 2),
                                            "SAME"))
        side //= 2
    assert all(tuple(p) == ((0, 0), (0, 0)) for p in pads), pads
    tm = ConvNeXt(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))
    assert tm.stem.padding == (0, 0) and tm.downsample3_conv.padding == (0, 0)
    assert tm.pool_norm.eps == 1e-12 and tm.stage0_block0.norm.eps == 1e-6


@pytest.mark.parametrize("padding", ["torch", "tf"])
def test_conv_bn_act_padding_matches_jax(padding):
    """`ConvBNAct` in both padding modes against flax's at a stride-2
    depthwise 5x5 (the "tf" mode pads (1, 2) a side there), f32, perturbed
    running statistics; same arithmetic -> 1e-5."""
    from geovpr.models.efficientnet import ConvBNAct as JConvBNAct
    from geovpr_torch.models.layers import ConvBNAct
    x = _images(2, 12, 3)[..., :1].repeat(8, axis=-1)
    jm = JConvBNAct(8, 5, stride=2, groups=8, conv_padding=padding)
    v = _variables(jm, x, 3)
    want = jm.apply(v, jnp.asarray(x))
    tm = ConvBNAct(8, 8, 5, stride=2, groups=8, conv_padding=padding)
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
