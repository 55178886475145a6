"""The port's whole SwinTransformer against the JAX model on the CPU, the
same (perturbed) weights on both sides through the weight bridge.

- f32, the port's plain path against the JAX model's XLA path;
- f32, against the JAX kernel path: its Pallas kernels interpreted with the
  backend reported as "tpu", so the alternating window layout and the fused
  PatchMerging kernel are on (the configuration of tests/test_swin.py's
  alternating-layout test, and a three-stage one at window 4);
- int8 (w8a8), the JAX "quant" collection carried across by the bridge:
  against the JAX int8 fallback in f32 and against its int8 kernels (K5,
  K3, the fused boundary) interpreted in bf16; and the port's own
  calibration against `geovpr.models.quantize.quantize_for_serving` on the
  same images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from geovpr.models.quantize import quantize_for_serving as j_quantize
from geovpr.models.swin import SwinTransformer as JSwin
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.quantize import quantize_for_serving
from geovpr_torch.models.swin import LN_EPS, SwinTransformer
from torch_int8_modes import MODES, set_int8_mode

SMALL = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=4,
             image_size=32)
KERNEL2 = dict(embed_dim=128, depths=(2, 2), num_heads=(4, 8),
               window_size=12, image_size=96)
KERNEL3 = dict(embed_dim=128, depths=(2, 2, 2), num_heads=(4, 8, 16),
               window_size=4, image_size=64)


@pytest.fixture
def jax_kernels(monkeypatch):
    """JAX's serving kernels interpreted, with the backend gate reporting a
    TPU (the alternating layout and the fused merge default on)."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _images(cfg, b, seed):
    s = cfg["image_size"]
    return np.random.default_rng(seed).normal(size=(b, s, s, 3)).astype(
        np.float32)


def _params(jm, x, seed):
    """JAX init plus noise, so that no LayerNorm is the identity and the
    relative-position tables are not zero."""
    rng = np.random.default_rng(seed)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
            np.float32) * 0.05, v["params"])}


def _port(cfg, variables, dtype=torch.float32, int8=False):
    tm = SwinTransformer(**cfg, dtype=dtype, int8_attn=int8, int8_mlp=int8)
    res = tm.load_state_dict(state_dict_from_flax(variables), strict=False)
    params = {n for n, _ in tm.named_parameters()}
    assert not res.unexpected_keys
    assert not [k for k in res.missing_keys if k in params]
    return tm.eval()


def _cosine(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                              * np.linalg.norm(w, axis=-1))


def test_ln_eps_is_swins():
    """Swin's LayerNorms use eps 1e-5 (geovpr/models/swin.py:52), not
    DINOv2's 1e-6 (ROADMAP Queue 3)."""
    from geovpr.models import swin as jswin
    from geovpr_torch.models import dinov2
    assert LN_EPS == jswin.LN_EPS == 1e-5 and dinov2.LN_EPS == 1e-6
    tm = SwinTransformer(**SMALL)
    eps = {m.eps for m in tm.modules() if hasattr(m, "eps")}
    assert eps == {1e-5}


def test_f32_plain_path_matches_jax_xla_path():
    """Both sides in f32; the port runs its kernels' plain versions (the
    serving softmax: exp2, no max-shift), JAX its XLA path (max-shifted
    softmax); same function to f32 rounding -> 1e-4."""
    x = _images(SMALL, 2, 0)
    jm = JSwin(**SMALL)
    v = _params(jm, x, 0)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = _port(SMALL, v)(torch.from_numpy(x))
    assert got.tokens.shape == want.tokens.shape == (2, 16, 64)
    np.testing.assert_allclose(got.tokens.numpy(), np.asarray(want.tokens),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.pooled.numpy(), np.asarray(want.pooled),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("cfg", [KERNEL2, KERNEL3], ids=["2stage", "3stage"])
def test_f32_matches_jax_kernel_path(jax_kernels, cfg):
    """JAX with its serving kernels (K4 rolled, alternating layout, fused
    PatchMerging) against the port's raster layout, f32: the same
    arithmetic in another order (measured max 5.3e-6) -> 5e-5."""
    x = _images(cfg, 1, 1)
    jm = JSwin(**cfg, drop_path_rate=0.0)
    v = _params(jm, x, 1)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = _port(cfg, v)(torch.from_numpy(x))
    np.testing.assert_allclose(got.tokens.numpy(), np.asarray(want.tokens),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(got.pooled.numpy(), np.asarray(want.pooled),
                               rtol=0, atol=5e-5)


def test_int8_f32_matches_jax_fallback():
    """int8, f32, JAX on its XLA fallbacks with the JAX-calibrated "quant"
    collection carried over by the bridge. The two differ where a value
    lands on the other side of an int8 rounding (the fallback rounds the
    context to bf16 before int8, the port once): cosine bounds 0.999 on the
    pooled features and 0.99 per token (measured 0.99992 and 0.99934)."""
    x = _images(SMALL, 3, 2)
    jm = JSwin(**SMALL, int8_mlp=True, int8_attn=True)
    vq = j_quantize(jm, _params(jm, x, 2), [jnp.asarray(x)])
    want = jax.jit(jm.apply)(vq, jnp.asarray(x))
    with torch.no_grad():
        got = _port(SMALL, vq, int8=True)(torch.from_numpy(x))
    assert _cosine(got.pooled, want.pooled).min() >= 0.999
    assert _cosine(got.tokens.reshape(-1, got.tokens.shape[-1]),
                   np.asarray(want.tokens).reshape(-1, 64)).min() >= 0.99


@pytest.mark.parametrize("mode", MODES)
def test_int8_bf16_matches_jax_kernels(jax_kernels, monkeypatch, mode):
    """int8 in bf16: JAX's K5, K3 and fused boundary kernels interpreted
    (alternating layout) against the port's plain versions, the JAX quant
    collection on both sides, each folding the attention in `mode`. Cosine
    bound 0.9995 on the pooled features (measured 0.99998 in each
    mode)."""
    set_int8_mode(monkeypatch, mode)
    cfg = KERNEL2
    x = _images(cfg, 1, 3)
    jm = JSwin(**cfg, drop_path_rate=0.0, int8_mlp=True, int8_attn=True,
               dtype=jnp.bfloat16)
    vq = j_quantize(jm, _params(jm, x, 3), [jnp.asarray(x)])
    want = jax.jit(jm.apply)(vq, jnp.asarray(x))
    with torch.no_grad():
        got = _port(cfg, vq, torch.bfloat16, int8=True)(torch.from_numpy(x))
    assert _cosine(got.pooled, want.pooled).min() >= 0.9995


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_port_calibration_matches_jax_quantize_for_serving():
    """The port's calibration (plain float path, amax per sow point) and
    weight quantization against JAX's on the same f32 weights and images:
    the same keys; scales to 1e-5 relative (f32 reductions in another
    order); int8 kernels equal but for rare .5 ties (at most 0.1% of the
    entries one step apart)."""
    x = _images(SMALL, 2, 4)
    jm = JSwin(**SMALL, int8_mlp=True, int8_attn=True)
    v = _params(jm, x, 4)
    want = _flat(j_quantize(jm, v, [jnp.asarray(x)])["quant"])
    tm = _port(SMALL, v, int8=True)
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
