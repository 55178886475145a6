"""The port's whole int8 DinoV2Salad against the JAX package on the CPU,
both sides holding the same weights and the same JAX-calibrated "quant"
collection (carried over by `state_dict_from_flax`).

Descriptor cosine bounds are set from measured values with a margin: the
two sides quantize the same values but round a few of them on the other
side of an int8 boundary (K2's softmax is formed the kernel's way in the
port and normalised first in JAX's fallback; K3's LN scale is folded in
the port, multiplied apart in JAX's fallback), and each flip moves the
activations it feeds by a dequant step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import geovpr.models.salad as jsalad
import geovpr.ops.pallas_mhsa as pmhsa
from geovpr.models.quantize import quantize_for_serving as j_quantize
from geovpr.models.salad import DinoV2Salad as JDinoV2Salad
from geovpr_torch.models import salad as tsalad
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.salad import DinoV2Salad
from torch_int8_modes import MODES, set_int8_mode

TINY = dict(hidden_size=64, num_layers=2, num_heads=4)


def _perturbed_params(model, x, seed=0):
    rng = np.random.default_rng(seed)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
            np.float32) * 0.05, v["params"])}


def _cosine(got, want):
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    return (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                              * np.linalg.norm(w, axis=-1))


def _port_model(variant, image_size, dtype, variables):
    tm = DinoV2Salad(variant=variant, image_size=image_size, dtype=dtype,
                     int8_attn=True, int8_mlp=True)
    tm.load_state_dict(state_dict_from_flax(variables))
    return tm.eval()


@pytest.mark.parametrize("mode", MODES)
def test_int8_model_f32_matches_jax_fallback(monkeypatch, mode):
    """f32, JAX on its XLA fallbacks (`_attention_int8`, the fused `Mlp`
    branch, int8 SALAD fc1s), each side folding the attention in `mode`;
    measured min cosine 0.99985 (int8 P.V 0.99989, bf16 scores 0.99987)
    -> bound 0.9995."""
    set_int8_mode(monkeypatch, mode)
    monkeypatch.setitem(jsalad.DINOV2_VARIANTS, "tiny", TINY)
    monkeypatch.setitem(tsalad.DINOV2_VARIANTS, "tiny", TINY)
    x = np.random.default_rng(5).normal(size=(3, 28, 28, 3)).astype(
        np.float32)
    jm = JDinoV2Salad(variant="tiny", image_size=28, int8_mlp=True,
                      int8_attn=True)
    vq = j_quantize(jm, _perturbed_params(jm, x), [jnp.asarray(x)])
    want = jm.apply(vq, jnp.asarray(x)).pooled
    tm = _port_model("tiny", 28, torch.float32, vq)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).pooled
    assert got.shape == want.shape == (3, 8448)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert _cosine(got, want).min() >= 0.9995


@pytest.mark.parametrize("mode", MODES)
def test_int8_model_bf16_matches_jax_kernels(monkeypatch, mode):
    """bf16 at 257 tokens (patch 2 on 32x32 images), JAX's int8 kernels K2
    and K3 interpreted with the backend reported as "tpu", so its resident
    padding is active (the stream runs padded to 272 rows); the port's plain
    versions run unpadded; each side folds the attention in `mode`.
    Measured min cosine 0.99998 in each mode -> bound 0.9995."""
    set_int8_mode(monkeypatch, mode)
    variant = dict(TINY, patch_size=2)
    monkeypatch.setitem(jsalad.DINOV2_VARIANTS, "tiny257", variant)
    monkeypatch.setitem(tsalad.DINOV2_VARIANTS, "tiny257", variant)
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jm = JDinoV2Salad(variant="tiny257", image_size=32, int8_mlp=True,
                      int8_attn=True, dtype=jnp.bfloat16)
    vq = j_quantize(jm, _perturbed_params(jm, x), [jnp.asarray(x)])

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    seen = []
    k2 = pmhsa.fused_mhsa_block_int8

    def spy(x_, *a, **k):
        seen.append((x_.shape, k.get("n_valid")))
        return k2(x_, *a, **k)

    monkeypatch.setattr(pmhsa, "fused_mhsa_block_int8", spy)
    want = jm.apply(vq, jnp.asarray(x)).pooled
    assert seen == [((2, 272, 64), 257)] * 2   # resident padding, K2 ran

    tm = _port_model("tiny257", 32, torch.bfloat16, vq)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).pooled
    assert got.shape == want.shape == (2, 8448)
    assert _cosine(got, want).min() >= 0.9995
