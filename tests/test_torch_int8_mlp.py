"""The w8a8 `Mlp` called on its own, outside its block's K3 route: the
port's `models/layers.py::Mlp(int8=True)` against flax's
`geovpr.models.layers.Mlp(int8=True)` on the same "quant" buffers, which
off the TPU runs JAX's unfused arithmetic (`geovpr/models/layers.py:
168-182`): `int8_dense` -> tanh GELU in f32 -> `int8_dense`, returned in
x's dtype.

The int8 products are exact on both sides. The two frameworks' tanh GELU
differ in the last bits, and such a difference can land a hidden value on
the other side of an int8 rounding: that moves an output by |w_q| dequant
steps of fc2, up to 127. So an f32 output agrees within 1e-5 of its scale
but where a hidden value flipped, which at most 1% of the outputs may show
and never by more than two flips (2 x 127 x fc2's largest dequant step,
tests/test_torch_int8_f32.py's bound); bf16 outputs the same, with one
bf16 spacing of the output added.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geovpr.models import layers as jlayers
from geovpr_torch.models import layers


def _quant(rng, d, hidden) -> dict:
    """A random "quant" collection of an int8 Mlp (d -> hidden -> d)."""
    return {
        "a_in_scale": np.float32(0.02), "a_mid_scale": np.float32(0.015),
        "fc1_kernel_q": rng.integers(-127, 128, (d, hidden)).astype(np.int8),
        "fc1_kernel_scale": rng.uniform(2e-4, 1e-3, hidden).astype(np.float32),
        "fc1_bias": rng.normal(0, 0.1, hidden).astype(np.float32),
        "fc2_kernel_q": rng.integers(-127, 128, (hidden, d)).astype(np.int8),
        "fc2_kernel_scale": rng.uniform(2e-4, 1e-3, d).astype(np.float32),
        "fc2_bias": rng.normal(0, 0.1, d).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_mlp_alone_matches_flax(dtype):
    rng = np.random.default_rng(7)
    d, hidden = 64, 256
    x = rng.normal(0, 1, (2, 33, d)).astype(np.float32)
    q = _quant(rng, d, hidden)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    jm = jlayers.Mlp(hidden_dim=hidden, dtype=jdt, int8=True)
    xj = jnp.asarray(x).astype(jdt)
    params = jm.init(jax.random.PRNGKey(0), xj)["params"]
    want = jm.apply({"params": params,
                     "quant": {k: jnp.asarray(v) for k, v in q.items()}}, xj)
    assert want.dtype == jdt

    tm = layers.Mlp(d, hidden, dtype=tdt, int8=True)
    with torch.no_grad():
        for k, v in q.items():
            getattr(tm, k).copy_(torch.from_numpy(np.asarray(v)))
        got = tm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape

    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    step = float(q["a_mid_scale"]) * float(q["fc2_kernel_scale"].max())
    spacing = (np.abs(want) * 2.0 ** -7).max() if dtype == "bfloat16" else 0.0
    err = np.abs(got - want)
    assert np.isfinite(got).all()
    assert err.max() <= 2 * 127 * step + spacing, err.max()
    off = (err > 1e-5 * np.abs(want).max() + spacing).mean()
    assert off <= 0.01, off
