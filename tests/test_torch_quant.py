"""The port's int8 quantization primitives, calibration and the weight
bridge's "quant" collection, against the JAX package on the CPU.

Bit-equal where both sides compute the same f32 numpy or integer
arithmetic (weight and row quantization, int8 products); calibrated
activation scales are amaxes of f32 activations that the two frameworks
compute with different summation orders, so they agree to ~1e-6 relative
and are held to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.salad as jsalad
from geovpr.models.quantize import quantize_for_serving as j_quantize
from geovpr.models.salad import DinoV2Salad as JDinoV2Salad
from geovpr.ops import quant as jquant
from geovpr.retrieval.index import _quantize_rows as j_quantize_rows
from geovpr_torch.models import salad as tsalad
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.quantize import quantize_for_serving
from geovpr_torch.models.salad import DinoV2Salad
from geovpr_torch.ops import quant as tquant
from geovpr_torch.retrieval.index import quantize_rows

TINY = dict(hidden_size=64, num_layers=2, num_heads=4)


@pytest.fixture
def tiny_variant(monkeypatch):
    """A 2-layer, width-64 DINOv2 variant registered in both packages."""
    monkeypatch.setitem(jsalad.DINOV2_VARIANTS, "tiny", TINY)
    monkeypatch.setitem(tsalad.DINOV2_VARIANTS, "tiny", TINY)
    return "tiny"


def _perturbed_params(model, x, seed=0):
    """flax init with every leaf perturbed, so zero biases and unit scales
    cannot hide a mapping error; returns numpy {"params": ...}."""
    rng = np.random.default_rng(seed)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
            np.float32) * 0.05, v["params"])}


@pytest.mark.parametrize("shape", [(16, 24), (7, 3)])
def test_quantize_weight_is_bit_equal(shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w[:, 0] = 0.0                       # an all-zero column
    jq, js = jquant.quantize_weight(w)
    tq, ts = tquant.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_rows_and_int8_dense_are_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(9, 40)).astype(np.float32)
    x[3] = 0.0                          # zero row: scale 1
    x[4, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]  # .5 cases round to even
    jq, js = j_quantize_rows(jnp.asarray(x))
    tq, ts = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    wq, ws = jquant.quantize_weight(rng.normal(size=(40, 24)))
    bias = rng.normal(size=24).astype(np.float32)
    a = np.float32(0.02)
    want = jquant.int8_dense(jnp.asarray(x), jnp.asarray(a), wq, ws,
                             jnp.asarray(bias))
    got = tquant.int8_dense(torch.from_numpy(x), torch.tensor(a),
                            torch.from_numpy(np.array(wq)),
                            torch.from_numpy(np.array(ws)),
                            torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), (v.numpy() if isinstance(v, torch.Tensor)
                                  else np.asarray(v))


def test_quantize_for_serving_matches_jax(tiny_variant):
    """Same f32 weights, same calibration batch: the same "quant" tree, int8
    kernels bit-equal, activation scales within 1e-4 relative."""
    x = np.random.default_rng(2).normal(size=(2, 28, 28, 3)).astype(
        np.float32)
    jm = JDinoV2Salad(variant=tiny_variant, image_size=28, int8_mlp=True,
                      int8_attn=True)
    variables = _perturbed_params(jm, x)
    want = dict(_flat(j_quantize(jm, variables, [jnp.asarray(x)])["quant"]))

    tm = DinoV2Salad(variant=tiny_variant, image_size=28, int8_attn=True,
                     int8_mlp=True)
    tm.load_state_dict(state_dict_from_flax(variables), strict=False)
    got = dict(_flat(quantize_for_serving(tm, [torch.from_numpy(x)])))
    assert got.keys() == want.keys()
    n_int8 = 0
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.dtype == np.int8 or w.ndim:
            np.testing.assert_array_equal(g, w, err_msg=str(key))
            n_int8 += w.dtype == np.int8
        else:                           # calibrated activation scale
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=str(key))
    assert n_int8 == 2 * 4 + 2          # 2 blocks x 4 kernels, 2 SALAD fc1s


def test_bridge_keeps_the_quant_collection(tiny_variant):
    """`state_dict_from_flax` carries the JAX quant collection into the
    port's buffers with dtypes, shapes and values kept, and loading it
    folds the kernels' arguments."""
    x = np.random.default_rng(3).normal(size=(1, 28, 28, 3)).astype(
        np.float32)
    jm = JDinoV2Salad(variant=tiny_variant, image_size=28, int8_mlp=True,
                      int8_attn=True)
    vq = j_quantize(jm, _perturbed_params(jm, x), [jnp.asarray(x)])
    sd = state_dict_from_flax(vq)
    checked = 0
    for path, arr in _flat(vq["quant"]):
        name = ".".join(f"blocks.{p[5:]}" if p.startswith("block") else p
                        for p in path)
        t = sd[name]
        assert t.numpy().dtype == arr.dtype, name
        assert tuple(t.shape) == arr.shape, name
        np.testing.assert_array_equal(t.numpy(), arr)
        checked += 1
    assert sd["backbone.blocks.1.mlp.fc1_kernel_q"].dtype == torch.int8
    assert sd["backbone.blocks.0.attn_a_x"].dim() == 0
    assert checked == 2 * (9 + 8) + 7
    tm = DinoV2Salad(variant=tiny_variant, image_size=28, int8_attn=True,
                     int8_mlp=True)
    tm.load_state_dict(sd)
    blk = tm.backbone.blocks[1]
    assert blk._k2 is not None and blk._k3 is not None
    np.testing.assert_array_equal(
        blk._k3_w1q_t.numpy(),
        np.asarray(vq["quant"]["backbone"]["block1"]["mlp"]["fc1_kernel_q"]).T)


@pytest.mark.parametrize("env, want", [
    ({}, (True, False)),
    ({"GEOVPR_INT8_PV": "1"}, (True, True)),
    ({"GEOVPR_INT8_QK": "0"}, (False, False)),
    ({"GEOVPR_INT8_QK": "0", "GEOVPR_INT8_PV": "1"}, (False, False)),
])
def test_mode_variables_set_the_jax_flags(env, want):
    """The environment variables give the port the mode flags JAX's give
    it, read when each `quant` module is imported: a fresh process per
    setting, the two packages side by side; int8 P.V needs int8 scores."""
    import os
    import subprocess
    import sys

    code = ("import geovpr.ops.quant as j, geovpr_torch.ops.quant as t; "
            "print(j.INT8_QK_SCORES, j.INT8_PV, t.INT8_QK_SCORES, t.INT8_PV)")
    base = {k: v for k, v in os.environ.items()
            if k not in ("GEOVPR_INT8_QK", "GEOVPR_INT8_PV")}
    out = subprocess.run([sys.executable, "-c", code], env={**base, **env},
                         capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    flags = out.stdout.split()
    assert flags[:2] == flags[2:] == [str(w) for w in want], out.stdout


def test_attn_mode_of_the_folded_constants():
    assert tquant.attn_mode(0.1, None) == "int8_scores"
    assert tquant.attn_mode(0.1, 0.2) == "int8_pv"
    assert tquant.attn_mode(None, None) == "bf16_scores"
    with pytest.raises(ValueError, match="needs int8 scores"):
        tquant.attn_mode(None, 0.2)
    assert tquant.ATTN_MODES.index("int8_scores") == 0
