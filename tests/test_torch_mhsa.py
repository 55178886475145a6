"""The port's fused attention half-block (K1) against the JAX package.

The plain version `mhsa_block_reference`, and `fused_mhsa_block` on CPU
tensors, are held to JAX `fused_mhsa_block` run through its Pallas bodies in
interpret mode (N=17 takes the masked `_mhsa_kernel`, N=129 = 128+1 the
key-split `_mhsa_kernel_v3`) and to the oracle `_mhsa_block_xla`. The CUDA
kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import geovpr.ops.pallas_mhsa as pm
from geovpr_torch.ops.mhsa import fused_mhsa_block, mhsa_block_reference

B, D, H = 2, 32, 2


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    return dict(x=r(B, n, D), ln_scale=r(D, scale=0.1, shift=1.0),
                ln_bias=r(D, scale=0.1), wqkv=r(D, 3 * D, scale=0.3),
                bqkv=r(3 * D, scale=0.1), wo=r(D, D, scale=0.3),
                bo=r(D, scale=0.1), gamma=r(D, scale=0.5))


_ORDER = ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wo", "bo", "gamma")
_LOW = ("x", "wqkv", "wo")       # held in the compute dtype; vectors in f32


def _jax_args(inp, dtype):
    return [jnp.asarray(inp[k]).astype(dtype if k in _LOW else jnp.float32)
            for k in _ORDER]


def _torch_args(inp, dtype):
    return [torch.from_numpy(inp[k]).to(dtype if k in _LOW else torch.float32)
            for k in _ORDER]


# f32: both sides compute the same f32 arithmetic (JAX at "highest" matmul
# precision, see conftest), so only summation order differs -> 2e-5.
# bf16: both round LN output, qkv, probabilities and ctx to bf16, but the
# key-split v3 body orders its softmax differently (exp2, deferred
# normalisation), so a rounding can land one bf16 ulp apart; |out| <= ~8
# here, where one ulp is 2^-5 = 0.031 (measured: 0.031 at N=129, 0 at
# N=17) -> 0.05.
_TOL = {"float32": 2e-5, "bfloat16": 0.05}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [17, 129])
def test_reference_matches_jax_pallas_kernel(monkeypatch, n, dtype):
    orig = pl.pallas_call
    monkeypatch.setattr(pm.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    inp = _inputs(n)
    want = pm.fused_mhsa_block(*_jax_args(inp, getattr(jnp, dtype)),
                               num_heads=H)
    want = np.asarray(want.astype(jnp.float32))
    got = mhsa_block_reference(*_torch_args(inp, getattr(torch, dtype)), H)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 17, 129])
def test_reference_matches_jax_oracle(n, dtype):
    """Same rounding points and operation order as `_mhsa_block_xla`
    (measured equal in bf16); the bound is one bf16 ulp at |out| <= ~8."""
    inp = _inputs(n, seed=1)
    want = pm._mhsa_block_xla(*_jax_args(inp, getattr(jnp, dtype)),
                              num_heads=H, ln_eps=1e-6)
    want = np.asarray(want.astype(jnp.float32))
    got = mhsa_block_reference(*_torch_args(inp, getattr(torch, dtype)), H)
    tol = 2e-5 if dtype == "float32" else 2.0 ** -5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wrapper_on_cpu_runs_the_plain_version(dtype):
    """On CPU tensors, bf16 or f32 (the two forms K1 has on the card), the
    wrapper runs the plain version and counts no launch."""
    args = _torch_args(_inputs(17, seed=2), getattr(torch, dtype))
    before = fused_mhsa_block.launches
    got = fused_mhsa_block(*args, num_heads=H)
    assert fused_mhsa_block.launches == before   # no kernel on the CPU
    assert torch.equal(got, mhsa_block_reference(*args, H))


@pytest.mark.parametrize("bad", ["wqkv_shape", "heads", "rank", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    args = _torch_args(_inputs(5, seed=3), torch.float32)
    heads = H
    if bad == "wqkv_shape":
        args[3] = args[3][:, :D]
    elif bad == "heads":
        heads = 3
    elif bad == "rank":
        args[0] = args[0][0]
    else:
        args[1] = args[1].to("meta")
    with pytest.raises(ValueError):
        fused_mhsa_block(*args, num_heads=heads)
