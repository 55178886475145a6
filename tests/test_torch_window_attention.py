"""Kernel K7's plain version (`window_attention_serving_reference`), its
wrapper on CPU tensors, and the whole window-7 Swin against the JAX
package on the CPU.

- K7: against `window_attention_pallas` interpreted (as
  tests/test_pallas_ops.py runs it) and against `_window_attention_xla`, in
  f32 and bf16, N = 49 (dh 32, BW a multiple of 8, so that `_pick_wb` takes
  the kernel and not its XLA fallback), with the shift mask (wb | nW, and
  tiled, nW | wb) and without;
- the whole Swin at window 7 (two stages: a shifted block, then a stage one
  window wide), the same perturbed weights through the bridge: f32 against
  the XLA path, and f32 and bf16 against the JAX kernel path (backend
  reported as "tpu", `pallas_call` interpreted), where every block's
  attention must have reached K7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import geovpr.ops.pallas_window_attention as pwa
from geovpr.models.swin import SwinTransformer as JSwin
from geovpr.models.swin import shifted_window_mask
from geovpr.ops.window_attention import _window_attention_xla
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.swin import SwinTransformer
from geovpr_torch.ops.window_attention import (
    window_attention_kernel, window_attention_serving_reference)

H, N, DH = 2, 49, 32
SWIN7 = dict(embed_dim=64, depths=(2, 2), num_heads=(2, 4), window_size=7,
             image_size=56)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _case(bw, masked_nw, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bw, H, N, DH)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(H, N, N)).astype(np.float32)
    mask = None
    if masked_nw:
        side = 7 * int(round(masked_nw ** 0.5))
        mask = shifted_window_mask(side, side, 7, 3)
        assert mask.shape[0] == masked_nw
    return q, k, v, bias, mask


def _run_both(q, k, v, bias, mask, dtype):
    jl = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))  # noqa: E731
    jmask = None if mask is None else jnp.asarray(mask)
    want = pwa.window_attention_pallas(jl(q), jl(k), jl(v), jnp.asarray(bias),
                                       jmask, 1.0 / DH ** 0.5)
    xla = _window_attention_xla(jl(q), jl(k), jl(v), jnp.asarray(bias),
                                jmask, 1.0 / DH ** 0.5)
    tl = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    got = window_attention_serving_reference(
        tl(q), tl(k), tl(v), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == getattr(torch, dtype)
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            np.asarray(xla.astype(jnp.float32)))


# Tolerances. f32: the same arithmetic in another summation order, |out| <=
# ~3 -> 1e-5 against the kernel (measured 7e-7) and 1e-5 against XLA's
# max-shifted softmax (measured 1.4e-6). bf16 against the kernel: the same
# rounding points (q twice, P, the context); a reduction ordered otherwise
# can move a rounding by one bf16 step at |out| <= ~2 (2^-7, measured in
# 0.004% of the elements) -> 0.01, and at most 0.1% of the elements off.
# bf16 against XLA: XLA rounds q once and P after the max-shift and the
# normalisation, which moves outputs by a few bf16 steps -> 0.05.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,nw", [(16, 0), (16, 4), (32, 16)],
                         ids=["nomask", "mask_tiled", "mask_slab"])
def test_k7_plain_matches_jax_kernel(interpret, dtype, bw, nw):
    picked = []
    orig = pwa._pick_wb
    pwa._pick_wb = lambda *a: picked.append(orig(*a)) or picked[-1]
    try:
        got, want, xla = _run_both(*_case(bw, nw, seed=bw + nw), dtype)
    finally:
        pwa._pick_wb = orig
    assert picked == [8], "the JAX call took its XLA fallback"
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 1e-5, err.max()
        assert np.abs(got - xla).max() <= 1e-5
    else:
        assert err.max() <= 0.01, err.max()
        assert (err > 0).mean() <= 1e-3
        assert np.abs(got - xla).max() <= 0.05


def test_k7_wrapper_runs_plain_version_on_cpu():
    q, k, v, bias, mask = (None if a is None else torch.from_numpy(a)
                           for a in _case(8, 4, seed=3))
    before = window_attention_kernel.launches
    got = window_attention_kernel(q, k, v, bias, mask)
    assert window_attention_kernel.launches == before
    assert torch.equal(got, window_attention_serving_reference(q, k, v, bias,
                                                               mask))


def test_k7_wrapper_checks_its_inputs():
    q, k, v, bias, mask = (None if a is None else torch.from_numpy(a)
                           for a in _case(8, 4, seed=4))
    with pytest.raises(ValueError, match="one .BW, H, N, dh. shape"):
        window_attention_kernel(q, k[:4], v, bias, mask)
    with pytest.raises(ValueError, match="bias must be"):
        window_attention_kernel(q, k, v, bias[:1], mask)
    with pytest.raises(ValueError, match="mask must be"):
        window_attention_kernel(q, k, v, bias, mask[:3])
    with pytest.raises(ValueError, match="one device"):
        window_attention_kernel(q, k, v, bias.to("meta"), mask)
    with pytest.raises(ValueError, match="unsupported device"):
        window_attention_kernel(*(t.to("meta") for t in (q, k, v, bias)),
                                None)


@pytest.mark.parametrize("nw", [0, 4], ids=["nomask", "mask"])
def test_k7_vjp_matches_jax_custom_vjp(interpret, monkeypatch, nw):
    """K7's autograd Function (the card's forward replaced by its plain
    version) against `jax.vjp` of `window_attention_pallas` interpreted,
    whose backward is its `custom_vjp`'s: the VJP of
    `_window_attention_xla`. f32, the gradients of q, k, v, the bias and
    the mask within 1e-5 of each tensor's largest element; the output
    within 1e-5. Under inference mode the Function is the forward alone."""
    from geovpr_torch.ops import window_attention as wa

    monkeypatch.setattr(wa, "_k7_split_launch",
                        wa.window_attention_serving_reference)
    q, k, v, bias, mask = _case(8, nw, seed=11)
    g = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    args = [q, k, v, bias] + ([mask] if nw else [])
    want, vjp = jax.vjp(
        lambda *a: pwa.window_attention_pallas(
            *a[:4], a[4] if nw else None, 1.0 / DH ** 0.5),
        *(jnp.asarray(a) for a in args))
    wgrads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = wa._K7Split.apply(*targs[:4], targs[4] if nw else None)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for name, t, w in zip("q k v bias mask".split(), targs, wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    with torch.inference_mode():
        out = wa._K7Split.apply(*(torch.from_numpy(a) for a in args[:4]),
                                torch.from_numpy(mask) if nw else None)
    assert torch.equal(out, got.detach())


def test_k7_raster_vjp_is_the_split_vjp_through_the_gathers(monkeypatch):
    """The raster entry's Function (forward replaced by its plain version)
    gives the gradients of qkv and of the relative-position table that
    autograd gives through the window gathers around the split entry's
    Function, bit for bit; the geometry takes none."""
    from geovpr_torch.ops import window_attention as wa

    monkeypatch.setattr(wa, "_k7_split_launch",
                        wa.window_attention_serving_reference)
    monkeypatch.setattr(wa, "_k7_raster_launch",
                        wa.window_attention_raster_reference)
    rng = np.random.default_rng(13)
    geom = (2, 14, 7, 3)
    qkv = rng.normal(size=(2, 14 * 14, 3 * 64)).astype(np.float32)
    table = rng.normal(size=(13 * 13, 2)).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(2, 14 * 14, 64)).astype(
        np.float32))
    grads = []
    for fn in (lambda x, t: wa._K7Raster.apply(x, t, *geom),
               lambda x, t: wa.windowed_attention(
                   lambda *a: wa._K7Split.apply(*a), x, t, *geom)):
        x = torch.from_numpy(qkv).requires_grad_(True)
        t = torch.from_numpy(table).requires_grad_(True)
        fn(x, t).backward(g)
        grads.append((x.grad, t.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_geometry_constants_survive_inference_mode():
    """The relative-position index and the shift mask are made once per
    geometry; made first under inference mode, they must still serve a
    later grad-enabled forward and its backward (which saves the index),
    and give what constants made outside inference mode give, bit for
    bit. The grad-enabled forward is the window-7 training route (JAX's
    XLA softmax, max-shifted), the inference-mode one the serving route
    (K7's plain version, exp2 with no max-shift): they agree within f32
    roundoff."""
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.ops import window_attention as wa

    wa._position_index.cache_clear()
    wa._shift_mask.cache_clear()
    model = SwinTransformer(**SWIN7)
    init_weights_(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(1, 2))
    with torch.inference_mode():
        serving = model(x).pooled
    got = model(x).pooled
    got.sum().backward()
    table = model.stage0_block1.attn.relative_position_bias_table
    assert table.grad is not None and torch.isfinite(table.grad).all()
    wa._position_index.cache_clear()
    wa._shift_mask.cache_clear()
    want = model(x).pooled
    torch.testing.assert_close(got.detach(), want.detach(), rtol=0, atol=0)
    torch.testing.assert_close(got.detach(), serving, rtol=0, atol=1e-5)


# ------------------------------------------------------- Swin at window 7 --

def _images(b, seed):
    return np.random.default_rng(seed).normal(size=(b, 56, 56, 3)).astype(
        np.float32)


def _variables(jm, x, seed):
    """JAX init plus noise: no LayerNorm is the identity and the
    relative-position tables are not zero."""
    rng = np.random.default_rng(seed)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
            np.float32) * 0.05, v["params"])}


def _port(variables, dtype):
    tm = SwinTransformer(**SWIN7, dtype=dtype)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return tm.eval()


def test_swin7_f32_matches_jax_xla_path():
    """f32; the port's K7 plain version (serving softmax) against JAX's XLA
    path (max-shifted softmax) in every block -> 1e-4, as at window 12."""
    x = _images(2, 0)
    jm = JSwin(**SWIN7)
    v = _variables(jm, x, 0)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = _port(v, torch.float32)(torch.from_numpy(x))
    assert got.tokens.shape == want.tokens.shape == (2, 49, 128)
    np.testing.assert_allclose(got.tokens.numpy(), np.asarray(want.tokens),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.pooled.numpy(), np.asarray(want.pooled),
                               rtol=0, atol=1e-4)


def _cosine(got, want):
    g = got.float().numpy().reshape(-1, got.shape[-1])
    w = np.asarray(want, np.float32).reshape(g.shape)
    return (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                              * np.linalg.norm(w, axis=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swin7_matches_jax_kernel_path(interpret, monkeypatch, dtype):
    """JAX with the backend reported as "tpu": every block of both stages
    takes the unfused half (N = 49 fails `swin_block_kernel_ok`) around
    `window_attention_pallas`, interpreted; B = 8, so that B nW is a multiple
    of 8 at the one-window stage and `_pick_wb` never falls back to XLA. K7
    must have run in all four blocks. f32: 5e-5 (the window-12 bound); bf16:
    the same rounding points, reductions ordered otherwise -> pooled
    cosine >= 0.9999 and token cosine >= 0.999 (measured 0.999983 and
    0.99986)."""
    x = _images(8, 1)
    jm = JSwin(**SWIN7, drop_path_rate=0.0, dtype=getattr(jnp, dtype))
    v = _variables(JSwin(**SWIN7), x, 1)
    picked = []
    orig = pwa._pick_wb
    monkeypatch.setattr(pwa, "_pick_wb",
                        lambda *a: picked.append(orig(*a)) or picked[-1])
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    assert picked == [8, 8, 8, 8], picked
    with torch.no_grad():
        got = _port(v, getattr(torch, dtype))(torch.from_numpy(x))
    if dtype == "float32":
        np.testing.assert_allclose(got.tokens.numpy(),
                                   np.asarray(want.tokens), rtol=0, atol=5e-5)
        np.testing.assert_allclose(got.pooled.numpy(),
                                   np.asarray(want.pooled), rtol=0, atol=5e-5)
    else:
        pooled = _cosine(got.pooled, want.pooled).min()
        tokens = _cosine(got.tokens, want.tokens).min()
        assert pooled >= 0.9999, pooled
        assert tokens >= 0.999, tokens
