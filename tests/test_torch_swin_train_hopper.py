"""The Hopper design of K9a (the Swin training forward) on the CPU: its
four launches' plain parts (`train_ln_reference`, `train_qkv_reference`,
`train_attention_reference`, `train_out_proj_reference`) composed on the
raster stream against the whole plain version and against the JAX
package's `_swin_train_fwd_pallas` in interpret mode, the per-launch bounds
chip_smoke.py prints beside each launch's time, and the shape rule of K9's
kernels (`k9_shape_error`), which every window-12 block of every Swin
preset must satisfy so that no training preset loses its kernels. The
kernels themselves run only on the card (test_torch_cuda.py).

The JAX comparison is in f32 with test_torch_swin_train_ops.py's
tolerance: 3e-5 relative, and 3e-5 absolute on the scale of each tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import geovpr.ops.pallas_swin_block as psb
from chip_smoke import K9_SHAPES, PEAK_BF16, k9_bounds, k9a_part_bounds
from geovpr.models.swin import relative_position_index, shifted_window_mask
from geovpr_torch.cli.presets import ANGLE_PRESETS, GEOPOSE_PRESETS
from geovpr_torch.models.swin import SWIN_VARIANTS, SwinBlock, SwinTransformer
from geovpr_torch.ops.swin_block import (K9A_PARTS, _train_plain_fwd,
                                         k9_shape_error, train_ln_reference,
                                         train_attention_reference,
                                         train_out_proj_reference,
                                         train_qkv_reference)

TOL = 3e-5
# the sum of K9a's per-launch bounds at Swin-B-384 stage 0, B=16 (ms):
# LayerNorm 0.023, QKV GEMM 0.056, attention 0.096, out projection 0.023
K9A_SPLIT_MS = 0.197

SWIN_PRESETS = sorted(name for name, cfg in {**GEOPOSE_PRESETS,
                                             **ANGLE_PRESETS}.items()
                      if cfg.model.family == "swin")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(psb.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _block(b, c, h, res, win, dtype, seed=0):
    """A block's raster stream and parameters, made with numpy."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    x = r(b, res * res, c, scale=0.5)
    params = [r(c, scale=0.1, shift=1.0), r(c, scale=0.1),
              r(c, 3 * c, scale=c ** -0.5), r(3 * c, scale=0.1),
              r(c, c, scale=c ** -0.5), r(c, scale=0.1),
              r((2 * win - 1) ** 2, h)]
    t = [torch.from_numpy(a) for a in [x] + params]
    for i in (0, 3, 5):                     # x, wqkv, wo in the stream dtype
        t[i] = t[i].to(dtype)
    return [x] + params, t


def train_parts_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, table,
                    num_heads, resolution, window, shift, ln_eps):
    """K9a's four plain parts in the order of its launches, on the raster
    stream: y, qkv, ctx, p as `_train_plain_fwd` returns them."""
    b, l, c = x.shape
    h = train_ln_reference(x.reshape(b * l, c), ln_scale, ln_bias, ln_eps)
    qkv, qs = train_qkv_reference(h, wqkv, bqkv, num_heads)
    qkv = qkv.reshape(b, l, 3 * c)
    ctx, p = train_attention_reference(qs.reshape(b, l, c), qkv, table,
                                       num_heads, resolution, window, shift)
    y = train_out_proj_reference(ctx.reshape(b * l, c), wo, bo)
    return y.reshape(b, l, c), qkv, ctx, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", [(2, 64, 2, 24, 12, 6),
                                  (1, 128, 4, 24, 12, 0),
                                  (2, 192, 6, 12, 12, 0)])
def test_k9a_parts_compose_to_the_plain_version(dtype, geom):
    """K9a's four plain parts in the order of its launches, on the raster
    stream, give the window-form plain version's y, qkv, ctx and p bit for
    bit, shifted and not, at an odd head count."""
    b, c, h, res, win, shift = geom
    _, t = _block(b, c, h, res, win, dtype)
    args = (*t, h, res, win, shift, 1e-5)
    got = train_parts_fwd(*args)
    want = _train_plain_fwd(*args)
    for name, a, w in zip(("y", "qkv", "ctx", "p"), got, want):
        assert a.dtype == w.dtype == dtype and torch.equal(a, w), name


def _windows_np(t, res, win, shift):
    """raster (B, L, C') -> the (B * nW * N, C') rows of the stream rolled
    by -shift and cut into windows, as the JAX package partitions it."""
    b, _, c = t.shape
    g = np.roll(t.reshape(b, res, res, c), (-shift, -shift), axis=(1, 2))
    g = g.reshape(b, res // win, win, res // win, win, c)
    return g.transpose(0, 1, 3, 2, 4, 5).reshape(-1, c)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("shift", [6, 0])
def test_k9a_parts_match_jax_interpreted(interpret, shift):
    """The composed parts against `_swin_train_fwd_pallas` on the same
    block: JAX takes the partitioned stream, the (H, N, N) bias gathered
    from the table by its own `relative_position_index` and its own shift
    mask; the port takes the raster stream and the table."""
    b, c, h, res, win = 1, 64, 2, 24, 12
    n = win * win
    arrays, t = _block(b, c, h, res, win, torch.float32)
    y, qkv, ctx, p = (a.numpy() for a in train_parts_fwd(
        *t, h, res, win, shift, 1e-5))
    x, ls, lb, wqkv, bqkv, wo, bo, table = arrays
    bias = table[relative_position_index(win).reshape(-1)].reshape(
        n, n, h).transpose(2, 0, 1)
    mask = (jnp.asarray(shifted_window_mask(res, res, win, shift))
            if shift else None)
    xw = _windows_np(x, res, win, shift).reshape(-1, n, c)
    want = psb._swin_train_fwd_pallas(
        *map(jnp.asarray, (xw, ls, lb, wqkv, bqkv, wo, bo, bias)), mask, h,
        1e-5)
    bw = xw.shape[0]
    _close(_windows_np(y, res, win, shift), np.asarray(want[0]).reshape(
        bw * n, c), "y")
    _close(_windows_np(qkv, res, win, shift), want[1], "qkv")
    _close(_windows_np(ctx, res, win, shift), want[2], "ctx")
    _close(p, np.asarray(want[3]).reshape(bw, n, h, n).transpose(0, 2, 1, 3),
           "p")


@pytest.mark.parametrize("shape", K9_SHAPES)
def test_k9a_part_bounds_add_up(shape):
    """The products of the QKV GEMM, the attention and the out projection
    are K9a's operations (`k9_bounds`); each launch moves at least its own
    bytes, and at stage 0 the four bounds add up to the split's 0.197 ms
    (the fused bound is 0.118)."""
    parts = {p: k9a_part_bounds(p, shape) for p in K9A_PARTS}
    products = sum(v["ops"] for p, v in parts.items() if p != "layernorm")
    whole = k9_bounds("K9a", shape)
    assert products / PEAK_BF16 * 1e3 == pytest.approx(whole["ops_bound_ms"])
    assert all(v["bytes_bound_ms"] > 0 for v in parts.values())
    split = sum(v["bound_ms"] for v in parts.values())
    assert split >= whole["bound_ms"]
    if shape == K9_SHAPES[0]:
        assert split == pytest.approx(K9A_SPLIT_MS, rel=0.01)
        assert whole["bound_ms"] == pytest.approx(0.118, rel=0.01)


def _blocks(preset):
    cfg = {**GEOPOSE_PRESETS, **ANGLE_PRESETS}[preset]
    model = SwinTransformer(**SWIN_VARIANTS[cfg.model.variant],
                            device="meta")
    return [m for m in model.blocks if isinstance(m, SwinBlock)]


@pytest.mark.parametrize("preset", SWIN_PRESETS)
def test_k9_rule_takes_every_window12_block_of(preset):
    """Every window-12 block of every Swin preset takes K9's kernels, so
    that training keeps them; window-7 presets have none."""
    blocks = [m for m in _blocks(preset) if m.window == 12]
    for m in blocks:
        c = m.norm1.weight.shape[0]
        assert k9_shape_error(c, m.num_heads, m.window, m.shift) is None, (
            c, m.num_heads, m.window, m.shift)
    variant = {**GEOPOSE_PRESETS, **ANGLE_PRESETS}[preset].model.variant
    assert len(blocks) == (len(_blocks(preset)) if SWIN_VARIANTS[variant][
        "window_size"] == 12 else 0)


@pytest.mark.parametrize("geom, words", [
    ((128, 4, 7, 3), "window 12"),           # window 7 (Swin-T)
    ((96, 3, 12, 6), "multiple of 64"),      # C = 96: 64 does not divide it
    ((128, 2, 12, 6), "head dim 32"),        # head dim 64
    ((2048, 64, 12, 6), "up to 1024"),       # C past the LayerNorm's row
    ((128, 4, 12, 3), "shift of 0 or"),      # a shift that splits quarters
    ((128, 4, 12, 0), None), ((1024, 32, 12, 6), None)])
def test_k9_rule_names_what_it_refuses(geom, words):
    err = k9_shape_error(*geom)
    if words is None:
        assert err is None
    else:
        assert err is not None and words in err, err
