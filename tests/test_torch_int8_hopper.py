"""The Hopper designs of K2 (the w8a8 ViT attention half-block), K5 (the
w8a8 Swin attention half-block) and K3 (the w8a8 MLP half-block), on the
CPU.

All three run as separate launches on the card: K2 as LN-quant -> QKV
GEMM -> int8-score attention -> out projection, K5 the same with a window
attention, K3 as LN-quant -> fc1 -> fc2. The card's tests hold each launch against its plain part
(tests/test_torch_cuda.py); here the plain parts, composed, equal the
whole plain versions bit for bit, so those per-launch checks cover the
half-blocks. Beside them: the per-launch bounds chip_smoke.py prints, the
kernels' shape rules against every preset that serves int8, and K3's
plain version against JAX's interpreted kernel at the Swin widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import geovpr.ops.pallas_mlp as pmlp
from chip_smoke import (KERNEL_SHAPES, PEAK_INT8, SWIN_ATTN_SHAPES, bounds,
                        int8_block_case, k2_part_bounds, k3_part_bounds,
                        k5_kwargs, k5_part_bounds, swin_block_case,
                        swin_bounds)
from geovpr_torch.cli.presets import ANGLE_PRESETS, GEOPOSE_PRESETS
from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
from geovpr_torch.models.swin import SWIN_VARIANTS, SwinBlock, SwinTransformer
from geovpr_torch.ops.mhsa import (K2_PARTS, LOG2E, k2_shape_error,
                                   mhsa_block_int8_reference,
                                   vit_attention8_reference)
from geovpr_torch.ops.mlp_int8 import (K3_PARTS, fused_mlp_block_int8,
                                       k3_shape_error, mlp_block_int8_reference,
                                       mlp_fc1_int8_reference)
from geovpr_torch.ops.quant import (attn_mode, int8_resid_reference,
                                    ln_quant_reference, qkv_part_reference)
from geovpr_torch.ops.swin_block import (K5_PARTS, fused_swin_attn_block_int8,
                                         fused_window_ok, k5_shape_error,
                                         swin_attention8_reference,
                                         swin_attn_block_int8_reference)
from torch_int8_modes import set_int8_mode

CPU = torch.device("cpu")
# (B, C, H, S, w, shift): window 4 shifted and not, window 8, window 12
# shifted with a wrapped last window row and column, C = 1024
_K5_CASES = [(2, 64, 2, 8, 4, 2), (1, 64, 2, 8, 4, 0), (1, 64, 2, 16, 8, 4),
             (1, 128, 4, 24, 12, 6), (1, 1024, 32, 12, 12, 0)]


def _k5_parts(x, kw):
    """K5's four plain parts in turn, as the card's launches run them, in
    the attention mode of the fold `kw`."""
    b, l, c = x.shape
    mode = attn_mode(kw["cs"], kw["cpv"])
    xq = ln_quant_reference(x, kw["ln_scale_q"], kw["ln_bias_q"], 1e-5)
    qk, v = qkv_part_reference(xq, kw["wqkv_q_t"], kw["sqkv_eff"],
                               kw["bqkv_eff"], mode,
                               (c // kw["num_heads"]) ** -0.5 * LOG2E)
    ctx8 = swin_attention8_reference(qk, v, kw["table"], kw["num_heads"],
                                     kw["resolution"], kw["window"],
                                     kw["shift"], kw["cs"], kw["cpv"])
    out = int8_resid_reference(ctx8, kw["wo_q_t"], kw["so_eff"], kw["bo"],
                               x.reshape(b * l, c))
    return (xq, qk, v, ctx8), out.reshape(b, l, c)


@pytest.mark.parametrize("shape", _K5_CASES)
def test_k5_parts_compose_to_the_plain_version(shape):
    x, blk = swin_block_case(shape, CPU, int8=True)
    kw = k5_kwargs(blk)
    with torch.inference_mode():
        mids, out = _k5_parts(x, kw)
        want = swin_attn_block_int8_reference(x, **kw)
    assert torch.equal(out, want)
    m, c = x.shape[0] * x.shape[1], x.shape[-1]
    assert [(t.shape, t.dtype) for t in mids] == [
        ((m, c), torch.int8), ((m, 2 * c), torch.int8),
        ((m, c), torch.bfloat16), ((m, c), torch.int8)]
    # the attention is not idle: its int8 context spans the int8 range
    assert mids[3].abs().max() > 16


# what the QKV launch writes in the two other modes: q | k | v (M, 3C)
_MODE_QKV = {"int8_pv": torch.int8, "bf16_scores": torch.bfloat16}


@pytest.mark.parametrize("shape", _K5_CASES[1:4])
@pytest.mark.parametrize("mode", sorted(_MODE_QKV))
def test_k5_parts_compose_in_mode(monkeypatch, mode, shape):
    """The same in int8 P.V and bf16 scores, the block folded in the mode:
    the QKV launch writes q | k | v (M, 3C) in int8 or bf16 and no v."""
    set_int8_mode(monkeypatch, mode)
    x, blk = swin_block_case(shape, CPU, int8=True)
    kw = k5_kwargs(blk)
    with torch.inference_mode():
        mids, out = _k5_parts(x, kw)
        want = swin_attn_block_int8_reference(x, **kw)
    assert torch.equal(out, want)
    m, c = x.shape[0] * x.shape[1], x.shape[-1]
    assert [(t.shape, t.dtype) for t in mids] == [
        ((m, c), torch.int8), ((m, 3 * c), _MODE_QKV[mode]),
        ((m, 0), torch.bfloat16), ((m, c), torch.int8)]
    assert mids[3].abs().max() > 16


def _k2_parts(x, k2, h):
    """K2's four plain parts in turn, as the card's launches run them, in
    the attention mode of the fold `k2`."""
    b, n, d = x.shape
    mode = attn_mode(k2["cs"], k2["cpv"])
    xq = ln_quant_reference(x, k2["ln_scale_q"], k2["ln_bias_q"], 1e-6)
    qk, v = qkv_part_reference(xq, k2["wqkv_q_t"], k2["sqkv_eff"],
                               k2["bqkv_eff"], mode, (d // h) ** -0.5 * LOG2E)
    ctx8 = vit_attention8_reference(qk, v, h, n, k2["cs"], k2["cpv"],
                                    k2["cpl"])
    out = int8_resid_reference(ctx8, k2["wo_q_t"], k2["so_eff"], k2["bo"],
                               x.reshape(b * n, d), gamma=k2["gamma"])
    return (xq, qk, v, ctx8), out.reshape(b, n, d)


@pytest.mark.parametrize("shape", [(2, 20, 128, 2), (1, 257, 128, 2),
                                   (2, 17, 64, 1)])
def test_k2_parts_compose_to_the_plain_version(shape):
    """DINOv2 blocks at N = 20 and 17 (a masked tail of a 16-key tile) and
    N = 257 (the base model's tokens: four 64-key tiles and one key)."""
    b, n, d, h = shape
    x, k2, _ = int8_block_case(b, n, d, h, CPU)
    with torch.inference_mode():
        mids, out = _k2_parts(x, k2, h)
        want = mhsa_block_int8_reference(x, **k2, num_heads=h)
    assert torch.equal(out, want)
    m = b * n
    assert [(t.shape, t.dtype) for t in mids] == [
        ((m, d), torch.int8), ((m, 2 * d), torch.int8),
        ((m, d), torch.bfloat16), ((m, d), torch.int8)]
    assert mids[3].abs().max() > 16


@pytest.mark.parametrize("shape", [(2, 20, 128, 2), (1, 257, 128, 2)])
@pytest.mark.parametrize("mode", sorted(_MODE_QKV))
def test_k2_parts_compose_in_mode(monkeypatch, mode, shape):
    """The same in int8 P.V (the last key split off in f32) and bf16
    scores, the block folded in the mode."""
    set_int8_mode(monkeypatch, mode)
    b, n, d, h = shape
    x, k2, _ = int8_block_case(b, n, d, h, CPU)
    with torch.inference_mode():
        mids, out = _k2_parts(x, k2, h)
        want = mhsa_block_int8_reference(x, **k2, num_heads=h)
    assert torch.equal(out, want)
    m = b * n
    assert [(t.shape, t.dtype) for t in mids] == [
        ((m, d), torch.int8), ((m, 3 * d), _MODE_QKV[mode]),
        ((m, 0), torch.bfloat16), ((m, d), torch.int8)]
    assert mids[3].abs().max() > 16


def _k3_parts(x, k3, ln_eps, residual=None):
    d = x.shape[-1]
    xq = ln_quant_reference(x, k3["ln_scale_q"], k3["ln_bias_q"], ln_eps)
    hid = mlp_fc1_int8_reference(xq, k3["w1q_t"], k3["s1_eff"], k3["b1"],
                                 k3["inv_a_mid"])
    res = x if residual is None else residual
    out = int8_resid_reference(hid, k3["w2q_t"], k3["s2_eff"], k3["b2"],
                               res.reshape(-1, d), gamma=k3["gamma"])
    return hid, out.reshape(x.shape)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(2, 17, 64, 1), (1, 20, 96, 1),
                                   (2, 9, 128, 2)])
def test_k3_parts_compose_to_the_plain_version(shape, residual):
    """DINOv2 blocks (eps 1e-6, LayerScale), D = 96 among them (Swin-T's
    width), with and without a separate residual."""
    b, n, d, h = shape
    x, _, k3 = int8_block_case(b, n, d, h, CPU)
    res = (torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
           .bfloat16() if residual else None)
    with torch.inference_mode():
        hid, out = _k3_parts(x, k3, 1e-6, res)
        want = mlp_block_int8_reference(x, **k3, residual=res)
    assert torch.equal(out, want)
    assert hid.dtype == torch.int8 and hid.shape == (b * n, 4 * d)
    assert hid.abs().max() > 16


@pytest.mark.parametrize("shape", _K5_CASES[:2] + _K5_CASES[3:4])
def test_k3_parts_compose_at_swin_blocks(shape):
    """Swin's int8 MLP half (eps 1e-5, gamma ones)."""
    x, blk = swin_block_case(shape, CPU, int8=True)
    k3 = blk._folded_args(blk._k3)
    with torch.inference_mode():
        _, out = _k3_parts(x, k3, 1e-5)
        want = mlp_block_int8_reference(x, **k3, ln_eps=1e-5)
    assert torch.equal(out, want)


# the sums of the per-launch bounds at Swin-B-384, B=64 (ms), stages 0-3
K5_SPLIT_MS = (0.4057, 0.2029, 0.1026, 0.0663)


@pytest.mark.parametrize("shape, want", zip(SWIN_ATTN_SHAPES, K5_SPLIT_MS))
def test_k5_part_bounds_add_up(shape, want):
    """The QKV GEMM's, the attention's and the out projection's products
    are the half-block's operations; the four bounds add up to the split's
    bound (the LN-quant pass's f32 operations are its own)."""
    parts = {p: k5_part_bounds(p, shape) for p in K5_PARTS}
    products = sum(v["ops"] for p, v in parts.items() if p != "ln_quant")
    assert products == swin_bounds("K5", shape)["ops"]
    assert sum(v["bound_ms"] for v in parts.values()) == pytest.approx(
        want, rel=1e-3)
    assert all(v["bytes_bound_ms"] > 0 for v in parts.values())


# the sums of K2's four launch bounds (ms) at chip_smoke.py's K2 shapes
K2_SPLIT_MS = (0.07861, 0.0004906, 0.01885)


@pytest.mark.parametrize("shape, want", zip(KERNEL_SHAPES, K2_SPLIT_MS))
def test_k2_part_bounds_add_up(shape, want):
    """The QKV GEMM's, the attention's and the out projection's products
    are the half-block's operations (at their own rates); the four bounds
    add up to the split's bound."""
    parts = {p: k2_part_bounds(p, *shape) for p in K2_PARTS}
    products = sum(v["ops_bound_ms"] for p, v in parts.items()
                   if p != "ln_quant")
    assert products == pytest.approx(bounds("K2", *shape)["ops_bound_ms"])
    assert sum(v["bound_ms"] for v in parts.values()) == pytest.approx(
        want, rel=1e-3)
    assert all(v["bytes_bound_ms"] > 0 for v in parts.values())


# (rows, D, hidden) -> the sum of K3's three launch bounds (ms): DINOv2-B/14
# at B=64, Swin-B-384 stages 0-3 at B=64
_K3_SPLITS = [((64 * 257, 768, 3072), 0.0897),
              ((64 * 96 * 96, 128, 512), 0.3606),
              ((64 * 48 * 48, 256, 1024), 0.1805),
              ((64 * 24 * 24, 512, 2048), 0.1014),
              ((64 * 12 * 12, 1024, 4096), 0.0866)]


@pytest.mark.parametrize("dims, want", _K3_SPLITS)
def test_k3_part_bounds_add_up(dims, want):
    """fc1's and fc2's int8 products are the whole call's operations; the
    three bounds add up to the split's bound: at Swin stage 0 the int8
    hidden written and read (302 MB each way) sets four times the whole
    call's 0.09 ms."""
    m, d, hid = dims
    parts = {p: k3_part_bounds(p, m, d, hid) for p in K3_PARTS}
    whole = bounds("K3", 1, m, d, 1)
    products = parts["fc1"]["ops"] + parts["fc2"]["ops"]
    assert products / PEAK_INT8 * 1e3 == pytest.approx(whole["ops_bound_ms"])
    assert sum(v["bound_ms"] for v in parts.values()) == pytest.approx(
        want, rel=1e-3)
    assert sum(v["bound_ms"] for v in parts.values()) >= whole["bound_ms"]


_SWIN_INT8_PRESETS = sorted(
    name for name, cfg in {**GEOPOSE_PRESETS, **ANGLE_PRESETS}.items()
    if cfg.model.family == "swin"
    and fused_window_ok(SWIN_VARIANTS[cfg.model.variant]["window_size"]))


def _swin_blocks(preset):
    cfg = {**GEOPOSE_PRESETS, **ANGLE_PRESETS}[preset]
    model = SwinTransformer(**SWIN_VARIANTS[cfg.model.variant],
                            device="meta")
    return [m for m in model.blocks if isinstance(m, SwinBlock)]


def test_some_swin_preset_serves_int8():
    assert "swin_b384_gemini2" in _SWIN_INT8_PRESETS


@pytest.mark.parametrize("preset", _SWIN_INT8_PRESETS)
def test_k5_and_k3_rules_take_every_int8_block_of(preset):
    """Every block of a Swin preset that serves w8a8 (window 12) takes K5's
    kernels for its attention half and K3's for its MLP half."""
    blocks = _swin_blocks(preset)
    assert blocks
    for m in blocks:
        c = m.norm1.weight.shape[0]
        assert k5_shape_error(c, m.num_heads, m.window, m.shift) is None, (
            c, m.num_heads, m.window, m.shift)
        assert k3_shape_error(c, 4 * c) is None, c


@pytest.mark.parametrize("variant", sorted(DINOV2_VARIANTS))
def test_k2_rule_takes_every_dinov2_block(variant):
    v = DINOV2_VARIANTS[variant]
    assert k2_shape_error(v["hidden_size"], v["num_heads"]) is None


@pytest.mark.parametrize("d, heads, words", [
    (128, 4, "head dim"),        # head dim 32: a q8 box is one 64-byte head
    (100, 3, "head dim"),        # D not a multiple of the heads
    (1088, 17, "D <= 1024"),     # beyond the LN-quant pass's staging
])
def test_k2_rule_refuses(d, heads, words):
    err = k2_shape_error(d, heads)
    assert err is not None and words in err and "K2" in err


@pytest.mark.parametrize("variant", ["base-14", "large-14"])
def test_k3_rule_takes_every_int8_mlp_of_dinov2(variant):
    d = DINOV2_VARIANTS[variant]["hidden_size"]
    assert k3_shape_error(d, 4 * d) is None


@pytest.mark.parametrize("c, heads, window, shift, words", [
    (128, 4, 12, 3, "shift"),          # not Swin's window // 2
    (1088, 34, 12, 6, "C <= 1024"),    # beyond the LayerNorm's registers
    (96, 3, 12, 6, "multiple of 64"),  # odd H: no int8 head pairs
    (128, 2, 12, 6, "head dim"),       # head dim 64
    (128, 4, 7, 3, "head dim"),        # N = 49: the unfused half around K7
])
def test_k5_rule_refuses(c, heads, window, shift, words):
    err = k5_shape_error(c, heads, window, shift)
    assert err is not None and words in err and "K" in err


@pytest.mark.parametrize("d, hidden", [(100, 400), (768, 3000), (1040, 4160),
                                       (0, 64)])
def test_k3_rule_refuses(d, hidden):
    assert "multiples of 16" in k3_shape_error(d, hidden)


def test_wrappers_keep_the_plain_versions_on_the_cpu():
    """The rules bind only the kernels: on a CPU tensor the wrappers run
    the plain versions at shapes the kernels refuse (odd H and shift 1 for
    K5, D = 40 for K3) and count no launch."""
    x, blk = swin_block_case((1, 96, 3, 8, 4, 1), CPU, int8=True)
    kw = k5_kwargs(blk)
    assert k5_shape_error(96, 3, 4, 1) is not None
    before = fused_swin_attn_block_int8.launches
    with torch.inference_mode():
        assert torch.equal(fused_swin_attn_block_int8(x, **kw),
                           swin_attn_block_int8_reference(x, **kw))
    assert fused_swin_attn_block_int8.launches == before
    x, _, k3 = int8_block_case(1, 5, 40, 1, CPU)
    assert k3_shape_error(40, 160) is not None
    before = fused_mlp_block_int8.launches
    with torch.inference_mode():
        assert torch.equal(fused_mlp_block_int8(x, **k3),
                           mlp_block_int8_reference(x, **k3))
    assert fused_mlp_block_int8.launches == before


# ------------------------------------------- K3 against JAX's kernel ----

@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d, hidden", [(128, 512), (256, 1024)])
def test_k3_plain_matches_jax_kernel_at_swin_widths(interpret, d, hidden):
    """Swin-B-384's stage 0 and 1 MLP widths, Swin's eps 1e-5 and gamma
    ones, 24 rows: JAX's kernel interpreted against the port's plain
    version. int8 products are exact on both sides; they differ only where
    an f32 LayerNorm or GELU (XLA's tanh against torch's) rounds a value
    across an int8 boundary. One hidden element flipped by one moves its
    row by |w2q| <= 127 dequant steps of fc2: measured, no flip at D =
    128 (max |error| 1e-6) and one flip in one of the 24 rows at D = 256
    (0.0036, 122 steps)."""
    rng = np.random.default_rng(d)
    f32 = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    a_in, a_mid = np.float32(0.03), np.float32(0.02)
    w1q = rng.integers(-127, 128, (d, hidden)).astype(np.int8)
    w2q = rng.integers(-127, 128, (hidden, d)).astype(np.int8)
    s1 = (rng.uniform(0.5, 1.5, hidden) * 2e-3).astype(np.float32)
    s2 = (rng.uniform(0.5, 1.5, d) * 1e-3).astype(np.float32)
    fold = dict(ln_scale_q=(f32(d, sc=0.1) + 1) / a_in,
                ln_bias_q=f32(d, sc=0.1) / a_in, s1_eff=a_in * s1,
                b1=f32(hidden, sc=0.1), s2_eff=a_mid * s2,
                b2=f32(d, sc=0.1), gamma=np.ones(d, np.float32))
    inv_a_mid = np.float32(1.0) / a_mid
    x = f32(24, d)
    want = np.asarray(pmlp.fused_mlp_block_int8(
        jnp.asarray(x), *(jnp.asarray(fold[k]) for k in (
            "ln_scale_q", "ln_bias_q")), jnp.asarray(w1q),
        jnp.asarray(fold["s1_eff"]), jnp.asarray(fold["b1"]),
        jnp.asarray(w2q), *(jnp.asarray(fold[k]) for k in (
            "s2_eff", "b2", "gamma")), jnp.asarray(inv_a_mid), ln_eps=1e-5))
    got = mlp_block_int8_reference(
        _t(x), **{k: _t(v) for k, v in fold.items()}, w1q_t=_t(w1q.T),
        w2q_t=_t(w2q.T), inv_a_mid=float(inv_a_mid), ln_eps=1e-5).numpy()
    err = np.abs(got - want)
    step = float(np.abs(fold["s2_eff"]).max())
    assert (err > 1e-5).any(axis=1).sum() <= 1
    assert err.max() <= 127 * step + 1e-5, err.max()
    # the hidden is busy: the GELU output spans the int8 range
    hid = mlp_fc1_int8_reference(
        ln_quant_reference(_t(x), _t(fold["ln_scale_q"]),
                           _t(fold["ln_bias_q"]), 1e-5), _t(w1q.T),
        _t(fold["s1_eff"]), _t(fold["b1"]), float(inv_a_mid))
    assert hid.abs().max() == 127 and (hid != 0).float().mean() > 0.3
