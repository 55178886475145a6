"""The plain versions of kernels K2 (`mhsa_block_int8_reference`) and K3
(`mlp_block_int8_reference`), and their wrappers on CPU tensors, against
the JAX package: its Pallas kernels run in interpret mode (as
tests/test_pallas_ops.py runs them on the CPU) and its XLA fallbacks
(`DinoV2Block._attention_int8`, the fused branch of `Mlp(int8=True)`).

Tolerances: int8 products are exact on both sides, so the two differ only
where f32 reductions (LayerNorm, softmax sums) or transcendental
implementations move a value across an int8 rounding boundary; one such
flip moves an output by at most |w_q| x one dequant step. The bound is the
JAX package's own one-step bound, 1.5 x max|step| + 1e-3
(tests/test_pallas_ops.py:458-460), and most elements must agree to 1e-5.
Measured here: K3 against the JAX kernel 9.5e-7 (f32 rounding, no flip),
against the fallback 0; K2 against the JAX kernel 6e-8 to 1.2e-7 in the
three modes, against the fallback 0 in all three (its
modes form the softmax as the kernel body does, exp2 without max-shift and
P rounded to bf16 before normalisation, or int8 P.V in the exp2 domain, but
no context lands on the other side of a rounding boundary at this size);
K2 against the JAX kernel at a DINOv2 block's widths under the card's int8
bound (`chip_smoke.int8_within_bound`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import geovpr.ops.pallas_mhsa as pmhsa
import geovpr.ops.pallas_mlp as pmlp
from geovpr.models.dinov2 import DinoV2Block as JBlock
from geovpr.models.layers import Mlp as JMlp
from chip_smoke import int8_block_case, int8_errors, int8_within_bound
from geovpr_torch.ops.mhsa import (LOG2E, fused_mhsa_block_int8,
                                   mhsa_block_int8_reference)
from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                       mlp_block_int8_reference)
from torch_int8_modes import MODES, set_int8_mode


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _t(a):
    return torch.from_numpy(np.array(a))


def _one_step_bound(step):
    return 1.5 * float(np.abs(np.asarray(step)).max()) + 1e-3


# ------------------------------------------------------------------ K3 ----
M_ROWS, D, HID = 20, 16, 32


def _mlp_case(seed=7):
    """Unfolded int8 MLP state (the JAX quant collection) plus LN/LayerScale
    vectors, and x and a residual stream."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    q = dict(a_in_scale=np.float32(0.03), a_mid_scale=np.float32(0.02),
             fc1_kernel_q=rng.integers(-127, 128, (D, HID)).astype(np.int8),
             fc1_kernel_scale=(rng.uniform(0.5, 1.5, HID) * 1e-2).astype(
                 np.float32),
             fc1_bias=f32(HID, sc=0.1),
             fc2_kernel_q=rng.integers(-127, 128, (HID, D)).astype(np.int8),
             fc2_kernel_scale=(rng.uniform(0.5, 1.5, D) * 1e-2).astype(
                 np.float32),
             fc2_bias=f32(D, sc=0.1))
    vec = dict(ln_scale=f32(D, sc=0.1) + 1, ln_bias=f32(D, sc=0.1),
               gamma=f32(D, sc=0.5))
    return q, vec, f32(M_ROWS, D), f32(M_ROWS, D)


def _fold_mlp(q, vec):
    """The fold of `geovpr/models/layers.py:148-158`, in f32."""
    a_in, a_mid = q["a_in_scale"], q["a_mid_scale"]
    return dict(ln_scale_q=vec["ln_scale"] / a_in,
                ln_bias_q=vec["ln_bias"] / a_in,
                w1q=q["fc1_kernel_q"], s1_eff=a_in * q["fc1_kernel_scale"],
                b1=q["fc1_bias"], w2q=q["fc2_kernel_q"],
                s2_eff=a_mid * q["fc2_kernel_scale"], b2=q["fc2_bias"],
                gamma=vec["gamma"], inv_a_mid=np.float32(1.0) / a_mid)


def _port_mlp_args(f):
    return dict(ln_scale_q=_t(f["ln_scale_q"]), ln_bias_q=_t(f["ln_bias_q"]),
                w1q_t=_t(f["w1q"].T), s1_eff=_t(f["s1_eff"]), b1=_t(f["b1"]),
                w2q_t=_t(f["w2q"].T), s2_eff=_t(f["s2_eff"]), b2=_t(f["b2"]),
                gamma=_t(f["gamma"]), inv_a_mid=float(f["inv_a_mid"]))


@pytest.mark.parametrize("separate_residual", [False, True])
def test_k3_plain_matches_jax_kernel(interpret, separate_residual):
    q, vec, x, res = _mlp_case()
    f = _fold_mlp(q, vec)
    residual = res if separate_residual else None
    want = pmlp.fused_mlp_block_int8(
        jnp.asarray(x), *(jnp.asarray(f[k]) for k in (
            "ln_scale_q", "ln_bias_q", "w1q", "s1_eff", "b1", "w2q",
            "s2_eff", "b2", "gamma")), jnp.asarray(f["inv_a_mid"]),
        residual=None if residual is None else jnp.asarray(residual))
    got = mlp_block_int8_reference(
        _t(x), **_port_mlp_args(f),
        residual=None if residual is None else _t(residual))
    err = np.abs(got.numpy() - np.asarray(want))
    # same arithmetic in the same order: measured 0 (no int8 flip here)
    assert err.max() <= 1e-5, err.max()


@pytest.mark.parametrize("separate_residual", [False, True])
def test_k3_plain_matches_jax_mlp_fallback(separate_residual):
    q, vec, x, res = _mlp_case(seed=8)
    residual = res if separate_residual else None
    want = JMlp(hidden_dim=HID, int8=True).apply(
        {"quant": {k: jnp.asarray(v) for k, v in q.items()}}, jnp.asarray(x),
        fused=(jnp.asarray(vec["ln_scale"]), jnp.asarray(vec["ln_bias"]),
               jnp.asarray(vec["gamma"]), 1e-6),
        fused_residual=None if residual is None else jnp.asarray(residual))
    f = _fold_mlp(q, vec)
    got = fused_mlp_block_int8(
        _t(x), **_port_mlp_args(f),
        residual=None if residual is None else _t(residual))
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() <= _one_step_bound(f["s2_eff"] * f["gamma"]), err.max()
    assert np.mean(err > 1e-5) <= 0.1


def test_k3_wrapper_on_cpu_runs_the_plain_version():
    q, vec, x, _ = _mlp_case(seed=9)
    args = _port_mlp_args(_fold_mlp(q, vec))
    xb = _t(x).reshape(4, 5, D).bfloat16()
    before = fused_mlp_block_int8.launches
    got = fused_mlp_block_int8(xb, **args)
    assert fused_mlp_block_int8.launches == before
    assert got.shape == xb.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, mlp_block_int8_reference(xb, **args))
    with pytest.raises(ValueError):
        fused_mlp_block_int8(xb, **{**args, "w2q_t": args["w1q_t"]})


# ------------------------------------------------------------------ K2 ----
B, N, DM, H = 2, 129, 16, 4
DH = DM // H


def _attn_case(seed=23, v_scale=1.0):
    """Folded K2 arguments as in tests/test_pallas_ops.py: LN scale ~1,
    q/k thirds of the dequant row scaled into a healthy int8 range."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
    sqkv = np.abs(f32(3 * DM)) * 2e-2 + 1e-3
    sqkv = sqkv * np.where(np.arange(3 * DM) < 2 * DM, 0.05,
                           v_scale).astype(np.float32)
    args = dict(ln_scale_q=f32(DM) + 1.0, ln_bias_q=f32(DM),
                wqkv_q=i8(DM, 3 * DM), sqkv_eff=sqkv.astype(np.float32),
                bqkv_eff=f32(3 * DM), wo_q=i8(DM, DM),
                so_eff=np.abs(f32(DM)) * 2e-2 + 1e-3, bo=f32(DM),
                gamma=f32(DM))
    x = (rng.normal(size=(B, N, DM)) * 0.5).astype(np.float32)
    return x, args


_K2_ORDER = ("ln_scale_q", "ln_bias_q", "wqkv_q", "sqkv_eff", "bqkv_eff",
             "wo_q", "so_eff", "bo", "gamma")


def _port_attn_args(a):
    out = {k: _t(a[k]) for k in _K2_ORDER}
    out["wqkv_q_t"] = _t(a["wqkv_q"].T)
    out["wo_q_t"] = _t(a["wo_q"].T)
    del out["wqkv_q"], out["wo_q"]
    return out


CS = float(np.float32(0.9 * DH ** -0.5))


def _mode_constants(mode):
    """(cs, cpv, cpl) of `_attn_case`'s fold in `mode`."""
    cs = None if mode == "bf16_scores" else CS
    if mode != "int8_pv":
        return cs, None, None
    return cs, np.float32(2.0 / 127), np.float32(2.0)


@pytest.mark.parametrize("mode", MODES)
def test_k2_plain_matches_jax_kernel(interpret, mode):
    """JAX's v3 int8 body (key split at n = 128 + 1, exp2, no max-shift but
    in int8 P.V) in each attention mode; the port rounds the last key's p
    to bf16 where JAX keeps it f32 (but in int8 P.V). Measured 6e-8 (int8
    scores, bf16 scores) and 1.2e-7 (int8 P.V), no element off by 1e-5."""
    x, a = _attn_case()
    cs, cpv, cpl = _mode_constants(mode)
    want = pmhsa.fused_mhsa_block_int8(
        jnp.asarray(x), *(jnp.asarray(a[k]) for k in _K2_ORDER),
        num_heads=H, cs=None if cs is None else
        jnp.float32(cs) * pmhsa._LOG2E,
        cpv=None if cpv is None else jnp.asarray(cpv),
        cpl=None if cpl is None else jnp.asarray(cpl))
    assert want is not None
    got = mhsa_block_int8_reference(
        _t(x), **_port_attn_args(a), num_heads=H, cs=cs,
        cpv=None if cpv is None else float(cpv),
        cpl=None if cpl is None else float(cpl))
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() <= _one_step_bound(a["so_eff"] * a["gamma"]), err.max()
    assert np.mean(err > 1e-5) <= 0.02


@pytest.mark.parametrize("mode", MODES)
def test_k2_plain_matches_jax_kernel_at_block_width(interpret, monkeypatch,
                                                    mode):
    """The same at a DINOv2 block's width (D = 128, two heads of 64, N =
    129, bf16 x) on the block's own fold in `mode`
    (`chip_smoke.int8_block_case`: its int8 q, k and contexts span the int8
    range, where `_attn_case`'s q and k round to 0), under the card's int8
    bound for bf16 outputs (`int8_within_bound`: at most 1% of the elements
    off by more than 1e-3, max within 1.5 dequant steps + 1e-3 + two bf16
    spacings); measured shares 0.6% (int8 scores), 0 (int8 P.V), 0.5%
    (bf16 scores), each a context flip moving a bf16 output one spacing."""
    set_int8_mode(monkeypatch, mode)
    x, k2, _ = int8_block_case(2, 129, 128, 2, torch.device("cpu"))
    assert (k2["cs"] is None) == (mode == "bf16_scores")
    assert (k2["cpv"] is None) == (mode != "int8_pv")
    j = {k: None if v is None else jnp.asarray(
        v.numpy() if isinstance(v, torch.Tensor) else np.float32(v))
        for k, v in k2.items()}
    want = pmhsa.fused_mhsa_block_int8(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        j["ln_scale_q"], j["ln_bias_q"], j["wqkv_q_t"].T, j["sqkv_eff"],
        j["bqkv_eff"], j["wo_q_t"].T, j["so_eff"], j["bo"], j["gamma"],
        num_heads=2, cpv=j["cpv"], cpl=j["cpl"],
        cs=None if j["cs"] is None else j["cs"] * pmhsa._LOG2E)
    assert want is not None
    got = mhsa_block_int8_reference(x, **k2, num_heads=2)
    e = int8_errors(got, torch.from_numpy(np.array(want.astype(jnp.float32))),
                    (k2["so_eff"] * k2["gamma"]).abs().max().item())
    assert int8_within_bound(e), e


@pytest.mark.parametrize("mode", ["int8_scores", "int8_pv", "bf16_scores"])
def test_k2_plain_matches_jax_fallback(mode):
    """All three modes of `DinoV2Block._attention_int8`."""
    x, a = _attn_case(seed=24, v_scale=0.05 if mode == "int8_pv" else 1.0)
    cs = None if mode == "bf16_scores" else CS
    cpv = cpl = None
    if mode == "int8_pv":
        cpv, cpl = np.float32(0.02 / (127 * 0.05)), np.float32(0.02 / 0.05)
    blk = JBlock(dim=DM, num_heads=H)
    want = JBlock._attention_int8(blk, jnp.asarray(x), (
        *(jnp.asarray(a[k]) for k in _K2_ORDER),
        None if cs is None else jnp.float32(cs),
        None if cpv is None else jnp.asarray(cpv),
        None if cpl is None else jnp.asarray(cpl)))
    got = fused_mhsa_block_int8(_t(x), **_port_attn_args(a), num_heads=H,
                                cs=cs, cpv=None if cpv is None else
                                torch.tensor(cpv),
                                cpl=None if cpl is None else
                                torch.tensor(cpl))
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() <= _one_step_bound(a["so_eff"] * a["gamma"]), err.max()
    # the default mode forms its softmax differently from the fallback
    assert np.mean(err > 1e-5) <= (0.1 if mode == "int8_scores" else 1e-3)


def test_k2_wrapper_on_cpu_runs_the_plain_version():
    x, a = _attn_case(seed=25)
    args = _port_attn_args(a)
    xb = _t(x).bfloat16()
    before = fused_mhsa_block_int8.launches
    got = fused_mhsa_block_int8(xb, **args, num_heads=H, cs=CS)
    assert fused_mhsa_block_int8.launches == before
    assert torch.equal(got, mhsa_block_int8_reference(xb, **args,
                                                      num_heads=H, cs=CS))
    assert LOG2E == pytest.approx(float(pmhsa._LOG2E), rel=1e-15)
    with pytest.raises(ValueError):
        fused_mhsa_block_int8(xb, **args, num_heads=3, cs=CS)
