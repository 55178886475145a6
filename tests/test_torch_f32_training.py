"""f32 DINOv2 training on the card: the training kernels K8a-K8c take an
f32 stream (K1's f32 launches in `geovpr_torch/csrc/f32_serving.cu` and
K8b, K8c in `geovpr_torch/csrc/f32_train.cu`) as well as a bf16 one, for a
DINOv2 built with compute_dtype="float32".

Here, without a card: the type rule `k8_dtype_error` as a pure function,
`bwd_all_ok` against JAX's gate in both dtypes, the f32 gradients of
`fused_mhsa_block_train` (the port's K8c plain route) against `jax.grad`
of `fused_mhsa_block` where JAX's f32 clause sends it to its split route,
the wrappers on f32 CPU tensors, the bound arithmetic of chip_smoke.py's
[f32_training] phase, and the split of a weight gradient's rows into
partial sums over the f32 GEMM's 128 x 64 output tiles
(`swin_block.f32_wgrad_chunk`, as `csrc/f32_train.cu::f32_wgrad_split`
counts it). The kernels themselves are checked on
the card (tests/test_torch_cuda.py, `-k f32`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke as cs
import geovpr.ops.pallas_mhsa as jm
from geovpr_torch.ops import mhsa as tm

BF16, F32 = torch.bfloat16, torch.float32
STREAM = ("x", "wqkv", "wo", "qkv", "ctx", "g", "da")
VECTORS = ("ln_scale", "ln_bias", "bqkv", "bo", "gamma")
# (B, N, D, H): NP D 4 = 528 x 256 x 4 bytes > 512 KiB, so JAX's f32 clause
# of `_bwd_all_ok` sends an f32 stream to the split route, while its size
# clause (and the port's `bwd_all_ok`) takes the all-in-one backward
PAST_F32_CLAUSE = (1, 520, 256, 4)


def _set(stream_dtype, **over):
    return {**dict.fromkeys(STREAM, stream_dtype),
            **dict.fromkeys(VECTORS, F32), **over}


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_k8_rule_takes_one_dtype(dtype):
    assert tm.k8_dtype_error(_set(dtype)) is None
    # the wrappers' own subsets: K8a's, K8b's and K8c's arguments
    for names in (("x", "wqkv", "wo", *VECTORS), ("qkv", "da"),
                  ("x", "wqkv", "wo", "qkv", "ctx", "g", "ln_scale",
                   "ln_bias", "bo", "gamma")):
        assert tm.k8_dtype_error({k: _set(dtype)[k] for k in names}) is None


@pytest.mark.parametrize("base", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", STREAM)
def test_k8_rule_refuses_a_mixed_set(name, base):
    """One stream tensor in the other dtype: refused, naming it."""
    other = F32 if base == BF16 else BF16
    err = tm.k8_dtype_error(_set(base, **{name: other}))
    assert err and f"{name} is {other}" in err and f"the rest {base}" in err


@pytest.mark.parametrize("name", VECTORS)
def test_k8_rule_refuses_a_vector_off_f32(name):
    for base in (BF16, F32):
        err = tm.k8_dtype_error(_set(base, **{name: BF16}))
        assert err and name in err and "torch.float32" in err
    assert "torch.float16" in tm.k8_dtype_error(_set(torch.float16))


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_bwd_all_ok_keeps_jax_size_clause(dtype):
    """The port's gate is JAX's size clause in both dtypes: base-14 takes
    K8c, large-14 the split route. JAX's f32 clause is a TPU VMEM limit
    and is not copied: at DINOv2-B/14's N = 257 (NP 272) JAX sends f32 to
    its split route, the port keeps K8c."""
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    for np_, d, h in ((32, 768, 12), (32, 1024, 16), (32, 384, 6)):
        assert tm.bwd_all_ok(d) == jm._bwd_all_ok(np_, d, h, jdt)
    assert tm.bwd_all_ok(768) and not tm.bwd_all_ok(1024)
    assert jm._bwd_all_ok(272, 768, 12, jdt) == (dtype == BF16)


@pytest.fixture
def _interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jm.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _inputs(shape, seed):
    b, n, d, _ = shape
    rng = np.random.default_rng(seed)

    def r(*s, scale=1.0):
        return (rng.normal(size=s) * scale).astype(np.float32)

    return [r(b, n, d), 1 + r(d, scale=0.1), r(d, scale=0.1),
            r(d, 3 * d, scale=d ** -0.5), r(3 * d, scale=0.1),
            r(d, d, scale=d ** -0.5), r(d, scale=0.1),
            r(d, scale=0.5)], r(b, n, d)


def test_f32_gradients_match_jax_past_its_f32_clause(_interpret):
    """At (1, 520, 256, 4) JAX's f32 stream takes its split route (K8b's
    `_attn_bwd_pallas` interpreted, XLA products and the LN VJP by
    autograd) and the port's f32 stream the all-in-one plain route of K8c:
    every gradient of the half-block agrees to f32 roundoff."""
    b, n, d, h = PAST_F32_CLAUSE
    np_ = -(-n // 16) * 16
    assert not jm._bwd_all_ok(np_, d, h, jnp.float32)
    assert jm._bwd_all_ok(np_, d, h, jnp.bfloat16) and tm.bwd_all_ok(d)
    args, g = _inputs(PAST_F32_CLAUSE, seed=5)

    def jloss(*a):
        return jnp.sum(jm.fused_mhsa_block(*a, num_heads=h) * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=tuple(range(8)))(*map(jnp.asarray,
                                                           args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = tm.fused_mhsa_block_train(*leaves, h)
    assert out.dtype == F32
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for i, (a, w) in enumerate(zip(grads, jgrads)):
        assert a.dtype == F32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f"argument {i}")


def test_f32_wrappers_take_the_plain_path_on_the_cpu():
    """On f32 CPU tensors K8a, K8b and K8c run their plain versions, in
    f32, and count no launch."""
    args, g = _inputs((1, 9, 64, 1), seed=6)
    ta = [torch.from_numpy(a) for a in args]
    gt = torch.from_numpy(g)
    fns = (tm.fused_mhsa_train_fwd, tm.fused_mhsa_bwd_core,
           tm.fused_mhsa_bwd_all)
    counts = [f.launches for f in fns]
    out, qkv, ctx = tm.fused_mhsa_train_fwd(*ta, 1)
    dqkv = tm.fused_mhsa_bwd_core(qkv, gt, 1)
    grads = tm.fused_mhsa_bwd_all(ta[0], ta[1], ta[2], ta[3], ta[5], ta[6],
                                  ta[7], qkv, ctx, gt, 1)
    assert [f.launches for f in fns] == counts
    assert all(t.dtype == F32 for t in (out, qkv, ctx, dqkv, *grads))
    torch.testing.assert_close(
        dqkv, tm.mhsa_attn_bwd_core_reference(qkv, gt, 1), rtol=0, atol=0)


def test_f32_training_bounds_by_hand():
    """chip_smoke.py's bounds of the f32 training rows at DINOv2-B/14 and
    -L/14 (B = 16): operations at the CUDA cores' peak, 66.9 TFLOP/s at
    1,980 MHz, counted as the bf16 rows count them (K8c: 18 M D^2 of
    products and five N x N x dh products a head, ~51.8 GFLOP; K8b: the
    five products alone, not the eight its launches make)."""
    peak = cs.f32_peak(1980.0)
    assert peak == pytest.approx(66.9e12, rel=1e-3)
    base, large = (16, 257, 768, 12), (16, 257, 1024, 16)
    m = 16 * 257
    att_b = 2 * 16 * 12 * 257 * 257 * 64
    att_l = 2 * 16 * 16 * 257 * 257 * 64
    k8c = cs.f32_train_bounds("K8c", base, peak)
    assert k8c["ops"] == 5 * att_b + 18 * m * 768 ** 2
    assert k8c["ops"] == pytest.approx(51.8e9, rel=2e-3)
    assert k8c["bound_ms"] == pytest.approx(0.774, rel=2e-3)
    assert k8c["bound_by"] == "operations"
    k8b = cs.f32_train_bounds("K8b", large, peak)
    assert k8b["ops"] == 5 * att_l
    assert k8b["bound_ms"] == pytest.approx(0.162, rel=5e-3)
    assert cs.f32_train_bounds("K8b", base, peak)["bound_ms"] == \
        pytest.approx(0.121, rel=5e-3)
    k8a = cs.f32_train_bounds("K8a", base, peak)
    assert k8a["ops"] == 8 * m * 768 ** 2 + 2 * att_b
    assert k8a["bound_ms"] == pytest.approx(0.3385, rel=5e-3)
    # bytes: 4 a value, each input read once and each output written once
    assert cs.f32_train_bounds("K8b", base, peak)["bytes"] == 4 * 7 * m * 768


@pytest.mark.parametrize("k, m, nc, chunk", [
    (4112, 768, 768, 544),      # DINOv2-B/14's dWo at B = 16: 72 tiles
    (4112, 768, 2304, 1376),    # its dWqkv: 216 tiles
    (147456, 128, 128, 576),    # Swin-B-384 stage 0's dWo (K9c.f32)
    (100, 192, 192, 32),        # a card test's ragged shape
    (16, 64, 64, 32)])          # fewer rows than one 32-row step
def test_f32_wgrad_chunk_counts_128_by_64_tiles(k, m, nc, chunk):
    """The chunk by hand: S = min(ceil(528 / tiles), ceil(K / 32)) splits
    over ceil(M / 128) x ceil(Nc / 64) tiles, each split rounded up to
    whole 32-row steps; the chunks cover K, none of them empty."""
    from geovpr_torch.ops.swin_block import f32_wgrad_chunk
    got = f32_wgrad_chunk(k, m, nc)
    assert got == chunk and got % 32 == 0
    parts = -(-k // got)
    assert (parts - 1) * got < k <= parts * got
    assert parts <= max(1, -(-528 // (-(-m // 128) * -(-nc // 64))))


def test_f32_chunk_follows_its_own_tile_not_bf16s():
    """The bf16 products keep their 64 x 64 tiles (and so their bits):
    at DINOv2-B/14's dWo the two splits differ."""
    from geovpr_torch.ops.swin_block import f32_wgrad_chunk, wgrad_chunk
    assert wgrad_chunk(4112, 768, 768) == 1056
    assert f32_wgrad_chunk(4112, 768, 768) == 544


def test_f32_chunked_weight_grad_sums_every_row():
    """The plain weight gradient summed in the kernel's chunks matches the
    one-pass sum: every row lands in one partial."""
    from geovpr_torch.ops.swin_block import (f32_wgrad_chunk,
                                             weight_grad_reference)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(100, 192)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(100, 192)).astype(np.float32))
    whole = weight_grad_reference(a, b)
    parts = weight_grad_reference(a, b, f32_wgrad_chunk(100, 192, 192))
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
