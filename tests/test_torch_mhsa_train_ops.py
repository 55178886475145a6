"""The plain versions of the ViT training kernels K8a/K8b/K8c
(`geovpr_torch.ops.mhsa`) against the JAX package's Pallas kernels run in
interpret mode (`pl.pallas_call` patched with `interpret=True`, as
`tests/test_pallas_ops.py` runs them; nothing in `geovpr` changes).

f32 on both sides, so that the rounding points are exact and what is
compared is the algorithm. JAX takes its masked bodies at N = 20
(`_mhsa_train_kernel`, `_attn_bwd_kernel`) and its key-split bodies at
N = 129 (`_mhsa_train_kernel_v3`, `_attn_bwd_kernel_v3`), padding N to 16
rows; the port takes the residuals unpadded (and N = 65 for the core, whose
card kernel ends on a one-key tile as at DINOv2's N = 257). Tolerances:
rtol and atol
2e-5 for the forward and the core backward (the v3 body's exp2 softmax with
the scale folded into q, and the padded rows' sums, move f32 roundoff
only); rtol 1e-4 and atol 1e-5 for the whole backward and the autograd
gradients (sums over every row of both packages' f32 products, as
`tests/test_pallas_ops.py::TestFusedMhsaGrads`). D = 1024 with 16 heads is
the shape where JAX's size gate `_bwd_all_ok` fails and the split backward
runs K8b.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import geovpr.ops.pallas_mhsa as jm
from geovpr_torch.ops import mhsa as tm

# (B, N, D, H): the masked bodies, the key-split bodies, the split backward
MASKED, KEY_SPLIT, SPLIT = (2, 20, 128, 2), (2, 129, 128, 2), (1, 20, 1024,
                                                               16)
# N = 65 = 64 + 1, as DINOv2's N = 257 = 4 * 64 + 1: the card's core ends on
# a one-key (one-query) tile
ONE_KEY_TAIL = (1, 65, 128, 2)
# the f32 card core's edges, one head: N = 256 (no ragged tail), 257 (one
# key past the last whole 32, one query past the last 32-row tile), 281
# (past the 280 keys whose score rows a dq CTA keeps in shared memory)
F32_CORE_EDGES = ((1, 256, 64, 1), (1, 257, 64, 1), (1, 281, 64, 1))


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jm.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0):
    """x, the block's vectors and matrices and an upstream gradient g, f32
    numpy."""
    b, n, d, _ = shape
    rng = np.random.default_rng(seed)

    def r(*s, scale=1.0):
        return (rng.normal(size=s) * scale).astype(np.float32)

    args = [r(b, n, d), 1 + r(d, scale=0.1), r(d, scale=0.1),
            r(d, 3 * d, scale=d ** -0.5), r(3 * d, scale=0.1),
            r(d, d, scale=d ** -0.5), r(d, scale=0.1), r(d, scale=0.5)]
    return args, r(b, n, d)


def _unpad(flat, b, n):
    """JAX's flat padded (B*NP, W) residual -> (B, N, W)."""
    flat = np.asarray(flat)
    return flat.reshape(b, -1, flat.shape[-1])[:, :n]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("shape", [MASKED, KEY_SPLIT],
                         ids=["masked", "key_split"])
def test_forward_matches_jax(shape):
    b, n, d, h = shape
    args, _ = _inputs(shape)
    jout, jqkv, jctx = jm._fused_mhsa_pallas_train(
        *map(jnp.asarray, args), num_heads=h)
    out, qkv, ctx = tm.mhsa_train_fwd_reference(*map(_t, args), h)
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(qkv.numpy(), _unpad(jqkv, b, n), **tol)
    np.testing.assert_allclose(ctx.numpy(), _unpad(jctx, b, n), **tol)


@pytest.mark.parametrize("shape", [MASKED, KEY_SPLIT, SPLIT, ONE_KEY_TAIL,
                                   *F32_CORE_EDGES],
                         ids=["masked", "key_split", "split", "one_key_tail",
                              "n256", "n257", "n281"])
def test_core_backward_matches_jax(shape):
    """K8b: dqkv from the forward's qkv and a da that is zero on JAX's
    padded rows (as the padded g makes it)."""
    b, n, d, h = shape
    args, g = _inputs(shape, seed=1)
    _, jqkv, _ = jm._fused_mhsa_pallas_train(*map(jnp.asarray, args),
                                             num_heads=h)
    np_ = jqkv.shape[0] // b
    da = np.zeros((b, np_, d), np.float32)
    da[:, :n] = g
    jdqkv = jm._attn_bwd_pallas(jqkv, jnp.asarray(da.reshape(b * np_, d)),
                                num_heads=h, block_batch=1, n_valid=n,
                                bb_rows=np_)
    dqkv = tm.mhsa_attn_bwd_core_reference(_t(_unpad(jqkv, b, n)), _t(g), h)
    np.testing.assert_allclose(dqkv.numpy(), _unpad(jdqkv, b, n), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("shape", [MASKED, KEY_SPLIT],
                         ids=["masked", "key_split"])
def test_all_in_one_backward_matches_jax(shape):
    """K8c: every output of `_mhsa_bwd_all_pallas` from the same
    residuals."""
    b, n, d, h = shape
    args, g = _inputs(shape, seed=2)
    x, ls, lb, wqkv, bqkv, wo, bo, gamma = args
    _, jqkv, jctx = jm._fused_mhsa_pallas_train(*map(jnp.asarray, args),
                                                num_heads=h)
    np_ = jqkv.shape[0] // b

    def pad(a):
        out = np.zeros((b, np_, d), np.float32)
        out[:, :n] = a
        return jnp.asarray(out.reshape(b * np_, d))

    jouts = jm._mhsa_bwd_all_pallas(
        pad(x), jqkv, jctx, pad(g), *map(jnp.asarray, (wqkv, wo, bo, gamma,
                                                       ls, lb)),
        num_heads=h, n_valid=n, np_=np_, ln_eps=1e-6)
    jdx, jdwqkv, jdbqkv, jdwo, jdbo, jdgamma, jdls, jdlb = map(np.asarray,
                                                              jouts)
    got = tm.mhsa_train_bwd_reference(
        _t(x), _t(ls), _t(lb), _t(wqkv), _t(wo), _t(bo), _t(gamma),
        _t(_unpad(jqkv, b, n)), _t(_unpad(jctx, b, n)), _t(g), h)
    want = (_unpad(jdx, b, n), jdls, jdlb, jdwqkv, jdbqkv, jdwo, jdbo,
            jdgamma)
    for name, a, w in zip(("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo",
                           "dbo", "dgamma"), got, want):
        np.testing.assert_allclose(a.numpy(), w.reshape(a.shape), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_bwd_all_ok_matches_jax_gate():
    for np_, d, h in ((272, 768, 12), (272, 1024, 16)):
        assert tm.bwd_all_ok(d) == jm._bwd_all_ok(np_, d, h, jnp.bfloat16)
    assert tm.bwd_all_ok(768) and not tm.bwd_all_ok(1024)


@pytest.mark.parametrize("shape", [MASKED, KEY_SPLIT, SPLIT],
                         ids=["masked", "key_split", "split"])
def test_autograd_matches_jax_grad(shape):
    """`fused_mhsa_block_train`'s gradients (K8c's plain route, or at D =
    1024 the split route through K8b's wrapper) against `jax.grad` of
    `fused_mhsa_block`, whose custom VJP runs the interpreted kernels."""
    b, n, d, h = shape
    args, g = _inputs(shape, seed=3)

    def jloss(*a):
        return jnp.sum(jm.fused_mhsa_block(*a, num_heads=h)
                       * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=tuple(range(8)))(*map(jnp.asarray,
                                                           args))
    leaves = [_t(a).requires_grad_() for a in args]
    out = tm.fused_mhsa_block_train(*leaves, h)
    grads = torch.autograd.grad((out * _t(g)).sum(), leaves)
    for i, (a, w) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f"argument {i}")


def test_wrappers_take_the_plain_path_only_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; a device that is neither CPU nor CUDA is refused."""
    args, g = _inputs((1, 5, 64, 1))
    ta = [_t(a) for a in args]
    counts = [f.launches for f in (tm.fused_mhsa_train_fwd,
                                   tm.fused_mhsa_bwd_core,
                                   tm.fused_mhsa_bwd_all)]
    out, qkv, ctx = tm.fused_mhsa_train_fwd(*ta, 1)
    tm.fused_mhsa_bwd_core(qkv, _t(g), 1)
    tm.fused_mhsa_bwd_all(ta[0], ta[1], ta[2], ta[3], ta[5], ta[6], ta[7],
                          qkv, ctx, _t(g), 1)
    assert [f.launches for f in (tm.fused_mhsa_train_fwd,
                                 tm.fused_mhsa_bwd_core,
                                 tm.fused_mhsa_bwd_all)] == counts
    meta = [t.to("meta") for t in ta]
    with pytest.raises(ValueError, match="unsupported device"):
        tm.fused_mhsa_train_fwd(*meta, 1)


def _k8c_parts(x, ls, lb, wqkv, wo, bo, gamma, qkv, ctx, g, h, chunked):
    """K8c's plain parts in the order of its launches (K8C_PARTS: dy, dbo,
    da, dWo, dgamma, the core, the LN recompute, dWqkv, dbqkv, dh, the LN
    VJP); `chunked` sums the weight gradients in the kernel's row chunks
    (`wgrad_chunk`) and dgamma in its K8C_GY_ROWS-row partials."""
    from geovpr_torch.ops.swin_block import _ln_parts, wgrad_chunk
    b, n, d = x.shape
    dt, m = x.dtype, b * n
    gf = g.reshape(m, d).float()
    dy = gf * gamma.float()
    dyb = dy.to(dt)
    dbo = dy.sum(0)
    da = tm.vit_bwd_product_reference(dyb, wo)
    c2 = ctx.reshape(m, d)
    dwo = tm.vit_weight_grad_reference(
        c2, dyb, wgrad_chunk(m, d, d) if chunked else None)
    dgamma = tm.vit_dgamma_reference(c2, wo, bo, gf,
                                     tm.K8C_GY_ROWS if chunked else None)
    dqkv = tm.mhsa_attn_bwd_core_reference(qkv, da.reshape(b, n, d),
                                           h).reshape(m, 3 * d)
    xhat, rstd, hh = _ln_parts(x.reshape(m, d), ls, lb, 1e-6, dt)
    dwqkv = tm.vit_weight_grad_reference(
        hh, dqkv, wgrad_chunk(m, d, 3 * d) if chunked else None)
    dbqkv = dqkv.float().sum(0)
    dh = tm.vit_bwd_product_reference(dqkv, wqkv)
    dx, dls, dlb = tm.vit_ln_vjp_reference(dh, xhat, rstd, ls, gf)
    return (dx.to(dt).reshape(b, n, d), dls, dlb, dwqkv, dbqkv, dwo, dbo,
            dgamma)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8c_parts_compose_to_the_plain_version(dtype, chunked):
    """The plain parts of K8c's launches, composed, equal the all-in-one
    plain version bit for bit; summed as the kernel sums (M = 130 rows:
    five 32-row chunks of the weight gradients, the last of two rows, and
    three 64-row partials of dgamma, the last of two), only dWo, dWqkv and
    dgamma move, by the f32 reassociation: within 1e-5 of their largest
    value (and one bf16 spacing where the inputs are bf16)."""
    from geovpr_torch.ops.swin_block import wgrad_chunk
    b, n, d, h = ONE_KEY_TAIL[0] * 2, *ONE_KEY_TAIL[1:]
    m = b * n
    assert wgrad_chunk(m, d, d) == wgrad_chunk(m, d, 3 * d) == 32
    assert m % 32 and m % tm.K8C_GY_ROWS
    assert tm.K8C_PARTS == ("dy", "dbo", "da", "dwo", "dgamma", "core",
                            "ln_rows", "dwqkv", "dbqkv", "dh", "ln_vjp")
    args, g = _inputs((b, n, d, h), seed=4)
    x, ls, lb, wqkv, bqkv, wo, bo, gamma = map(_t, args)
    x, wqkv, wo, gt = (t.to(dtype) for t in (x, wqkv, wo, _t(g)))
    _, qkv, ctx = tm.mhsa_train_fwd_reference(x, ls, lb, wqkv, bqkv, wo, bo,
                                              gamma, h)
    got = _k8c_parts(x, ls, lb, wqkv, wo, bo, gamma, qkv, ctx, gt, h,
                     chunked)
    want = tm.mhsa_train_bwd_reference(x, ls, lb, wqkv, wo, bo, gamma, qkv,
                                       ctx, gt, h)
    for name, a, w in zip(("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo",
                           "dbo", "dgamma"), got, want):
        if chunked and name in ("dwqkv", "dwo", "dgamma"):
            err = (a.float() - w.float()).abs()
            tol = 1e-5 * w.float().abs().max()
            if dtype == torch.bfloat16:
                _, e = torch.frexp(w.float().abs())
                tol = tol + torch.ldexp(torch.ones_like(err), e - 8)
            assert (err <= tol).all(), name
        else:
            assert a.dtype == w.dtype and torch.equal(a, w), name


@pytest.mark.parametrize("variant", ["small-14", "base-14", "large-14"])
def test_k8_shape_rules_take_every_dinov2_variant(variant):
    """K8b's rule takes every DINOv2 variant's block; K8c's those where
    `bwd_all_ok` holds (large-14 takes the split backward with K8b); both
    refuse a head dim other than 64."""
    from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
    spec = DINOV2_VARIANTS[variant]
    d, h = spec["hidden_size"], spec["num_heads"]
    assert tm.k8b_shape_error(d, h) is None
    if tm.bwd_all_ok(d):
        assert tm.k8c_shape_error(d, h) is None
    else:
        assert "bwd_all_ok" in tm.k8c_shape_error(d, h)
    for err in (tm.k8b_shape_error(d, 2 * h), tm.k8c_shape_error(d, h // 2),
                tm.k8b_shape_error(d + 32, h)):
        assert err is not None and "head dim 64" in err
