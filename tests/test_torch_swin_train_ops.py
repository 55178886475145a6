"""The plain versions of the Swin training kernels K9a
(`swin_attn_train_reference`), K9b and K9c (`swin_attn_train_bwd_reference`,
all-in-one and split forms) against the JAX package's
`fused_swin_attn_train` with its Pallas kernels in interpret mode, forward
and VJP for all nine inputs; and the port's shifted Swin block under grad
(the raster-order wrappers' plain route) against JAX's `SwinBlock` training
path on a partitioned stream, which runs `repartition` -> `roll_relayout`
(K10b) forward and back.

All in f32; tolerance 3e-5 relative, as the JAX package's own kernel
tests use (tests/test_pallas_ops.py::TestFusedSwinAttnBlock), and 3e-5
absolute on the scale of each tensor (times max(1, max |expected|)): the
weight gradients are sums over every row, up to |30| here, whose f32
summation order differs between the two packages, so a near-zero element
of them carries the roundoff of its large neighbours.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import geovpr.ops.pallas_swin_block as psb
from geovpr_torch.ops.swin_block import (_ln_parts, bwd_product_reference,
                                         ln_vjp_reference,
                                         swin_attn_core_bwd_reference,
                                         swin_attn_train_bwd_reference,
                                         swin_attn_train_reference,
                                         weight_grad_reference, wgrad_chunk)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small shapes: the test workers share
    the cores, and torch's thread pool oversubscribed by them runs the
    tiny ops tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 3e-5
# (BW, N, C, H, nW, with_mask), as the JAX package's kernel tests
CASES = [(8, 16, 128, 2, 4, True), (8, 16, 128, 2, 1, False),
         (8, 16, 256, 8, 4, True)]


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(psb.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _case(bw, n, c, h, nw, with_mask, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    args = [r(bw, n, c), r(c, scale=0.1, shift=1.0), r(c, scale=0.1),
            r(c, 3 * c, scale=0.1), r(3 * c, scale=0.1), r(c, c, scale=0.1),
            r(c, scale=0.1), r(h, n, n, scale=0.2)]
    mask = (np.where(rng.random((nw, n, n)) < 0.2, -100.0, 0.0).astype(
        np.float32) if with_mask else None)
    return args, mask, r(bw, n, c)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=TOL,
                               atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(interpret, case):
    bw, n, c, h, nw, with_mask = case
    args, mask, _ = _case(*case)
    want = psb._swin_train_fwd_pallas(*map(jnp.asarray, args),
                                      None if mask is None
                                      else jnp.asarray(mask), h, 1e-5)
    y, qkv, ctx, p = swin_attn_train_reference(*map(_t, args), _t(mask), h)
    _close(y, want[0], "y")
    _close(qkv, want[1], "qkv")
    _close(ctx, want[2], "ctx")
    # JAX's p is (BW*N, H*N): row w*N + i, column h*N + j
    _close(p, np.asarray(want[3]).reshape(bw, n, h, n).transpose(0, 2, 1, 3),
           "p")


@pytest.mark.parametrize("case,split", [(c, False) for c in CASES]
                         + [(CASES[0], True)],
                         ids=["all_in_one-0", "all_in_one-1", "all_in_one-2",
                              "split-0"])
def test_vjp_matches_jax(interpret, monkeypatch, case, split):
    """All nine cotangents; `split` runs JAX's split backward (K9b + XLA)
    by turning `_bwd_fused_ok` off, and the port's split form (at the
    masked case: both forms share the core, so one shape covers what the
    split form adds)."""
    if split:
        monkeypatch.setattr(psb, "_bwd_fused_ok", lambda *a: False)
    bw, n, c, h, nw, with_mask = case
    args, mask, g = _case(*case)
    jmask = None if mask is None else jnp.asarray(mask)
    # the mask is an input like the others (None is an empty tree)
    _, vjp = jax.vjp(lambda *a: psb.fused_swin_attn_train(*a, h, 1e-5),
                     *map(jnp.asarray, args), jmask)
    want = vjp(jnp.asarray(g))
    if with_mask:
        assert not np.asarray(want[8]).any()    # the mask gets no gradient

    xw, ls, lb, wqkv, bqkv, wo, bo, bias = map(_t, args)
    _, qkv, ctx, p = swin_attn_train_reference(xw, ls, lb, wqkv, bqkv, wo, bo,
                                               bias, _t(mask), h)
    dx, dls, dlb, dwqkv, dbqkv, dwo, dbo, dbias = \
        swin_attn_train_bwd_reference(xw, ls, lb, wqkv, wo, qkv, ctx, p,
                                      _t(g), h, split=split)
    for name, got, w in zip(
            ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo", "dbias"),
            (dx, dls, dlb, dwqkv, dbqkv, dwo, dbo, dbias), want):
        _close(got, w, name)


def _k9c_parts(xw, ls, lb, wqkv, wo, qkv, ctx, p, g, h, chunk):
    """K9c's plain parts in the order of its launches (da, dWo, dbo, the
    core, the LN recompute, dWqkv, dbqkv, dh, the LN VJP), the weight
    gradients summed in `chunk`-row partials as the kernel sums them."""
    bw, n, c = xw.shape
    dt, m = xw.dtype, bw * n
    gb = g.reshape(m, c)
    da = bwd_product_reference(gb, wo)
    dwo = weight_grad_reference(ctx, gb, chunk)
    dbo = gb.float().sum(0)
    dqkv, dbias = swin_attn_core_bwd_reference(qkv, p, da, h)
    xhat, rstd, hh = _ln_parts(xw.reshape(m, c), ls, lb, 1e-5, dt)
    dwqkv = weight_grad_reference(hh, dqkv, chunk)
    dbqkv = dqkv.float().sum(0)
    dx, dls, dlb = ln_vjp_reference(bwd_product_reference(dqkv, wqkv), xhat,
                                    rstd, ls)
    return (dx.to(dt).reshape(bw, n, c), dls, dlb, dwqkv.to(wqkv.dtype),
            dbqkv, dwo.to(wo.dtype), dbo, dbias)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9c_parts_compose_to_the_plain_version(dtype, chunked):
    """The plain parts of K9c's launches, composed, equal the all-in-one
    plain version bit for bit; summed over the kernel's chunks of rows
    (`wgrad_chunk`: four 32-row chunks at this M = 128), only dWo and dWqkv
    move, by the f32 reassociation: within 1e-5 of their largest value
    (and one bf16 spacing where they are rounded to bf16)."""
    bw, n, c, h, nw, with_mask = CASES[0]
    args, mask, g = _case(*CASES[0])
    xw, ls, lb, wqkv, bqkv, wo, bo, bias = map(_t, args)
    xw, wqkv, wo, gt = (t.to(dtype) for t in (xw, wqkv, wo, _t(g)))
    _, qkv, ctx, p = swin_attn_train_reference(xw, ls, lb, wqkv, bqkv, wo, bo,
                                               bias, _t(mask), h)
    assert wgrad_chunk(bw * n, c, c) == wgrad_chunk(bw * n, c, 3 * c) == 32
    chunk = 32 if chunked else None
    got = _k9c_parts(xw, ls, lb, wqkv, wo, qkv, ctx, p, gt, h, chunk)
    want = swin_attn_train_bwd_reference(xw, ls, lb, wqkv, wo, qkv, ctx, p,
                                         gt, h)
    for name, a, b in zip(("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo",
                           "dbo", "dbias"), got, want):
        if chunked and name in ("dwqkv", "dwo"):
            err = (a.float() - b.float()).abs()
            tol = 1e-5 * b.float().abs().max()
            if dtype == torch.bfloat16:
                _, e = torch.frexp(b.float().abs())
                tol = tol + torch.ldexp(torch.ones_like(err), e - 8)
            assert (err <= tol).all(), name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name


def _partition(x, res, win):
    """raster (B, L, C) -> the unshifted (B*nW, N, C) window partition."""
    b, _, c = x.shape
    t = x.reshape(b, res // win, win, res // win, win, c)
    return t.transpose(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def _unpartition(xw, res, win):
    c = xw.shape[-1]
    b = xw.shape[0] // (res // win) ** 2
    t = xw.reshape(b, res // win, res // win, win, win, c)
    return t.transpose(0, 1, 3, 2, 4, 5).reshape(b, res * res, c)


def test_shifted_block_grads_match_jax_roll_relayout(interpret, monkeypatch):
    """A shifted Swin block under grad, the port on the raster stream
    against JAX's training path on its partitioned stream
    (`GEOVPR_FORCE_PALLAS=1`): `fused_swin_attn_train` between
    `repartition` -> `roll_relayout` (K10b) forward and back, then the MLP
    half. The loss is sum(out * G); every parameter's gradient and the
    input's must agree."""
    import geovpr.models.swin as jswin
    from geovpr_torch.models.convert_jax import state_dict_from_flax
    from geovpr_torch.models.swin import SwinBlock

    monkeypatch.setenv("GEOVPR_FORCE_PALLAS", "1")
    b, res, win, c, h, shift = 2, 8, 4, 128, 4, 2
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, res * res, c)).astype(np.float32)
    gout = rng.normal(size=x.shape).astype(np.float32)
    jblock = jswin.SwinBlock(dim=c, num_heads=h, resolution=res, window=win,
                             shift=shift, partitioned_io=True,
                             dtype=jnp.float32)
    xw = jnp.asarray(_partition(x, res, win))
    params = jblock.init(jax.random.PRNGKey(0), xw)["params"]
    # every parameter off its init (the table and biases start at 0)
    leaves, tree = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                    * (0.1 if p.ndim == 1 else 1.0 / np.sqrt(p.shape[0]))
                    + (1.0 if p.ndim == 1 and p.shape[0] == c and i % 7 == 0
                       else 0.0))
        for i, p in enumerate(leaves)])
    gw = jnp.asarray(_partition(gout, res, win))

    def loss(p, xx):
        return jnp.sum(jblock.apply({"params": p}, xx, deterministic=False)
                       * gw)

    calls = []
    orig = psb.roll_relayout
    monkeypatch.setattr(psb, "roll_relayout",
                        lambda *a, **k: calls.append(a[1]) or orig(*a, **k))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, xw)
    assert sorted(set(calls)) == [-1, 1]    # forward and inverse relayouts

    blk = SwinBlock(c, h, res, win, shift)
    blk.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    blk.train()
    xt = torch.from_numpy(x).requires_grad_()
    out = blk(xt)
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(gout)).sum(),
                                [xt] + [p for _, p in blk.named_parameters()])
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgp))
    _close(grads[0], _unpartition(np.asarray(jgx), res, win), "dx")
    for n, g in zip(names, grads[1:]):
        _close(g, want[n].numpy(), n)
