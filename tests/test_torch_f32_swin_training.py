"""f32 Swin training on the card: the training kernels K9a-K9c take an f32
stream (K9a.f32 on K4.f32's launches in `geovpr_torch/csrc/f32_serving.cu`,
K9b.f32 and K9c.f32 in `geovpr_torch/csrc/f32_train.cu`) as well as a bf16
one, for a window-12 Swin built with compute_dtype="float32".

Here, without a card: the type rule `k9_dtype_error` as a pure function and
`_check_train_cuda` applying it to the whole set; the backward route
against JAX's `_bwd_fused_ok` at each Swin-B-384 stage, in both dtypes; one
f32 training step's gradients of a window-12 Swin block on each route (the
port's plain route) against JAX's `SwinBlock` training path with its
Pallas kernels interpreted; an f32 model reaching the K9 wrappers with f32
tensors; the f32 convolutions with cuDNN's TF32 off; and the bound
arithmetic of chip_smoke.py's f32 K9 rows. The kernels themselves are
checked on the card (tests/test_torch_cuda.py, `-k f32`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke as cs
import geovpr.models.swin as jswin
import geovpr.ops.pallas_swin_block as psb
from geovpr_torch.models import layers, swin
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.ops import swin_block as sb

BF16, F32 = torch.bfloat16, torch.float32
STREAM = ("x", "wqkv", "wo", "qkv", "ctx", "p", "g", "da")
VECTORS = ("ln_scale", "ln_bias", "bqkv", "bo", "table")
# Swin-B-384 at its B = 16: (C, heads, resolution) of stages 0-3
SWIN_B_STAGES = ((128, 4, 96), (256, 8, 48), (512, 16, 24), (1024, 32, 12))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set(stream_dtype, **over):
    return {**dict.fromkeys(STREAM, stream_dtype),
            **dict.fromkeys(VECTORS, F32), **over}


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_k9_rule_takes_one_dtype(dtype):
    assert sb.k9_dtype_error(_set(dtype)) is None
    # the wrappers' own sets: K9a's, K9b's and K9c's arguments
    for names in (("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wo", "bo",
                   "table"), ("qkv", "p", "da"),
                  ("x", "ln_scale", "ln_bias", "wqkv", "wo", "qkv", "ctx",
                   "p", "g")):
        assert sb.k9_dtype_error({k: _set(dtype)[k] for k in names}) is None


@pytest.mark.parametrize("base", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", STREAM)
def test_k9_rule_refuses_a_mixed_set(name, base):
    """One stream tensor in the other dtype: refused, naming it."""
    other = F32 if base == BF16 else BF16
    err = sb.k9_dtype_error(_set(base, **{name: other}))
    assert err and f"{name} is {other}" in err and f"the rest {base}" in err


@pytest.mark.parametrize("name", VECTORS)
def test_k9_rule_refuses_a_vector_off_f32(name):
    for base in (BF16, F32):
        err = sb.k9_dtype_error(_set(base, **{name: BF16}))
        assert err and name in err and "torch.float32" in err
    assert "torch.float16" in sb.k9_dtype_error(_set(torch.float16))


def test_check_train_cuda_takes_the_whole_set():
    """`_check_train_cuda` gives the rule every tensor at once: an all-f32
    set passes, one bf16 matrix among f32 tensors is refused by name (a
    rule given one tensor at a time would pass each)."""
    x = torch.zeros(1, 144, 128)
    mats = {"wqkv": torch.zeros(128, 384), "wo": torch.zeros(128, 128)}
    vecs = {k: torch.zeros(8) for k in ("ln_scale", "ln_bias", "bo")}
    sb._check_train_cuda({"x": x, **mats, **vecs}, 128, 4, 12, 6)
    with pytest.raises(TypeError, match="wo is torch.bfloat16"):
        sb._check_train_cuda({"x": x, **mats, **vecs,
                              "wo": mats["wo"].bfloat16()}, 128, 4, 12, 6)
    with pytest.raises(TypeError, match="x is torch.float32"):
        sb._check_train_cuda({"x": x, **{k: v.bfloat16() for k, v in
                                         mats.items()}, **vecs},
                             128, 4, 12, 6)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("stage", range(4))
def test_backward_route_matches_jax_at_each_stage(monkeypatch, stage,
                                                  dtype):
    """The port's backward route (the all-in-one K9c for C <= 512, the
    split route around K9b above) is JAX's `_bwd_fused_ok` at each
    Swin-B-384 stage (B = 16), in either stream dtype: the port's
    `_SwinAttnTrain` picks it from C alone, run here on one window of the
    stage's width."""
    c, h, res = SWIN_B_STAGES[stage]
    bw = 16 * (res // 12) ** 2
    want_split = not psb._bwd_fused_ok(144, c, bw, h)
    assert want_split == (c > 512)
    routes = []
    orig = sb._train_plain_bwd
    monkeypatch.setattr(sb, "_train_plain_bwd", lambda *a, split: (
        routes.append(split) or orig(*a, split=split)))
    gen = torch.Generator().manual_seed(stage)
    x = (torch.randn(1, 144, c, generator=gen) * 0.1).to(dtype)
    args = [x.requires_grad_(), torch.ones(c), torch.zeros(c),
            (torch.randn(c, 3 * c, generator=gen) * c ** -0.5).to(dtype),
            torch.zeros(3 * c),
            (torch.randn(c, c, generator=gen) * c ** -0.5).to(dtype),
            torch.zeros(c), torch.zeros(23 * 23, h)]
    y = sb.fused_swin_attn_train(*args, h, 12, 12, 0, kernels=False)
    (gx,) = torch.autograd.grad(y.float().sum(), args[0])
    assert routes == [want_split]
    assert gx.dtype == dtype and torch.isfinite(gx.float()).all()


@pytest.fixture
def _interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(psb.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


# (route, C, heads, resolution, shift): a shifted stage-0-wide block on
# four windows takes the all-in-one backward, a C = 640 block the split one
ROUTE_BLOCKS = [("all_in_one", 128, 4, 24, 6), ("split", 640, 20, 12, 0)]


@pytest.mark.parametrize("route,c,h,res,shift", ROUTE_BLOCKS,
                         ids=[r[0] for r in ROUTE_BLOCKS])
def test_f32_step_gradients_match_jax(_interpret, monkeypatch, route, c, h,
                                      res, shift):
    """One f32 training step of a window-12 Swin block, the loss sum(out *
    G): JAX's `SwinBlock` on its training path (`GEOVPR_FORCE_PALLAS=1`,
    `fused_swin_attn_train` with its Pallas kernels interpreted, the route
    `_bwd_fused_ok` picks) against the port's block under grad
    (`fused_swin_attn_train` with kernels on: on CPU tensors K9c's and the
    split route's wrappers run their plain versions): the input's and
    every parameter's gradient within rtol 1e-4 and atol 1e-5, and both
    packages on the same backward route. G is drawn at 0.1 so that the
    gradients are of order 1 (the largest about 1): the absolute 1e-5 is
    then f32 roundoff's room on the elements near zero, whose sums over
    every token run in another order in the two packages."""
    monkeypatch.setenv("GEOVPR_FORCE_PALLAS", "1")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, res * res, c)).astype(np.float32)
    gout = (rng.normal(size=x.shape) * 0.1).astype(np.float32)
    jblock = jswin.SwinBlock(dim=c, num_heads=h, resolution=res, window=12,
                             shift=shift, dtype=jnp.float32)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                    * (0.1 if p.ndim == 1 else 1.0 / np.sqrt(p.shape[0]))
                    + (1.0 if p.ndim == 1 and i % 7 == 0 else 0.0))
        for i, p in enumerate(leaves)])
    jroutes, troutes = [], []
    jok = psb._bwd_fused_ok
    monkeypatch.setattr(psb, "_bwd_fused_ok",
                        lambda *a: jroutes.append(jok(*a)) or jroutes[-1])
    for name, split in (("fused_swin_attn_bwd_all", False),
                        ("swin_attn_train_bwd_split", True)):
        orig = getattr(sb, name)
        monkeypatch.setattr(sb, name, lambda *a, f=orig, s=split: (
            troutes.append(s) or f(*a)))

    def loss(p, xx):
        return jnp.sum(jblock.apply({"params": p}, xx, deterministic=False)
                       * jnp.asarray(gout))

    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    blk = swin.SwinBlock(c, h, res, 12, shift)
    blk.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    blk.train()
    xt = torch.from_numpy(x).requires_grad_()
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad((blk(xt) * torch.from_numpy(gout)).sum(),
                                [xt] + [p for _, p in blk.named_parameters()])
    assert jroutes and set(jroutes) == {route == "all_in_one"}
    assert troutes == [route == "split"]
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgp))
    assert all(g.dtype == F32 for g in grads)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5, err_msg="x")
    for n, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def _recorded(monkeypatch, name, mats, calls):
    """Wrap `swin_block.name` so that each call records the wrapper's name
    and the dtypes of its arguments at positions `mats`."""
    orig = getattr(sb, name)

    def rec(*args, **kwargs):
        calls.append((name, tuple(args[i].dtype for i in mats)))
        return orig(*args, **kwargs)

    monkeypatch.setattr(sb, name, rec)


def test_f32_model_reaches_the_k9_wrappers_with_f32(monkeypatch):
    """A two-stage window-12 Swin built in f32 (C = 320, then 640) under
    grad: every block's forward calls K9a's wrapper, the C <= 512 blocks'
    backward K9c's and the C = 640 block's K9b's, each with f32 streams,
    matrices and residuals; every parameter's gradient is f32 and
    finite."""
    calls = []
    _recorded(monkeypatch, "fused_swin_attn_train_fwd", (0, 3, 5), calls)
    _recorded(monkeypatch, "fused_swin_attn_bwd_all", (0, 3, 4, 5, 6, 7, 8),
              calls)
    _recorded(monkeypatch, "fused_swin_attn_bwd_core", (0, 1, 2), calls)
    model = swin.SwinTransformer(embed_dim=320, depths=(2, 1),
                                 num_heads=(10, 20), window_size=12,
                                 image_size=96, dtype=F32)
    layers.init_weights_(model, torch.Generator().manual_seed(0))
    model.train()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 96, 96, 3)).astype(np.float32))
    out = model(x)
    grads = torch.autograd.grad(out.pooled.square().sum(),
                                list(model.parameters()))
    got = {}
    for name, dtypes in calls:
        assert all(dt == F32 for dt in dtypes), (name, dtypes)
        got[name] = got.get(name, 0) + 1
    assert got == {"fused_swin_attn_train_fwd": 3,
                   "fused_swin_attn_bwd_all": 2,
                   "fused_swin_attn_bwd_core": 1}
    assert all(g.dtype == F32 and torch.isfinite(g).all() for g in grads)


def test_f32_wrappers_take_the_plain_path_on_the_cpu():
    """On f32 CPU tensors K9a, K9b and K9c run their plain versions, in
    f32, and count no launch."""
    a, g, geom = cs.k9_case((1, 128, 4, 24, 12, 6), "cpu",
                            dtype=torch.float32)
    geo = tuple(geom.values())
    fa = [a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wo",
                         "bo", "table")]
    fns = (sb.fused_swin_attn_train_fwd, sb.fused_swin_attn_bwd_core,
           sb.fused_swin_attn_bwd_all)
    counts = [f.launches for f in fns]
    y, qkv, ctx, p = sb.fused_swin_attn_train_fwd(*fa, *geo)
    dqkv, dbias = sb.fused_swin_attn_bwd_core(qkv, p, g, *geo)
    grads = sb.fused_swin_attn_bwd_all(fa[0], fa[1], fa[2], fa[3], fa[5], qkv,
                                       ctx, p, g, *geo)
    assert [f.launches for f in fns] == counts
    assert all(t.dtype == F32 for t in (y, qkv, ctx, p, dqkv, dbias, *grads))
    want = sb._train_plain_bwd(fa[0], fa[1], fa[2], fa[3], fa[5], qkv, ctx,
                               p, g, *geo, 1e-5, split=False)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)


def _conv_models():
    """One f32 model of each family with convolutions, tiny: (name,
    model, NHWC input)."""
    from geovpr_torch.models.convnext import ConvNeXt
    from geovpr_torch.models.dinov2 import DinoV2
    from geovpr_torch.models.efficientnet import EfficientNetB0
    return [
        ("swin", swin.SwinTransformer(embed_dim=32, depths=(1,),
                                      num_heads=(1,), window_size=12,
                                      image_size=48, dtype=F32), 48, 1),
        ("dinov2", DinoV2(hidden_size=64, num_layers=1, num_heads=1,
                          image_size=28, dtype=F32), 28, 1),
        ("convnext", ConvNeXt(depths=(1, 1), dims=(32, 64), dtype=F32), 32,
         4),
        ("efficientnet", EfficientNetB0(dtype=F32), 32, None)]


@pytest.mark.parametrize("index", range(4),
                         ids=["swin", "dinov2", "convnext", "efficientnet"])
def test_f32_convolutions_run_without_tf32(monkeypatch, index):
    """Every convolution an f32 model runs, forward and backward, sees
    cuDNN's TF32 off and its deterministic algorithms on
    (`layers.conv2d`), whatever the process-wide settings, which are put
    back after each call: torch's defaults would let cuDNN convolve f32 in
    TF32 on the card, and sum a weight gradient in a varying order."""
    name, model, size, want = _conv_models()[index]
    seen = []
    conv, bwd = torch.nn.functional.conv2d, torch.ops.aten.convolution_backward

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.deterministic)

    def rec_conv(*a, **k):
        seen.append(("fwd", flags()))
        return conv(*a, **k)

    def rec_bwd(*a, **k):
        seen.append(("bwd", flags()))
        return bwd(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "conv2d", rec_conv)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", rec_bwd)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    layers.init_weights_(model, torch.Generator().manual_seed(0))
    model.train()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, size, size, 3)).astype(np.float32))
    out = model(x)
    torch.autograd.grad(out.pooled.square().sum(),
                        [p for p in model.parameters() if p.requires_grad],
                        allow_unused=True)
    fwd = [f for k, f in seen if k == "fwd"]
    assert fwd and len([f for k, f in seen if k == "bwd"]) == len(fwd)
    if want is not None:
        assert len(fwd) == want
    assert all(f == (False, True) for _, f in seen)
    assert flags() == (True, False)


def test_f32_swin_training_bounds_by_hand():
    """chip_smoke.py's bounds of the f32 K9 rows at Swin-B-384 (B = 16),
    the CUDA cores' 66.9 TFLOP/s at 1,980 MHz. Stage 0 (C = 128, 4 heads, M
    = 147,456 rows, 1,024 windows of N = 144): K9a 14.5 GFLOP of QKV, 10.9
    of attention and 4.8 of out projection, ~0.45 ms; K9c 38.7 GFLOP of
    products and 21.7 of the core, ~0.90 ms. Stage 3 (C = 1024, 32 heads,
    16 windows): K9b 2.7 GFLOP, 0.041 ms, against 111 MB of bytes, 0.033
    ms."""
    peak = cs.f32_peak(1980.0)
    stage0, stage3 = cs.K9_SHAPES[0], cs.K9_SHAPES[3]
    m0, m3 = 16 * 96 * 96, 16 * 12 * 12
    att0 = 2 * 1024 * 4 * 144 * 144 * 32
    att3 = 2 * 16 * 32 * 144 * 144 * 32
    k9a = cs.f32_swin_train_bounds("K9a", stage0, peak)
    assert 6 * m0 * 128 ** 2 == pytest.approx(14.5e9, rel=2e-3)
    assert 2 * att0 == pytest.approx(10.9e9, rel=3e-3)
    assert k9a["ops"] == 8 * m0 * 128 ** 2 + 2 * att0
    assert k9a["bound_ms"] == pytest.approx(0.451, rel=3e-3)
    assert k9a["bound_by"] == "operations"
    k9c = cs.f32_swin_train_bounds("K9c", stage0, peak)
    assert 16 * m0 * 128 ** 2 == pytest.approx(38.7e9, rel=2e-3)
    assert 4 * att0 == pytest.approx(21.7e9, rel=2e-3)
    assert k9c["ops"] == 16 * m0 * 128 ** 2 + 4 * att0
    assert k9c["bound_ms"] == pytest.approx(0.903, rel=3e-3)
    k9b = cs.f32_swin_train_bounds("K9b", stage3, peak)
    assert k9b["ops"] == 4 * att3 == pytest.approx(2.72e9, rel=2e-3)
    assert k9b["bound_ms"] == pytest.approx(0.0406, rel=3e-3)
    assert k9b["bound_by"] == "operations"
    # bytes: qkv, da, dqkv (7 M C), the p plane and dbias, 4 bytes a value
    plane3 = 16 * 32 * 144 * 144
    assert k9b["bytes"] == 4 * (7 * m3 * 1024 + plane3 + 32 * 144 * 144)
    assert k9b["bytes"] == pytest.approx(111.2e6, rel=1e-3)
    assert k9b["bytes_bound_ms"] == pytest.approx(0.0332, rel=3e-3)
