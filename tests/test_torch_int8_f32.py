"""w8a8 serving with an f32 stream: K2, K3 and K5 take compute_dtype
"float32" (`csrc/hopper_gemm_s8.cuh`'s LN-quant pass and residual
epilogues in the stream's type), as `cli.evaluate --int8` and `cli.fuse
--int8` build an int8 model from an f32 configuration or run directory.

Here, without a card:
- the type rules as pure functions (`k2_dtype_error`, `k3_dtype_error`,
  `k5_dtype_error`);
- the plain f32 versions against JAX's kernels interpreted on f32 x
  (`pallas_mlp.py:123`, `pallas_mhsa.py:611` and `pallas_swin_block.py:
  1230` write x's dtype). int8 products are exact on both sides; they
  differ only where an f32 reduction lands a value on the other side of an
  int8 rounding. A flipped value of the int8 vector an output is computed
  from moves the output by |w_q| dequant steps, up to 127 (a full-scale
  weight), so the bound on the largest error is
  tests/test_torch_swin_ops.py's two-flip bound, 2 x 127 x max|step| +
  1e-3, and at most 1% of the elements may be off by more than 1e-3 (the
  share of `chip_smoke.int8_within_bound`). K2 misses the JAX package's
  one-step bound (1.5 max|step| + 1e-3, tests/test_pallas_ops.py:458-460;
  measured 2.1e-3 against 1.03e-3) and a 2% share off by more than 1e-5
  (measured 7.9%): the port rounds the last key's p to bf16 where JAX's
  kernel keeps it in f32 (`vit_attention8_reference`), which flips a
  context value in about 9% of the rows, in bf16 as in f32;
- the model routes: an f32 int8 DINOv2 + SALAD and a window-12 Swin, JAX's
  kernel route interpreted with the backend reported as "tpu" against the
  port's kernel route driven on the CPU through `layers.int8_kernel_route`
  (its plain versions run where the kernels would): both hand K2 and K5 a
  bf16 stream and K3 the f32 one, under the cosine bound of
  tests/test_torch_int8_model.py's bf16 kernel test (0.9995);
- the bound arithmetic of chip_smoke.py's [int8_f32] rows against counts
  made by hand.
The kernels themselves are checked on the card (tests/test_torch_cuda.py,
`-k int8_f32`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke as cs
import geovpr.models.salad as jsalad
import geovpr.models.swin as jswin
import geovpr.ops.pallas_mhsa as pmhsa
import geovpr.ops.pallas_mlp as pmlp
import geovpr.ops.pallas_swin_block as psb
from geovpr.models.quantize import quantize_for_serving as j_quantize
from geovpr_torch.models import dinov2 as tdinov2
from geovpr_torch.models import layers
from geovpr_torch.models import salad as tsalad
from geovpr_torch.models import swin as tswin
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.ops.mhsa import k2_dtype_error, mhsa_block_int8_reference
from geovpr_torch.ops.mlp_int8 import k3_dtype_error, mlp_block_int8_reference
from geovpr_torch.ops.swin_block import (k5_dtype_error,
                                         swin_attn_block_int8_reference)

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small shapes: the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# kernel -> (its rule, the stream, the int8 matrices, the f32 vectors)
RULES = {
    "K2": (k2_dtype_error, ("x",), ("wqkv_q_t", "wo_q_t"),
           ("ln_scale_q", "ln_bias_q", "sqkv_eff", "bqkv_eff", "so_eff",
            "bo", "gamma")),
    "K3": (k3_dtype_error, ("x", "residual"), ("w1q_t", "w2q_t"),
           ("ln_scale_q", "ln_bias_q", "s1_eff", "b1", "s2_eff", "b2",
            "gamma")),
    "K5": (k5_dtype_error, ("x",), ("wqkv_q_t", "wo_q_t"),
           ("ln_scale_q", "ln_bias_q", "sqkv_eff", "bqkv_eff", "so_eff",
            "bo", "table")),
}


def _dtypes(kernel, stream, mats=I8, vecs=F32):
    _, names, mat_names, vec_names = RULES[kernel]
    return {**dict(zip(names, stream)), **dict.fromkeys(mat_names, mats),
            **dict.fromkeys(vec_names, vecs)}


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("kernel", sorted(RULES))
def test_int8_rules_take_bf16_and_f32(kernel, dtype):
    rule, stream, _, _ = RULES[kernel]
    assert rule(_dtypes(kernel, [dtype] * len(stream))) is None
    # K3 without its separate residual
    assert rule({k: v for k, v in _dtypes(kernel, [dtype] * 2).items()
                 if k != "residual"}) is None


@pytest.mark.parametrize("kernel", sorted(RULES))
def test_int8_rules_refuse_f16_mixed_and_misplaced_types(kernel):
    """An f16 stream; K3's residual in another dtype than x (an f32
    residual with a bf16 x, and the other way round); an f32 matrix; a
    bf16 vector. Each message names the kernel and the offending type."""
    rule, stream, mats, vecs = RULES[kernel]
    err = rule(_dtypes(kernel, [torch.float16] * len(stream)))
    assert err and kernel in err and "torch.float16" in err
    if len(stream) > 1:
        assert rule(_dtypes(kernel, [BF16, F32]))
        assert rule(_dtypes(kernel, [F32, BF16]))
    err = rule(_dtypes(kernel, [F32] * len(stream), mats=F32))
    assert err and mats[0] in err and "torch.int8" in err
    err = rule(_dtypes(kernel, [F32] * len(stream), vecs=BF16))
    assert err and vecs[0] in err and "torch.float32" in err


# -------------------------------------------- plain f32 against JAX ----

@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor)
                       else np.float32(t))


def _flip_bound(step):
    return 2 * 127 * float(np.abs(np.asarray(step)).max()) + 1e-3


def _assert_close(got, want, step):
    err = np.abs(got.numpy() - np.asarray(want, np.float32))
    assert err.max() <= _flip_bound(step), err.max()
    assert np.mean(err > 1e-3) <= cs.INT8_MAX_SHARE


@pytest.mark.parametrize("residual", [False, True])
def test_k3_plain_f32_matches_jax_kernel(interpret, residual):
    """D = 128, hidden 512, 24 rows of an f32 DINOv2 block's fold; with and
    without the separate residual."""
    x, _, k3 = cs.int8_block_case(2, 12, 128, 2, torch.device("cpu"),
                                  dtype=F32)
    res = (torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
           if residual else None)
    want = pmlp.fused_mlp_block_int8(
        _j(x), _j(k3["ln_scale_q"]), _j(k3["ln_bias_q"]), _j(k3["w1q_t"]).T,
        _j(k3["s1_eff"]), _j(k3["b1"]), _j(k3["w2q_t"]).T, _j(k3["s2_eff"]),
        _j(k3["b2"]), _j(k3["gamma"]), _j(k3["inv_a_mid"]),
        residual=None if res is None else _j(res))
    assert want.dtype == jnp.float32
    got = mlp_block_int8_reference(x, **k3, residual=res)
    assert got.dtype == F32
    _assert_close(got, want, k3["s2_eff"] * k3["gamma"])


def test_k2_plain_f32_matches_jax_kernel(interpret):
    """At the DINOv2 block width of tests/test_torch_int8_kernels.py's
    `test_k2_plain_matches_jax_kernel_at_block_width` (D = 128, two heads
    of 64, N = 129: JAX's key split), f32 x, the default mode. Measured
    max 2.1e-3 (context flips), 0.29% of the elements off by more than
    1e-3."""
    x, k2, _ = cs.int8_block_case(2, 129, 128, 2, torch.device("cpu"),
                                  dtype=F32)
    want = pmhsa.fused_mhsa_block_int8(
        _j(x), _j(k2["ln_scale_q"]), _j(k2["ln_bias_q"]),
        _j(k2["wqkv_q_t"]).T, _j(k2["sqkv_eff"]), _j(k2["bqkv_eff"]),
        _j(k2["wo_q_t"]).T, _j(k2["so_eff"]), _j(k2["bo"]), _j(k2["gamma"]),
        num_heads=2, cs=_j(k2["cs"]) * pmhsa._LOG2E)
    assert want is not None and want.dtype == jnp.float32
    got = mhsa_block_int8_reference(x, **k2, num_heads=2)
    assert got.dtype == F32
    _assert_close(got, want, k2["so_eff"] * k2["gamma"])


def test_k5_plain_f32_matches_jax_kernel(interpret):
    """One window of 12 x 12 tokens (B = 2, C = 128, four heads), f32 x,
    the default mode; JAX's kernel on the window (the raster order is the
    window's at one window an image)."""
    shape = (2, 128, 4, 12, 12, 0)
    x, blk = cs.swin_block_case(shape, torch.device("cpu"), int8=True,
                                dtype=F32)
    kw = cs.k5_kwargs(blk)
    n = 144
    table = kw["table"].detach().numpy()
    bias = table[jswin.relative_position_index(12).reshape(-1)].reshape(
        n, n, 4).transpose(2, 0, 1)
    want = psb.fused_swin_attn_block_int8(
        _j(x), _j(kw["ln_scale_q"]), _j(kw["ln_bias_q"]),
        _j(kw["wqkv_q_t"]).T, _j(kw["sqkv_eff"]), _j(kw["bqkv_eff"]),
        _j(kw["wo_q_t"]).T, _j(kw["so_eff"]), _j(kw["bo"]),
        jnp.asarray(bias), None, 4, 1e-5,
        cs=jnp.float32(kw["cs"]) * jswin._SWIN_LOG2E)
    assert want is not None and want.dtype == jnp.float32
    with torch.no_grad():
        got = swin_attn_block_int8_reference(x, **kw)
    assert got.dtype == F32
    _assert_close(got, want, kw["so_eff"])


# ------------------------------------------------------- model routes ----

def _perturbed(model, x, seed):
    rng = np.random.default_rng(seed)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    return {"params": jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
            np.float32) * 0.05, v["params"])}


def _cosine(got, want):
    g = got.float().numpy().reshape(got.shape[0], -1)
    w = np.asarray(want, np.float32).reshape(g.shape)
    return (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                              * np.linalg.norm(w, axis=-1))


@pytest.fixture
def kernel_routes(monkeypatch):
    """JAX's serving kernels interpreted with the backend reported as
    "tpu", the port's blocks on their kernel route on the CPU; spies on
    both packages' K2, K3 and K5 record the stream dtype each receives."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(layers, "int8_kernel_route",
                        lambda x, use_kernels: use_kernels)
    seen = {"jax": [], "port": []}

    def spy(side, name, fn):
        def call(x, *a, **k):
            seen[side].append((name, str(x.dtype).replace("torch.", "")))
            return fn(x, *a, **k)
        return call

    for module, name in ((pmhsa, "fused_mhsa_block_int8"),
                         (pmlp, "fused_mlp_block_int8"),
                         (psb, "fused_swin_attn_block_int8")):
        monkeypatch.setattr(module, name,
                            spy("jax", name, getattr(module, name)))
    for module, name in ((tdinov2, "fused_mhsa_block_int8"),
                         (tdinov2, "fused_mlp_block_int8"),
                         (tswin, "fused_swin_attn_block_int8"),
                         (tswin, "fused_mlp_block_int8")):
        monkeypatch.setattr(module, name,
                            spy("port", name, getattr(module, name)))
    return seen


def test_dinov2_salad_f32_int8_kernel_routes_match(kernel_routes,
                                                   monkeypatch):
    """One block of 64 at 257 tokens (patch 2 on 32 x 32 images): JAX's
    block casts to bf16 around K2 and hands K3 the f32 stream; so does the
    port's on its kernel route. Measured min cosine 0.9999999, held to the
    bf16 kernel test's 0.9995."""
    variant = dict(hidden_size=64, num_layers=1, num_heads=4, patch_size=2)
    monkeypatch.setitem(jsalad.DINOV2_VARIANTS, "tiny257", variant)
    monkeypatch.setitem(tsalad.DINOV2_VARIANTS, "tiny257", variant)
    x = np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jm = jsalad.DinoV2Salad(variant="tiny257", image_size=32, int8_mlp=True,
                            int8_attn=True)
    vq = j_quantize(jm, _perturbed(jm, x, 0), [jnp.asarray(x)])
    kernel_routes["jax"].clear()
    want = jax.jit(jm.apply)(vq, jnp.asarray(x)).pooled
    assert kernel_routes["jax"] == [("fused_mhsa_block_int8", "bfloat16"),
                                    ("fused_mlp_block_int8", "float32")]
    tm = tsalad.DinoV2Salad(variant="tiny257", image_size=32, dtype=F32,
                            int8_attn=True, int8_mlp=True)
    tm.load_state_dict(state_dict_from_flax(vq))
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x)).pooled
    assert kernel_routes["port"] == kernel_routes["jax"]
    assert got.dtype == F32 and got.shape == want.shape
    assert _cosine(got, want).min() >= 0.9995


def test_swin_window12_f32_int8_kernel_routes_match(kernel_routes):
    """A one-stage window-12 Swin (C = 128, four heads, 24 x 24 tokens:
    the second block shifted): JAX's blocks cast to bf16 around K5 and hand
    K3 the f32 stream; so do the port's on their kernel route. Measured
    min cosine 0.99999994, held as the DINOv2 case."""
    cfg = dict(embed_dim=128, depths=(2,), num_heads=(4,), window_size=12,
               image_size=96)
    x = np.random.default_rng(3).normal(size=(1, 96, 96, 3)).astype(
        np.float32)
    jm = jswin.SwinTransformer(**cfg, drop_path_rate=0.0, int8_mlp=True,
                               int8_attn=True)
    vq = j_quantize(jm, _perturbed(jm, x, 3), [jnp.asarray(x)])
    kernel_routes["jax"].clear()
    want = jax.jit(jm.apply)(vq, jnp.asarray(x))
    assert kernel_routes["jax"] == [
        ("fused_swin_attn_block_int8", "bfloat16"),
        ("fused_mlp_block_int8", "float32")] * 2
    tm = tswin.SwinTransformer(**cfg, dtype=F32, int8_attn=True,
                               int8_mlp=True)
    tm.load_state_dict(state_dict_from_flax(vq), strict=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert kernel_routes["port"] == kernel_routes["jax"]
    assert got.pooled.dtype == F32
    assert _cosine(got.pooled, want.pooled).min() >= 0.9995


# ------------------------------------------------ [int8_f32] bounds ----

@pytest.mark.parametrize("kind,args,ops_t,nbytes,bound_by", [
    # K3 at DINOv2-B/14, B=64: 4 M D 4D int8 operations; x and out f32,
    # W1 and W2 int8, 2D + 2 hid + 3D f32 vector values
    ("K3", ((64, 257, 768, 12), {}),
     4 * 16_448 * 768 * 3_072 / cs.PEAK_INT8,
     2 * 16_448 * 768 * 4 + 2 * 768 * 3_072 + (2 * 768 + 2 * 3_072
                                                + 3 * 768) * 4,
     "operations"),
    # K3 at ConvNeXt-B stage 0, B=64: 200,704 rows of 128 and the f32
    # residual read too
    ("K3", ((64, 3_136, 128, 1), {"residual": True}),
     4 * 200_704 * 128 * 512 / cs.PEAK_INT8,
     3 * 200_704 * 128 * 4 + 2 * 128 * 512 + (2 * 128 + 2 * 512
                                                + 3 * 128) * 4,
     "bytes"),
    # K2 at 64 x 257 x 768 x 12, int8 scores: the projections 2 M D 4D
    # and q.k^T (2 B H N^2 dh) in int8, P.V in bf16
    ("K2", ((64, 257, 768, 12), {"mode": "int8_scores"}),
     (2 * 16_448 * 768 * 3_072 + 2 * 64 * 12 * 257 ** 2 * 64)
     / cs.PEAK_INT8 + 2 * 64 * 12 * 257 ** 2 * 64 / cs.PEAK_BF16,
     2 * 16_448 * 768 * 4 + 4 * 768 ** 2 + 11 * 768 * 4, "operations")])
def test_int8_f32_bounds_match_hand_counts(kind, args, ops_t, nbytes,
                                           bound_by):
    shape, kw = args
    got = cs.bounds(kind, *shape, width=4, **kw)
    assert got["ops_bound_ms"] == pytest.approx(ops_t * 1e3, rel=1e-12)
    assert got["bytes_bound_ms"] == pytest.approx(
        nbytes / cs.PEAK_BYTES * 1e3, rel=1e-12)
    assert got["bound_by"] == bound_by
    assert got["bound_ms"] == max(got["ops_bound_ms"],
                                  got["bytes_bound_ms"])


def test_k5_f32_bound_matches_hand_count():
    """K5 at Swin-B-384 stage 0, B=64, int8 scores: 8 M C^2 projection
    operations in int8 and 4096 windows x 4 heads x N^2 dh x 2 per
    product; x and out f32 (589,824 x 128 each), the int8 matrices, ten
    C-vectors and the 23^2 x 4 table: bound by the bytes, 0.1803 ms."""
    got = cs.swin_bounds("K5", (64, 128, 4, 96, 12, 6), width=4)
    att = 2 * 4_096 * 4 * 144 ** 2 * 32
    assert got["ops"] == 8 * 589_824 * 128 ** 2 + 2 * att
    nbytes = 2 * 589_824 * 128 * 4 + 128 ** 2 * 4 + 10 * 128 * 4 \
        + 23 ** 2 * 4 * 4
    assert got["bytes_bound_ms"] == pytest.approx(
        nbytes / cs.PEAK_BYTES * 1e3, rel=1e-12)
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(0.1803, abs=1e-4)
