"""f32 serving on the card: the serving kernels K1, K4, K6 and K7 take
f32 activations and matrices (`geovpr_torch/csrc/f32_serving.cu`) as
well as bf16 ones, for models built with compute_dtype="float32".

Here, without a card: the type rules as pure functions (the training
kernels' too: DINOv2's K8 and Swin's K9 take an f32 set as well,
tests/test_torch_f32_training.py and
tests/test_torch_f32_swin_training.py), the f32 models' blocks and boundaries
routed through the kernel wrappers with f32 streams and matrices (on CPU
tensors the wrappers run their plain versions), `cli.parity`'s salad leg
built with its kernels on, and the bound arithmetic of chip_smoke.py's
[f32_serving] phase against counts made by hand. The kernels themselves
are checked on the card (tests/test_torch_cuda.py, `-k f32`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from geovpr_torch.cli import parity
from geovpr_torch.cli.evaluate import build_model
from geovpr_torch.cli.presets import build_preset
from geovpr_torch.models import dinov2, salad, swin
from geovpr_torch.ops.mhsa import (K1_F32_ROWS_MAX_N, k1_dtype_error,
                                   k1_f32_attention_route, k8_dtype_error)
from geovpr_torch.ops.patch_merge import k6_dtype_error
from geovpr_torch.ops.swin_block import k4_dtype_error, k9_dtype_error
from geovpr_torch.ops.window_attention import (k7_dtype_error,
                                               k7_raster_dtype_error)

BF16, F32 = torch.bfloat16, torch.float32

# kernel -> (its rule, the stream and matrices, the f32 vectors and tables)
SERVING_RULES = {
    "K1": (k1_dtype_error, ("x", "wqkv", "wo"),
           ("ln_scale", "ln_bias", "bqkv", "bo", "gamma")),
    "K4": (k4_dtype_error, ("x", "wqkv", "wo"),
           ("ln_scale", "ln_bias", "bqkv", "bo", "table")),
    "K6": (k6_dtype_error, ("x", "w"), ("ln_scale", "ln_bias")),
    "K7": (k7_dtype_error, ("q", "k", "v"), ("bias", "mask")),
    "K7_raster": (k7_raster_dtype_error, ("qkv",), ("table",)),
}


def _dtypes(kernel, stream_dtypes, vector_dtype=F32):
    _, stream, vectors = SERVING_RULES[kernel]
    return {**dict(zip(stream, stream_dtypes)),
            **dict.fromkeys(vectors, vector_dtype)}


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("kernel", sorted(SERVING_RULES))
def test_serving_rules_take_bf16_and_f32(kernel, dtype):
    rule, stream, _ = SERVING_RULES[kernel]
    assert rule(_dtypes(kernel, [dtype] * len(stream))) is None


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("kernel", sorted(SERVING_RULES))
def test_serving_rules_refuse_other_types(kernel, dtype):
    rule, stream, _ = SERVING_RULES[kernel]
    err = rule(_dtypes(kernel, [dtype] * len(stream)))
    assert err and str(dtype) in err


@pytest.mark.parametrize("kernel", sorted(SERVING_RULES))
def test_serving_rules_refuse_mixed_types(kernel):
    """An f32 stream with bf16 matrices (or the other way round), and a
    vector or table in anything but f32."""
    rule, stream, vectors = SERVING_RULES[kernel]
    if len(stream) > 1:
        assert rule(_dtypes(kernel, [F32] + [BF16] * (len(stream) - 1)))
        assert rule(_dtypes(kernel, [BF16] * (len(stream) - 1) + [F32]))
    for dtype in (BF16, torch.float64):
        err = rule(_dtypes(kernel, [F32] * len(stream), dtype))
        assert err and vectors[0] in err


@pytest.mark.parametrize("rule,vectors", [
    (k8_dtype_error, ("ln_scale", "ln_bias", "bqkv", "bo", "gamma")),
    (k9_dtype_error, ("ln_scale", "ln_bias", "bqkv", "bo", "table"))],
    ids=["K8", "K9"])
def test_training_rules_still_refuse_f32(rule, vectors):
    """K8a-K8c and K9a-K9c take an all-bf16 and an all-f32 set (the f32
    forms in `csrc/f32_serving.cu` and `csrc/f32_train.cu`) and refuse a
    mixed one, naming the odd tensor, and a vector off f32."""
    tensors = ("x", "wqkv", "wo", "qkv", "ctx", "g")
    vecs = dict.fromkeys(vectors, F32)
    assert rule({**dict.fromkeys(tensors, BF16), **vecs}) is None
    assert rule({**dict.fromkeys(tensors, F32), **vecs}) is None
    for name in tensors:
        err = rule({**dict.fromkeys(tensors, BF16), **vecs, name: F32})
        assert err and f"{name} is torch.float32" in err
        err = rule({**dict.fromkeys(tensors, F32), **vecs, name: BF16})
        assert err and f"{name} is torch.bfloat16" in err
    for name in vectors:
        err = rule({**dict.fromkeys(tensors, F32), **vecs, name: BF16})
        assert err and name in err


def _recorded(monkeypatch, module, name, mats, calls):
    """Wrap `module.name` so that each call records the wrapper's name and
    the dtypes of its arguments at positions `mats` before running it."""
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((name, tuple(args[i].dtype for i in mats)))
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, rec)


_TINY = {
    "dinov2salad_frozen_mlp": (dinov2.DINOV2_VARIANTS, "base-14", dict(
        hidden_size=64, num_layers=2, num_heads=1), 56),
    "swin_b384_gemini2": (swin.SWIN_VARIANTS, "base-384", dict(
        embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=12,
        image_size=96), 96),
    "swin_t224_sincos_gemini": (swin.SWIN_VARIANTS, "tiny-224", dict(
        embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=7,
        image_size=56), 56),
}


@pytest.mark.parametrize("preset,want", [
    ("dinov2salad_frozen_mlp", {"fused_mhsa_block": 2}),
    ("swin_b384_gemini2", {"fused_swin_attn_block": 4,
                           "fused_patch_merge": 1}),
    ("swin_t224_sincos_gemini", {"window_attention_raster": 4,
                                 "fused_patch_merge": 1})])
def test_f32_models_route_through_the_kernel_wrappers(monkeypatch, preset,
                                                      want):
    """At compute_dtype="float32" (a 2-layer DINOv2 + SALAD, a two-stage
    window-12 Swin, a window-7 Swin), every attention half and boundary
    calls its kernel wrapper with an f32 stream and f32 matrices: no dtype
    test sends f32 to the torch-op route."""
    table, variant, spec, size = _TINY[preset]
    monkeypatch.setitem(table, variant, spec)
    calls = []
    _recorded(monkeypatch, dinov2, "fused_mhsa_block", (0, 3, 5), calls)
    _recorded(monkeypatch, swin, "fused_swin_attn_block", (0, 3, 5), calls)
    _recorded(monkeypatch, swin, "fused_patch_merge", (0, 3), calls)
    _recorded(monkeypatch, swin, "window_attention_raster", (0,), calls)
    cfg = build_preset(preset)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, image_size=size))
    model, _ = build_model(cfg, "cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, size, size, 3)).astype(np.float32))
    with torch.inference_mode():
        out = model(x)
    assert torch.isfinite(out).all()
    got = {}
    for name, dtypes in calls:
        assert all(dt == F32 for dt in dtypes), (name, dtypes)
        got[name] = got.get(name, 0) + 1
    assert got == want


def test_parity_salad_leg_builds_its_model_with_kernels_on(tmp_path,
                                                           monkeypatch):
    """`cli.parity`'s descriptor leg builds DINOv2 + SALAD in f32 with its
    kernels on (K1's f32 form on the card), as JAX's leg runs its kernel in
    f32 on the TPU."""
    monkeypatch.setitem(dinov2.DINOV2_VARIANTS, "base-14",
                        dict(hidden_size=64, num_layers=2, num_heads=1))
    (tmp_path / "salad").mkdir()
    torch.save({}, tmp_path / "salad" / "dino_salad.ckpt")
    np.savez(tmp_path / "salad" / "reference_descriptors.npz",
             images=np.zeros((1, 28, 28, 3), np.uint8),
             descriptors=np.zeros((1, 8448), np.float32))
    built = []

    class Built(Exception):
        pass

    orig = salad.DinoV2Salad

    def record(*args, **kwargs):
        built.append((kwargs, orig(*args, **kwargs)))
        raise Built

    monkeypatch.setattr(salad, "DinoV2Salad", record)
    with pytest.raises(Built):
        parity._run_salad_leg(dict(parity.DEFAULT_LEGS["salad"]),
                              str(tmp_path), 2.0, torch.device("cpu"))
    (kwargs, model), = built
    assert kwargs["dtype"] == F32 and kwargs.get("use_kernels", True)
    flags = [m.use_kernels for m in model.modules()
             if hasattr(m, "use_kernels")]
    assert len(flags) == 2 and all(flags)


def test_f32_peak_is_the_cuda_cores():
    """132 SMs x 128 FFMA lanes x 2 operations x 1,980 MHz."""
    assert cs.f32_peak(1980.0) == 66_908_160_000_000.0


@pytest.mark.parametrize("kind,shape,ops,nbytes,bound_by", [
    # DINOv2-B/14 at B=64: projections 2 M D 4D = 77,611,401,216 and
    # attention 4 B H N^2 dh = 12,985,761,792; x, out, Wqkv, Wo and seven
    # D-vectors in f32
    ("K1", (64, 257, 768, 12), 77_611_401_216 + 12_985_761_792,
     4 * (2 * 16_448 * 768 + 4 * 589_824 + 7 * 768), "operations"),
    # Swin-B-384 stage 0 at B=64: 8 M C^2 = 77,309,411,328 and 4096
    # windows x 4 heads x 4 N^2 dh = 43,486,543,872; the table 23^2 x 4
    ("K4", (64, 128, 4, 96, 12, 6), 77_309_411_328 + 43_486_543_872,
     4 * (2 * 589_824 * 128 + 4 * 16_384 + 6 * 128 + 529 * 4),
     "operations"),
    # the first Swin-B-384 boundary: 147,456 merged rows x 512 x 256 x 2
    ("K6", (64, 128, 96), 38_654_705_664,
     4 * (589_824 * 128 + 147_456 * 256 + 512 * 256 + 8 * 128),
     "operations"),
    # Swin-T-224 stage 0: 4096 windows x 3 heads x 4 x 49^2 x 32; qkv in,
    # ctx out, the table 13^2 x 3
    ("K7", (64, 96, 3, 56, 7, 3), 3_776_446_464,
     4 * (200_704 * 4 * 96 + 169 * 3), "bytes")])
def test_f32_bounds_match_hand_counts(kind, shape, ops, nbytes, bound_by):
    peak = cs.f32_peak(1980.0)
    got = cs.f32_bounds(kind, shape, peak)
    assert got["ops"] == ops and got["bytes"] == nbytes
    assert got["bound_by"] == bound_by
    assert got["bound_ms"] == pytest.approx(
        max(ops / peak, nbytes / cs.PEAK_BYTES) * 1e3, rel=1e-12)
    if kind == "K1":
        assert got["bound_ms"] == pytest.approx(1.354, abs=1e-3)


@pytest.mark.parametrize("n, route", [
    (1, "rows_on_chip"), (257, "rows_on_chip"), (530, "rows_on_chip"),
    (564, "rows_on_chip"), (565, "streamed"), (1370, "streamed")])
def test_k1_f32_attention_route_is_a_rule_of_shape(n, route):
    """K1.f32's (and K8a.f32's) attention launch keeps a 32-row query
    tile's score rows on chip up to K1_F32_ROWS_MAX_N tokens and takes the
    streamed kernel past it; DINOv2's N = 257 (224 px, every preset) keeps
    its rows on chip."""
    assert k1_f32_attention_route(n) == route
    with pytest.raises(ValueError):
        k1_f32_attention_route(0)


def test_k1_f32_rows_limit_is_two_ctas_an_sm():
    """The limit as `csrc/f32_serving.cu` derives it (FV_MAX_N): a CTA's
    16 bytes of barriers, 32 q rows of 64 floats, two ring stages of 64 key
    rows at 68 floats, and 32 score rows of N rounded up to 4 floats,
    within 115,712 bytes, two such CTAs in an SM's 228 KB (1 KB reserved a
    CTA); at DINOv2's N = 257 three fit. The card tests hold the library's
    `geovpr_mhsa_f32_rows_max_n` to the same number."""
    fixed = 16 + 4 * (32 * 64 + 2 * 64 * 68)

    def smem(n):
        return fixed + 4 * 32 * ((n + 3) // 4 * 4)

    assert 2 * (smem(K1_F32_ROWS_MAX_N) + 1024) <= 228 * 1024
    assert 2 * (smem(K1_F32_ROWS_MAX_N + 4) + 1024) > 228 * 1024
    assert K1_F32_ROWS_MAX_N % 4 == 0
    assert 3 * (smem(257) + 1024) <= 228 * 1024

