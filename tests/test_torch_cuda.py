"""Tests of the port's CUDA kernels; they need the card and skip without it.

This file imports no jax, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from chip_smoke import (F32_BRANCH_REL, f32, f32_branch_error, f32_k1_case,
                        int8_block_case, int8_errors, int8_within_bound,
                        k1_within_bound, k4_args, k5_kwargs, k7_case,
                        k7_raster_case, merge_case, ratio_errors,
                        swin_block_case)
from geovpr_torch.ops.mhsa import (fused_mhsa_block, fused_mhsa_block_int8,
                                   mhsa_block_int8_reference,
                                   mhsa_block_reference)
from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                       mlp_block_int8_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(b, n, d, h, device, seed=0, x_scale=1e-2):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    return [r(b, n, d, scale=x_scale).bfloat16(), r(d, scale=0.1) + 1,
            r(d, scale=0.1), r(d, 3 * d, scale=d ** -0.5).bfloat16(),
            r(3 * d, scale=0.1), r(d, d, scale=d ** -0.5).bfloat16(),
            r(d, scale=0.1), r(d, scale=0.5), h]


@pytest.mark.parametrize("shape", [(3, 50, 384, 6), (2, 17, 64, 1),
                                   (1, 1, 768, 12), (2, 300, 768, 12)])
def test_kernel_matches_plain_version(cuda, shape):
    """Bound as in chip_smoke.py: x at scale 1e-2, so the output is mostly
    the attention branch (LayerNorm removes the scale); the kernel's max and
    mean |error| against the f32 plain version may exceed the bf16 plain
    version's by 1.25x and 1.1x."""
    args = _args(*shape, cuda)
    f32 = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.inference_mode():
        ref = mhsa_block_reference(*f32)
        plain = mhsa_block_reference(*args)
        before = fused_mhsa_block.launches
        got = fused_mhsa_block(*args)
        torch.cuda.synchronize()
    assert fused_mhsa_block.launches == before + 1
    k_err = (got.float() - ref).abs()
    p_err = (plain.float() - ref).abs()
    assert k_err.max() <= 1.25 * p_err.max()
    assert k_err.mean() <= 1.1 * p_err.mean()


@pytest.mark.parametrize("shape", [
    (3, 50, 384, 6), (3, 50, 768, 12), (3, 50, 1024, 16),
    (2, 257, 384, 6), (2, 257, 1024, 16), (1, 1370, 384, 6),
    (1, 1370, 1024, 16)])
def test_k1_matches_plain_version_at_its_edges(cuda, shape):
    """K1's LayerNorm, TMA + wgmma GEMMs and attention at D = 384 / 768 /
    1024 (the GEMMs' 64- and 128-wide column tiles, 6 to 24 k tiles of the
    ring), N = 50, 257 and 1370 (one key tile to 22, a part-filled last
    one) and M = 150 (a ragged last row tile): chip_smoke's ratio bound."""
    from chip_smoke import k1_errors
    e = k1_errors(*shape, cuda)
    assert k1_within_bound(e), e


def test_k1_launches_one_by_one_equal_the_whole(cuda):
    """The four launches run alone (`k1_launch_part`, which chip_smoke.py
    times) leave the outputs of one whole call, bit for bit, and count no
    launch."""
    from geovpr_torch.ops import mhsa as mh
    args = _args(2, 257, 768, 12, cuda)
    with torch.inference_mode():
        out, qkv, ctx = mh.fused_mhsa_train_fwd(*args)
        got = mh._check(*args)
        bufs = (torch.empty_like(qkv), torch.empty_like(ctx),
                torch.empty_like(out))
        before = (mh.fused_mhsa_block.launches,
                  mh.fused_mhsa_train_fwd.launches)
        for part in range(len(mh.K1_PARTS)):
            mh.k1_launch_part(part, args[0], got, 12, 1e-6, bufs)
        torch.cuda.synchronize()
    assert (mh.fused_mhsa_block.launches,
            mh.fused_mhsa_train_fwd.launches) == before
    for a, b in zip(bufs, (qkv, ctx, out)):
        assert torch.equal(a, b)


def test_kernel_refuses_a_gradient(cuda):
    args = _args(1, 5, 64, 1, cuda)
    args[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="backward"):
        fused_mhsa_block(*args)


def test_kernel_refuses_misaligned_tensors(cuda):
    """K1 reads by TMA and 16-byte loads: a contiguous x that starts 2
    bytes into its storage is refused before any launch."""
    args = _args(1, 5, 64, 1, cuda)
    buf = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                      device=cuda)
    args[0] = buf[1:].view_as(args[0]).copy_(args[0])
    with torch.inference_mode(), pytest.raises(ValueError, match="aligned"):
        fused_mhsa_block(*args)


def _f32_within_bound(kernel, plain, args, x=None):
    """The f32 forms' check (chip_smoke.py's [f32_serving]): one launch,
    and the branch's relative error against the plain f32 version (TF32
    off) within F32_BRANCH_REL."""
    with torch.inference_mode():
        before = kernel.launches
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
    assert kernel.launches == before + 1
    assert got.dtype == torch.float32
    e = f32_branch_error(got, want, x)
    assert e["finite"] and e["branch_rel_err"] <= F32_BRANCH_REL, e


def test_kernel_refuses_float32_activations(cuda):
    """K1 refuses f32 activations with bf16 matrices, and f16; with f32
    activations and matrices it runs its f32 form (`csrc/f32_serving.cu`),
    within the f32 bound of its plain version."""
    args = _args(1, 5, 64, 1, cuda)
    args[0] = args[0].float()
    with torch.inference_mode(), pytest.raises(TypeError):
        fused_mhsa_block(*args)
    half = [a.half() if i in (0, 3, 5) else a for i, a in enumerate(args)]
    with torch.inference_mode(), pytest.raises(TypeError):
        fused_mhsa_block(*half)
    args = f32_k1_case((2, 65, 128, 2), cuda)
    _f32_within_bound(fused_mhsa_block, mhsa_block_reference, args, args[0])


@pytest.mark.parametrize("shape", [(64, 257, 768, 12), (3, 50, 384, 6),
                                   (2, 17, 64, 1), (2, 1370, 768, 12),
                                   (1, 257, 1024, 16), (1, 564, 128, 2),
                                   (1, 565, 128, 2)])
def test_k1_f32_matches_plain_version(cuda, shape):
    """K1's f32 form at DINOv2-B/14's shape (a one-query tail tile, N =
    257 = 8 x 32 + 1, and one key past the last whole 32), N below one key
    tile, many key tiles (the streamed route), D = 1024, and N on each side
    of the attention's route limit (`k1_f32_attention_route`: 564 keeps
    its score rows on chip, 565 streams); each through the route the rule
    names (`K1_F32_ROUTE_LAUNCHES`)."""
    from geovpr_torch.ops import mhsa as mh
    args = f32_k1_case(shape, cuda)
    route = mh.k1_f32_attention_route(shape[1])
    before = mh.K1_F32_ROUTE_LAUNCHES[route]
    _f32_within_bound(fused_mhsa_block, mhsa_block_reference, args, args[0])
    assert mh.K1_F32_ROUTE_LAUNCHES[route] == before + 1


def test_k1_f32_route_limit_matches_the_library(cuda):
    """The route rule's limit is the library's (FV_MAX_N)."""
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops._build import load_library
    assert load_library().geovpr_mhsa_f32_rows_max_n() == \
        mh.K1_F32_ROWS_MAX_N


def test_f32_launches_one_by_one_equal_the_whole(cuda):
    """K1's, K4's and K6's f32 launches run one by one on their buffers
    give the whole call's output bit for bit."""
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops import patch_merge as pm
    from geovpr_torch.ops import swin_block as sb
    args = f32_k1_case((2, 65, 128, 2), cuda)
    x, h = args[0], args[-1]
    got = mh._check(*args)
    bufs = (x.new_empty(2, 65, 384), x.new_empty(2, 65, 128),
            x.new_empty(2, 65, 128))
    with torch.inference_mode():
        whole = fused_mhsa_block(*args)
        for i in range(len(mh.K1_PARTS)):
            mh.k1_launch_part(i, x, got, h, 1e-6, bufs)
        torch.cuda.synchronize()
    assert torch.equal(bufs[2], whole)
    x, blk = swin_block_case((2, 64, 2, 24, 12, 6), cuda,
                             dtype=torch.float32)
    a = k4_args(x, blk)
    bufs = (x.new_empty(2 * 576, 192), x.new_empty(2 * 576, 64),
            torch.empty_like(x))
    with torch.inference_mode():
        whole = sb.fused_swin_attn_block(*a)
        for i in range(len(sb.K4_PARTS)):
            sb.k4_launch_part(i, *a, bufs=bufs)
        torch.cuda.synchronize()
    assert torch.equal(bufs[2], whole)
    a = merge_case((2, 96, 14), cuda, dtype=torch.float32)
    bufs = (a[0].new_empty(2, 49, 384), a[0].new_empty(2, 49, 192))
    with torch.inference_mode():
        whole = pm.fused_patch_merge(*a)
        for i in range(len(pm.K6_PARTS)):
            pm.k6_launch_part(i, *a, bufs=bufs)
        torch.cuda.synchronize()
    assert torch.equal(bufs[1], whole)


def test_f32_models_launch_per_block(cuda):
    """A two-stage window-12 Swin, a window-7 Swin and a two-layer DINOv2
    built in f32 go through the f32 kernels: one K4 or K7 a block, one K6
    a boundary, one K1 a layer."""
    from geovpr_torch.models.dinov2 import DinoV2
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.swin import SwinTransformer
    from geovpr_torch.ops.patch_merge import fused_patch_merge
    from geovpr_torch.ops.swin_block import fused_swin_attn_block
    from geovpr_torch.ops.window_attention import window_attention_raster
    fns = (fused_swin_attn_block, window_attention_raster, fused_patch_merge,
           fused_mhsa_block)
    g = torch.Generator().manual_seed(0)
    for model, size, want in (
            (SwinTransformer(embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                             window_size=12, image_size=96,
                             dtype=torch.float32), 96, [4, 0, 1, 0]),
            (SwinTransformer(embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                             window_size=7, image_size=56,
                             dtype=torch.float32), 56, [0, 4, 1, 0]),
            (DinoV2(hidden_size=128, num_layers=2, num_heads=2,
                    image_size=56, dtype=torch.float32), 56, [0, 0, 0, 2])):
        init_weights_(model, g)
        model = model.to(cuda).eval()
        x = torch.randn(2, size, size, 3, generator=g).to(cuda)
        before = [f.launches for f in fns]
        with torch.inference_mode():
            out = model(x)
            torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(fns, before)] == want
        assert torch.isfinite(out.pooled).all()


def test_model_launches_once_per_layer(cuda):
    from geovpr_torch.models.dinov2 import DinoV2
    from geovpr_torch.models.layers import init_weights_

    model = DinoV2(hidden_size=128, num_layers=2, num_heads=2, image_size=28,
                   dtype=torch.bfloat16)
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    x = torch.randn(3, 28, 28, 3, device=cuda)
    with torch.inference_mode():
        before = fused_mhsa_block.launches
        out = model(x)
        torch.cuda.synchronize()
    assert fused_mhsa_block.launches == before + 2
    assert torch.isfinite(out.tokens.float()).all()


_INT8_SHAPES = [(3, 50, 384, 6), (2, 17, 64, 1), (1, 1, 768, 12),
                (2, 300, 768, 12)]


@pytest.mark.parametrize("shape", _INT8_SHAPES)
def test_k2_matches_plain_version(cuda, shape):
    """Bound as in chip_smoke.py: at most 1% of the elements off by more
    than 1e-3, and max |error| <= 1.5 x the largest dequant step + 1e-3 +
    two bf16 spacings at the largest output."""
    b, n, d, h = shape
    x, k2, _ = int8_block_case(b, n, d, h, cuda)
    with torch.inference_mode():
        before = fused_mhsa_block_int8.launches
        got = fused_mhsa_block_int8(x, **k2, num_heads=h)
        torch.cuda.synchronize()
        want = mhsa_block_int8_reference(x, **k2, num_heads=h)
    assert fused_mhsa_block_int8.launches == before + 1
    e = int8_errors(got, want, (k2["so_eff"] * k2["gamma"]).abs().max()
                    .item())
    assert int8_within_bound(e), e


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", _INT8_SHAPES)
def test_k3_matches_plain_version(cuda, shape, residual):
    b, n, d, h = shape
    x, _, k3 = int8_block_case(b, n, d, h, cuda)
    kw = {"residual": torch.randn_like(x)} if residual else {}
    with torch.inference_mode():
        before = fused_mlp_block_int8.launches
        got = fused_mlp_block_int8(x, **k3, **kw)
        torch.cuda.synchronize()
        want = mlp_block_int8_reference(x, **k3, **kw)
    assert fused_mlp_block_int8.launches == before + 1
    e = int8_errors(got, want, (k3["s2_eff"] * k3["gamma"]).abs().max()
                    .item())
    assert int8_within_bound(e), e


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    x, k2, k3 = int8_block_case(1, 5, 64, 1, cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="cpl"):
            fused_mhsa_block_int8(x, **{**k2, "cpv": 1.0}, num_heads=1)
        with pytest.raises(TypeError):       # f16: neither form's
            fused_mhsa_block_int8(x.half(), **k2, num_heads=1)
        with pytest.raises(TypeError):
            fused_mlp_block_int8(x.half(), **k3)
        with pytest.raises(TypeError):
            fused_mlp_block_int8(x, **{**k3, "w1q_t": k3["w1q_t"].float()})
        with pytest.raises(ValueError, match="multiples of 16"):
            fused_mlp_block_int8(x[..., :40].contiguous(), **{
                **k3, **{k: k3[k][:40].contiguous() for k in (
                    "ln_scale_q", "ln_bias_q", "s2_eff", "b2", "gamma")},
                "w1q_t": k3["w1q_t"][:, :40].contiguous(),
                "w2q_t": k3["w2q_t"][:40].contiguous()})
    gamma = k3["gamma"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="backward"):
        fused_mlp_block_int8(x, **{**k3, "gamma": gamma})


def test_int8_model_launches_once_per_layer(cuda):
    from geovpr_torch.models.dinov2 import DinoV2
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving

    model = DinoV2(hidden_size=128, num_layers=2, num_heads=2, image_size=28,
                   dtype=torch.bfloat16, int8_attn=True, int8_mlp=True)
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    x = torch.randn(3, 28, 28, 3, device=cuda)
    quantize_for_serving(model, [x])
    with torch.inference_mode():
        before = (fused_mhsa_block_int8.launches,
                  fused_mlp_block_int8.launches)
        out = model(x)
        torch.cuda.synchronize()
    assert (fused_mhsa_block_int8.launches,
            fused_mlp_block_int8.launches) == (before[0] + 2, before[1] + 2)
    assert torch.isfinite(out.tokens.float()).all()


def _qkv_launch_close(mode, qk, v, qk_p, v_p):
    """The QKV launch's outputs against its plain part in `mode`: int8
    within one step in at most 1% of the elements, bf16 within one
    spacing."""
    if mode == "bf16_scores":
        return _bf16_close(qk, qk_p) and v.numel() == 0
    return _int8_flips(qk, qk_p) and _bf16_close(v, v_p)


def _k2_launch_checks(x, k2, h):
    """K2's four launches alone (`k2_launch_part`), in the attention mode
    of the fold `k2`, each fed the plain parts' output of the launch before
    it, against its plain part: int8 within one step in at most 1% of the
    elements, bf16 within one spacing (as K5's launches are held), the f32
    stream's output as `_out_close` holds it."""
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops.quant import (attn_mode, int8_resid_reference,
                                        ln_quant_reference,
                                        qkv_part_reference)
    b, n, d = x.shape
    mode = attn_mode(k2["cs"], k2["cpv"])
    qk, v, ctx8, out = bufs = mh.k2_buffers(x, mode)
    xq = ln_quant_reference(x, k2["ln_scale_q"], k2["ln_bias_q"], 1e-6)
    mh.k2_launch_part(0, x, **k2, num_heads=h, bufs=bufs)
    torch.cuda.synchronize()
    assert _int8_flips(ctx8, xq)
    ctx8.copy_(xq)
    mh.k2_launch_part(1, x, **k2, num_heads=h, bufs=bufs)
    torch.cuda.synchronize()
    qk_p, v_p = qkv_part_reference(xq, k2["wqkv_q_t"], k2["sqkv_eff"],
                                   k2["bqkv_eff"], mode,
                                   (d // h) ** -0.5 * mh.LOG2E)
    assert _qkv_launch_close(mode, qk, v, qk_p, v_p)
    qk.copy_(qk_p)
    v.copy_(v_p)
    mh.k2_launch_part(2, x, **k2, num_heads=h, bufs=bufs)
    torch.cuda.synchronize()
    ctx_p = mh.vit_attention8_reference(qk_p, v_p, h, n, k2["cs"],
                                        k2["cpv"], k2["cpl"])
    assert _int8_flips(ctx8, ctx_p)
    assert ctx_p.abs().max() > 16
    ctx8.copy_(ctx_p)
    mh.k2_launch_part(3, x, **k2, num_heads=h, bufs=bufs)
    torch.cuda.synchronize()
    want = int8_resid_reference(ctx_p, k2["wo_q_t"], k2["so_eff"], k2["bo"],
                                x.reshape(b * n, d), gamma=k2["gamma"])
    assert _out_close(out.reshape(b * n, d), want, x.reshape(b * n, d))


@pytest.mark.parametrize("shape", [(2, 257, 768, 12), (3, 50, 384, 6),
                                   (2, 17, 64, 1), (1, 1370, 1024, 16)])
def test_k2_launches_match_their_plain_parts(cuda, shape):
    """At DINOv2-B/14's N = 257 (a one-key last tile), small-14's width,
    one head with a 17-token tail and large-14's width at N = 1370."""
    b, n, d, h = shape
    x, k2, _ = int8_block_case(b, n, d, h, cuda)
    with torch.inference_mode():
        _k2_launch_checks(x, k2, h)


def test_k2_launches_one_by_one_equal_the_whole(cuda):
    """K2's four launches run alone (`k2_launch_part`, which chip_smoke.py
    times) leave one whole call's output, bit for bit, and count no
    launch."""
    from geovpr_torch.ops import mhsa as mh
    x, k2, _ = int8_block_case(2, 257, 768, 12, cuda)
    with torch.inference_mode():
        out = mh.fused_mhsa_block_int8(x, **k2, num_heads=12)
        bufs = mh.k2_buffers(x)
        before = mh.fused_mhsa_block_int8.launches
        for part in range(len(mh.K2_PARTS)):
            mh.k2_launch_part(part, x, **k2, num_heads=12, bufs=bufs)
        torch.cuda.synchronize()
    assert mh.fused_mhsa_block_int8.launches == before
    assert torch.equal(bufs[3], out)


def test_k2_refuses_what_its_rule_refuses(cuda):
    """Head dim 32 (two heads at D = 64): `k2_shape_error`'s words, before
    any launch."""
    x, k2, _ = int8_block_case(1, 5, 64, 1, cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="head dim"):
        fused_mhsa_block_int8(x, **k2, num_heads=2)


_SWIN_SHAPES = [(2, 128, 4, 24, 12, 6), (2, 64, 2, 8, 4, 2),
                (1, 1024, 32, 12, 12, 0), (3, 256, 8, 24, 12, 0)]
# K4 also at Swin-B-384 stage 0's geometry (S = 96: 8 x 8 windows, the
# last row and column wrapped by the shift), at odd H (a head pair with one
# head; 3C = 288 and K = 96, column and k tails of the GEMMs) and at
# windows 8 and 16
_K4_SHAPES = _SWIN_SHAPES + [(2, 128, 4, 96, 12, 6), (1, 96, 3, 24, 12, 6),
                             (2, 64, 2, 16, 8, 4), (1, 128, 4, 32, 16, 8)]


@pytest.mark.parametrize("shape", _K4_SHAPES)
def test_k4_matches_plain_version(cuda, shape):
    """K1's bound (x at 1e-2; max and mean |error| against the f32 plain
    version within 1.25x and 1.1x the bf16 plain version's)."""
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                             swin_attn_block_reference)
    x, blk = swin_block_case(shape, cuda, x_scale=1e-2)
    args = k4_args(x, blk)
    before = fused_swin_attn_block.launches
    e = ratio_errors(fused_swin_attn_block, swin_attn_block_reference, args,
                     f32(args))
    assert fused_swin_attn_block.launches == before + 1
    assert k1_within_bound(e), e


@pytest.mark.parametrize("shape", [(2, 128, 4, 24, 12, 6),
                                   (2, 128, 4, 96, 12, 6)])
def test_k4_launches_one_by_one_equal_the_whole(cuda, shape):
    """K4's four launches run alone (`k4_launch_part`, which chip_smoke.py
    times) leave one whole call's output, bit for bit, and count no
    launch; both shapes have shifted windows that wrap at S - shift."""
    from geovpr_torch.ops import swin_block as sb
    x, blk = swin_block_case(shape, cuda, x_scale=1e-2)
    args = k4_args(x, blk)
    b, c, _, res, _, _ = shape
    with torch.inference_mode():
        out = sb.fused_swin_attn_block(*args)
        bufs = (torch.empty((b * res * res, 3 * c), dtype=x.dtype,
                            device=cuda),
                torch.empty((b * res * res, c), dtype=x.dtype, device=cuda),
                torch.empty_like(x))
        before = sb.fused_swin_attn_block.launches
        for part in range(len(sb.K4_PARTS)):
            sb.k4_launch_part(part, *args, bufs=bufs)
        torch.cuda.synchronize()
    assert sb.fused_swin_attn_block.launches == before
    assert torch.equal(bufs[2], out)


@pytest.mark.parametrize("shape", [(2, 96, 14), (1, 512, 24)])
def test_k6_launches_one_by_one_equal_the_whole(cuda, shape):
    """K6's two launches run alone (`k6_launch_part`) leave one whole
    call's output, bit for bit, and count no launch: at C = 96 (2C = 192,
    a partial 128-column tile, 64-wide tiles) and C = 512 (K = 2048)."""
    from geovpr_torch.ops import patch_merge as pm
    args = merge_case(shape, cuda)
    b, c, res = shape
    with torch.inference_mode():
        out = pm.fused_patch_merge(*args)
        bufs = (torch.empty((b, res * res // 4, 4 * c), dtype=torch.bfloat16,
                            device=cuda), torch.empty_like(out))
        before = pm.fused_patch_merge.launches
        for part in range(len(pm.K6_PARTS)):
            pm.k6_launch_part(part, *args, bufs=bufs)
        torch.cuda.synchronize()
    assert pm.fused_patch_merge.launches == before
    assert torch.equal(bufs[1], out)


# K5 also at Swin-B-384 stage 0's geometry (S = 96: the last window row
# and column wrapped by the shift) and at windows 8 and 16
_K5_SHAPES = _SWIN_SHAPES + [(2, 128, 4, 96, 12, 6), (2, 64, 2, 16, 8, 4),
                             (1, 128, 4, 32, 16, 8)]


@pytest.mark.parametrize("shape", _K5_SHAPES)
def test_k5_matches_plain_version(cuda, shape):
    """K2's bound (share of elements off by more than 1e-3 at most 1%, max
    |error| within 1.5 x the largest dequant step + 1e-3 + two bf16
    spacings)."""
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block_int8,
                                             swin_attn_block_int8_reference)
    x, blk = swin_block_case(shape, cuda, int8=True)
    kw = k5_kwargs(blk)
    with torch.inference_mode():
        before = fused_swin_attn_block_int8.launches
        got = fused_swin_attn_block_int8(x, **kw)
        torch.cuda.synchronize()
        want = swin_attn_block_int8_reference(x, **kw)
    assert fused_swin_attn_block_int8.launches == before + 1
    e = int8_errors(got, want, kw["so_eff"].abs().max().item())
    assert int8_within_bound(e), e


def _int8_flips(got, want, share=0.01):
    """An int8 launch against its plain part: f32 sums ordered otherwise
    (LayerNorm) or fused multiply-adds move a value across a rounding
    boundary at most one step, in at most `share` of the elements."""
    d = (got.int() - want.int()).abs()
    return d.max().item() <= 1 and (d > 0).float().mean().item() <= share


def _bf16_close(got, want):
    """A bf16 launch against its plain part: within one bf16 spacing (the
    epilogue's fused multiply-add rounds once where torch rounds twice)."""
    from chip_smoke import bf16_spacing
    err = (got.float() - want.float()).abs()
    return bool((err <= bf16_spacing(want.float()) + 1e-6).all())


def _out_close(got, want, res):
    """The out projection's launch against its plain part: a bf16 output
    within one spacing (`_bf16_close`), an f32 one (the f32 stream's form)
    with the branch (out - res) within F32_BRANCH_REL in the 2-norm."""
    if got.dtype == torch.bfloat16:
        return _bf16_close(got, want)
    e = f32_branch_error(got, want, res)
    return e["finite"] and e["branch_rel_err"] <= F32_BRANCH_REL


def _k5_launch_checks(x, kw):
    """Each of K5's four launches alone (`k5_launch_part`), in the
    attention mode of the fold `kw`, fed the plain parts' output of the
    launch before it, against its plain part (tests/test_torch_int8_hopper.py
    composes the parts to the whole plain version): LN-quant and the QKV
    GEMM's int8 columns within one int8 step in at most 1% of the elements,
    its bf16 columns within one bf16 spacing, the attention's int8 context
    within one step in at most 1%, the out projection within one bf16
    spacing (`_out_close`: the f32 stream's within F32_BRANCH_REL)."""
    from geovpr_torch.ops import swin_block as sb
    from geovpr_torch.ops.quant import (attn_mode, int8_resid_reference,
                                        ln_quant_reference,
                                        qkv_part_reference)
    m, c = x.shape[0] * x.shape[1], x.shape[-1]
    mode = attn_mode(kw["cs"], kw["cpv"])
    qk, v, ctx8, out = bufs = sb.k5_buffers(x, mode)
    xq = ln_quant_reference(x, kw["ln_scale_q"], kw["ln_bias_q"], 1e-5)
    sb.k5_launch_part(0, x, **kw, bufs=bufs)
    torch.cuda.synchronize()
    assert _int8_flips(ctx8, xq)
    ctx8.copy_(xq)
    sb.k5_launch_part(1, x, **kw, bufs=bufs)
    torch.cuda.synchronize()
    qk_p, v_p = qkv_part_reference(xq, kw["wqkv_q_t"], kw["sqkv_eff"],
                                   kw["bqkv_eff"], mode,
                                   (c // kw["num_heads"]) ** -0.5 * sb.LOG2E)
    assert _qkv_launch_close(mode, qk, v, qk_p, v_p)
    qk.copy_(qk_p)
    v.copy_(v_p)
    sb.k5_launch_part(2, x, **kw, bufs=bufs)
    torch.cuda.synchronize()
    ctx_p = sb.swin_attention8_reference(
        qk_p, v_p, kw["table"], kw["num_heads"], kw["resolution"],
        kw["window"], kw["shift"], kw["cs"], kw["cpv"])
    assert _int8_flips(ctx8, ctx_p)
    assert ctx_p.abs().max() > 16
    ctx8.copy_(ctx_p)
    sb.k5_launch_part(3, x, **kw, bufs=bufs)
    torch.cuda.synchronize()
    want = int8_resid_reference(ctx_p, kw["wo_q_t"], kw["so_eff"],
                                kw["bo"], x.reshape(m, c))
    assert _out_close(out.reshape(m, c), want, x.reshape(m, c))


_K5_PART_SHAPES = [(2, 128, 4, 24, 12, 6), (2, 128, 4, 96, 12, 6),
                   (1, 1024, 32, 12, 12, 0), (2, 64, 2, 16, 8, 4)]


@pytest.mark.parametrize("shape", _K5_PART_SHAPES)
def test_k5_launches_match_their_plain_parts(cuda, shape):
    """`_k5_launch_checks` in the default mode."""
    x, blk = swin_block_case(shape, cuda, int8=True)
    with torch.inference_mode():
        _k5_launch_checks(x, k5_kwargs(blk))


@pytest.mark.parametrize("shape", [(2, 128, 4, 24, 12, 6),
                                   (2, 128, 4, 96, 12, 6)])
def test_k5_launches_one_by_one_equal_the_whole(cuda, shape):
    """K5's four launches run alone (`k5_launch_part`, which chip_smoke.py
    times) leave one whole call's output, bit for bit, and count no
    launch; both shapes have shifted windows that wrap at S - shift."""
    from geovpr_torch.ops import swin_block as sb
    x, blk = swin_block_case(shape, cuda, int8=True)
    kw = k5_kwargs(blk)
    with torch.inference_mode():
        out = sb.fused_swin_attn_block_int8(x, **kw)
        bufs = sb.k5_buffers(x)
        before = sb.fused_swin_attn_block_int8.launches
        for part in range(len(sb.K5_PARTS)):
            sb.k5_launch_part(part, x, **kw, bufs=bufs)
        torch.cuda.synchronize()
    assert sb.fused_swin_attn_block_int8.launches == before
    assert torch.equal(bufs[3], out)


# ------------------------------------------------ the other two modes ----

_OTHER_MODES = {"int8_pv": (True, True), "bf16_scores": (False, False)}


@pytest.fixture(params=sorted(_OTHER_MODES))
def int8_mode(request, monkeypatch):
    """int8 P.V or bf16 scores: the mode flags the int8 folds read
    (`geovpr_torch.ops.quant.INT8_QK_SCORES`, `INT8_PV`), set for the
    test; the blocks it builds fold in that mode."""
    from geovpr_torch.ops import quant
    qk, pv = _OTHER_MODES[request.param]
    monkeypatch.setattr(quant, "INT8_QK_SCORES", qk)
    monkeypatch.setattr(quant, "INT8_PV", pv)
    return request.param


@pytest.mark.parametrize("shape", _INT8_SHAPES)
def test_k2_matches_plain_version_in_mode(cuda, int8_mode, shape):
    """`test_k2_matches_plain_version` in int8 P.V and bf16 scores."""
    b, n, d, h = shape
    x, k2, _ = int8_block_case(b, n, d, h, cuda)
    assert (k2["cs"] is None) == (int8_mode == "bf16_scores")
    assert (k2["cpv"] is None) == (int8_mode != "int8_pv")
    with torch.inference_mode():
        before = fused_mhsa_block_int8.launches
        got = fused_mhsa_block_int8(x, **k2, num_heads=h)
        torch.cuda.synchronize()
        want = mhsa_block_int8_reference(x, **k2, num_heads=h)
    assert fused_mhsa_block_int8.launches == before + 1
    e = int8_errors(got, want, (k2["so_eff"] * k2["gamma"]).abs().max()
                    .item())
    assert int8_within_bound(e), e


@pytest.mark.parametrize("shape", [(2, 257, 768, 12), (2, 17, 64, 1),
                                   (1, 1370, 1024, 16)])
def test_k2_launches_match_their_plain_parts_in_mode(cuda, int8_mode, shape):
    """`_k2_launch_checks` in int8 P.V (the last key split off: one key of
    a 64-key tile at N = 257 and 17) and bf16 scores."""
    b, n, d, h = shape
    x, k2, _ = int8_block_case(b, n, d, h, cuda)
    with torch.inference_mode():
        _k2_launch_checks(x, k2, h)


def test_k2_launches_one_by_one_equal_the_whole_in_mode(cuda, int8_mode):
    from geovpr_torch.ops import mhsa as mh
    x, k2, _ = int8_block_case(2, 257, 768, 12, cuda)
    with torch.inference_mode():
        out = mh.fused_mhsa_block_int8(x, **k2, num_heads=12)
        bufs = mh.k2_buffers(x, int8_mode)
        for part in range(len(mh.K2_PARTS)):
            mh.k2_launch_part(part, x, **k2, num_heads=12, bufs=bufs)
        torch.cuda.synchronize()
    assert torch.equal(bufs[3], out)


@pytest.mark.parametrize("shape", _K5_SHAPES)
def test_k5_matches_plain_version_in_mode(cuda, int8_mode, shape):
    """`test_k5_matches_plain_version` in int8 P.V and bf16 scores."""
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block_int8,
                                             swin_attn_block_int8_reference)
    x, blk = swin_block_case(shape, cuda, int8=True)
    kw = k5_kwargs(blk)
    assert (kw["cs"] is None) == (int8_mode == "bf16_scores")
    assert (kw["cpv"] is None) == (int8_mode != "int8_pv")
    with torch.inference_mode():
        before = fused_swin_attn_block_int8.launches
        got = fused_swin_attn_block_int8(x, **kw)
        torch.cuda.synchronize()
        want = swin_attn_block_int8_reference(x, **kw)
    assert fused_swin_attn_block_int8.launches == before + 1
    e = int8_errors(got, want, kw["so_eff"].abs().max().item())
    assert int8_within_bound(e), e


@pytest.mark.parametrize("shape", _K5_PART_SHAPES)
def test_k5_launches_match_their_plain_parts_in_mode(cuda, int8_mode, shape):
    """`_k5_launch_checks` in int8 P.V and bf16 scores."""
    x, blk = swin_block_case(shape, cuda, int8=True)
    with torch.inference_mode():
        _k5_launch_checks(x, k5_kwargs(blk))


def test_k5_launches_one_by_one_equal_the_whole_in_mode(cuda, int8_mode):
    from geovpr_torch.ops import swin_block as sb
    x, blk = swin_block_case((2, 128, 4, 24, 12, 6), cuda, int8=True)
    kw = k5_kwargs(blk)
    with torch.inference_mode():
        out = sb.fused_swin_attn_block_int8(x, **kw)
        bufs = sb.k5_buffers(x, int8_mode)
        for part in range(len(sb.K5_PARTS)):
            sb.k5_launch_part(part, x, **kw, bufs=bufs)
        torch.cuda.synchronize()
    assert torch.equal(bufs[3], out)


# K3 at the Swin-B-384 stage widths (rows of a small batch, D = C, hidden
# 4C) and at D = 96, hidden 384 (Swin-T's width)
_K3_SWIN_SHAPES = [(2, 128, 4, 24, 12, 6), (1, 256, 8, 24, 12, 0),
                   (2, 512, 16, 24, 12, 6), (1, 1024, 32, 12, 12, 0)]


@pytest.mark.parametrize("shape", _K3_SWIN_SHAPES)
def test_k3_matches_plain_version_at_swin_widths(cuda, shape):
    from geovpr_torch.ops.mlp_int8 import (fused_mlp_block_int8,
                                           mlp_block_int8_reference)
    x, blk = swin_block_case(shape, cuda, int8=True)
    k3 = blk._folded_args(blk._k3)
    with torch.inference_mode():
        before = fused_mlp_block_int8.launches
        got = fused_mlp_block_int8(x, **k3, ln_eps=1e-5)
        torch.cuda.synchronize()
        want = mlp_block_int8_reference(x, **k3, ln_eps=1e-5)
    assert fused_mlp_block_int8.launches == before + 1
    e = int8_errors(got, want, (k3["s2_eff"] * k3["gamma"]).abs().max()
                    .item())
    assert int8_within_bound(e), e


def test_k3_matches_plain_version_at_d96(cuda):
    x, _, k3 = int8_block_case(2, 33, 96, 1, cuda)
    with torch.inference_mode():
        got = fused_mlp_block_int8(x, **k3)
        torch.cuda.synchronize()
        want = mlp_block_int8_reference(x, **k3)
    e = int8_errors(got, want, (k3["s2_eff"] * k3["gamma"]).abs().max()
                    .item())
    assert int8_within_bound(e), e


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(2, 257, 768, 12), (2, 300, 1024, 16)])
def test_k3_launches_match_their_plain_parts(cuda, shape, residual):
    """Each of K3's three launches alone (`k3_launch_part`), fed the plain
    parts' output of the launch before it, against its plain part:
    LN-quant and fc1's int8 hidden within one int8 step in at most 1% of
    the elements, fc2 within one bf16 spacing."""
    from geovpr_torch.ops import mlp_int8 as mi
    from geovpr_torch.ops.quant import int8_resid_reference, ln_quant_reference
    b, n, d, h = shape
    x, _, k3 = int8_block_case(b, n, d, h, cuda)
    res = torch.randn_like(x) if residual else None
    with torch.inference_mode():
        xq, hid, out = bufs = mi.k3_buffers(x, k3["w1q_t"].shape[0])
        xq_p = ln_quant_reference(x, k3["ln_scale_q"], k3["ln_bias_q"], 1e-6)
        mi.k3_launch_part(0, x, **k3, residual=res, bufs=bufs)
        torch.cuda.synchronize()
        assert _int8_flips(xq, xq_p)
        xq.copy_(xq_p)
        mi.k3_launch_part(1, x, **k3, residual=res, bufs=bufs)
        torch.cuda.synchronize()
        hid_p = mi.mlp_fc1_int8_reference(xq_p, k3["w1q_t"], k3["s1_eff"],
                                          k3["b1"], k3["inv_a_mid"])
        assert _int8_flips(hid, hid_p)
        assert hid_p.abs().max() > 16
        hid.copy_(hid_p)
        mi.k3_launch_part(2, x, **k3, residual=res, bufs=bufs)
        torch.cuda.synchronize()
        want = int8_resid_reference(hid_p, k3["w2q_t"], k3["s2_eff"],
                                    k3["b2"], (x if res is None else res)
                                    .reshape(-1, d), gamma=k3["gamma"])
        assert _bf16_close(out.reshape(-1, d), want)


@pytest.mark.parametrize("residual", [False, True])
def test_k3_launches_one_by_one_equal_the_whole(cuda, residual):
    from geovpr_torch.ops import mlp_int8 as mi
    x, _, k3 = int8_block_case(2, 257, 768, 12, cuda)
    res = torch.randn_like(x) if residual else None
    with torch.inference_mode():
        out = mi.fused_mlp_block_int8(x, **k3, residual=res)
        bufs = mi.k3_buffers(x, k3["w1q_t"].shape[0])
        before = mi.fused_mlp_block_int8.launches
        for part in range(len(mi.K3_PARTS)):
            mi.k3_launch_part(part, x, **k3, residual=res, bufs=bufs)
        torch.cuda.synchronize()
    assert mi.fused_mlp_block_int8.launches == before
    assert torch.equal(bufs[2], out)


@pytest.mark.parametrize("shape", [(2, 128, 24), (3, 64, 10), (1, 512, 24),
                                   (2, 96, 14), (1, 1024, 6), (2, 40, 8)])
def test_k6_matches_plain_version(cuda, shape):
    """C = 96 (2C = 192, Swin-T's stage 0) takes 64-wide output tiles;
    C = 1024 holds 16 chunks a lane in the merge-LN pass; C = 40 ends K =
    160 and 2C = 80 on partial tiles that TMA fills with zeros."""
    from geovpr_torch.ops.patch_merge import (fused_patch_merge,
                                              patch_merge_reference)
    args = merge_case(shape, cuda)
    before = fused_patch_merge.launches
    e = ratio_errors(fused_patch_merge, patch_merge_reference, args,
                     f32(args))
    assert fused_patch_merge.launches == before + 1
    assert k1_within_bound(e), e


@pytest.mark.parametrize("shape", [(64, 128, 96), (2, 256, 48), (1, 512, 24),
                                   (2, 96, 56), (3, 64, 10), (2, 40, 8),
                                   (3, 40, 10)])
def test_k6_f32_matches_plain_version(cuda, shape):
    """K6's f32 form at Swin-B-384's first boundary (B=64), the next two,
    Swin-T-224's first (2C = 192) and small or odd widths (at C = 40 on a
    10 x 10 grid the f32 GEMM's M = 75 rows and N = 80 columns end inside
    its 128 x 64 tiles); it refuses f16 and mixed types."""
    from geovpr_torch.ops.patch_merge import (fused_patch_merge,
                                              patch_merge_reference)
    args = merge_case(shape, cuda, dtype=torch.float32)
    _f32_within_bound(fused_patch_merge, patch_merge_reference, args)
    x, ln_s, ln_b, w, res = args
    with torch.inference_mode():
        with pytest.raises(TypeError):
            fused_patch_merge(x, ln_s, ln_b, w.bfloat16(), res)
        with pytest.raises(TypeError):
            fused_patch_merge(x.half(), ln_s, ln_b, w.half(), res)


def test_k6_refuses_what_it_does_not_take(cuda):
    from geovpr_torch.ops.patch_merge import fused_patch_merge
    x, ln_s, ln_b, w, res = merge_case((1, 64, 8), cuda)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xm = buf[1:].view_as(x).copy_(x)
    with torch.inference_mode(), pytest.raises(ValueError, match="aligned"):
        fused_patch_merge(xm, ln_s, ln_b, w, res)
    x, ln_s, ln_b, w, res = merge_case((1, 1032, 2), cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="1024"):
        fused_patch_merge(x, ln_s, ln_b, w, res)


def test_swin_kernels_refuse_what_they_do_not_take(cuda):
    """K4 refuses an f32 x with bf16 matrices and f16; f32 throughout runs
    its f32 form within the f32 bound."""
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                             fused_swin_attn_block_int8,
                                             swin_attn_block_reference)
    x, blk = swin_block_case((1, 64, 2, 8, 4, 2), cuda)
    args = list(k4_args(x, blk))
    _f32_within_bound(fused_swin_attn_block, swin_attn_block_reference,
                      f32(args), x.float())
    with torch.inference_mode(), pytest.raises(TypeError):
        fused_swin_attn_block(x.float(), *args[1:])      # bf16 matrices
    with torch.inference_mode(), pytest.raises(TypeError):
        fused_swin_attn_block(*(a.half() if i in (0, 3, 5) else a
                                for i, a in enumerate(args)))
    table = args[7][:, :1].contiguous()                # one head of 64
    with torch.inference_mode(), pytest.raises(ValueError, match="head dim"):
        fused_swin_attn_block(*args[:7], table, 1, *args[9:])
    with pytest.raises(RuntimeError, match="backward"):
        fused_swin_attn_block(*args)                     # grads enabled
    with torch.inference_mode(), pytest.raises(ValueError, match="shift"):
        fused_swin_attn_block(*args[:11], 1)             # not window // 2
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xm = buf[1:].view_as(x).copy_(x)                     # 2 bytes off
    with torch.inference_mode(), pytest.raises(ValueError, match="aligned"):
        fused_swin_attn_block(xm, *args[1:])
    x, blk = swin_block_case((1, 64, 2, 8, 4, 2), cuda, int8=True)
    kw = k5_kwargs(blk)
    with torch.inference_mode(), pytest.raises(ValueError, match="needs"):
        fused_swin_attn_block_int8(x, **{**kw, "cs": None, "cpv": 1.0})
    with torch.inference_mode(), pytest.raises(ValueError, match="shift"):
        fused_swin_attn_block_int8(x, **{**kw, "shift": 1})
    with torch.inference_mode(), pytest.raises(ValueError, match="aligned"):
        fused_swin_attn_block_int8(xm.bfloat16(), **kw)
    x, blk = swin_block_case((1, 96, 3, 8, 4, 2), cuda, int8=True)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="multiple of 64"):
        fused_swin_attn_block_int8(x, **k5_kwargs(blk))


@pytest.mark.parametrize("int8", [False, True])
def test_swin_model_launches_per_block(cuda, int8):
    """A two-stage Swin: one K4 (bf16) or K5 + K3 (int8) per block, one K6
    at the boundary."""
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving
    from geovpr_torch.models.swin import SwinTransformer
    from geovpr_torch.ops.patch_merge import fused_patch_merge
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                             fused_swin_attn_block_int8)

    model = SwinTransformer(embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                            window_size=4, image_size=32,
                            dtype=torch.bfloat16, int8_attn=int8,
                            int8_mlp=int8)
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    x = torch.randn(2, 32, 32, 3, device=cuda)
    if int8:
        quantize_for_serving(model, [x])
    fns = (fused_swin_attn_block, fused_swin_attn_block_int8,
           fused_mlp_block_int8, fused_patch_merge)
    before = [f.launches for f in fns]
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip(fns, before)]
    assert got == ([0, 4, 4, 1] if int8 else [4, 0, 0, 1])
    assert torch.isfinite(out.tokens).all()


_K7_SHAPES = [(8, 3, 49, 4), (4, 2, 49, 0), (2, 16, 144, 0), (4, 1, 144, 4),
              (2, 1, 225, 0)]


@pytest.mark.parametrize("shape", _K4_SHAPES + [(64, 128, 4, 96, 12, 6),
                                               (64, 1024, 32, 12, 12, 0)])
def test_k4_f32_matches_plain_version(cuda, shape):
    """K4's f32 form, x at 1e-2 as K1's check (the branch dominates),
    at the bf16 test shapes and Swin-B-384's first and last stages (B=64);
    it refuses mixed types."""
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                             swin_attn_block_reference)
    x, blk = swin_block_case(shape, cuda, x_scale=1e-2, dtype=torch.float32)
    args = k4_args(x, blk)
    _f32_within_bound(fused_swin_attn_block, swin_attn_block_reference, args,
                      x)
    with torch.inference_mode(), pytest.raises(TypeError):
        fused_swin_attn_block(x, *args[1:3], args[3].bfloat16(), *args[4:])


@pytest.mark.parametrize("shape", _K7_SHAPES)
def test_k7_matches_plain_version(cuda, shape):
    """K1's bound: max and mean |error| against the f32 plain version
    within 1.25x and 1.1x the bf16 plain version's; N = 49 and 144 with and
    without the shift mask, and N = 225 (above 48 KB of shared memory)."""
    from geovpr_torch.ops.window_attention import (
        window_attention_kernel, window_attention_serving_reference)
    args = k7_case(shape, cuda)
    before = window_attention_kernel.launches
    e = ratio_errors(window_attention_kernel,
                     window_attention_serving_reference, args, f32(args))
    assert window_attention_kernel.launches == before + 1
    assert k1_within_bound(e), e


@pytest.mark.parametrize("shape", _K7_SHAPES + [(4, 2, 256, 0)])
def test_k7_f32_matches_plain_version(cuda, shape):
    """K7's f32 form on pre-split windows: N = 49, 144 and 225 with and
    without the shift mask, and N = 256 (32 warps)."""
    from geovpr_torch.ops.window_attention import (
        window_attention_kernel, window_attention_serving_reference)
    args = f32(k7_case(shape, cuda))
    _f32_within_bound(window_attention_kernel,
                      window_attention_serving_reference, args)


def test_k7_refuses_what_it_does_not_take(cuda):
    """K7 refuses mixed and f16 operands and f64 or bf16 bias and mask; in
    f32 throughout it runs its f32 form within the f32 bound."""
    from geovpr_torch.ops.window_attention import (
        window_attention_kernel, window_attention_serving_reference)
    q, k, v, bias, mask = k7_case((8, 3, 49, 4), cuda)
    _f32_within_bound(window_attention_kernel,
                      window_attention_serving_reference,
                      (q.float(), k.float(), v.float(), bias, mask))
    with torch.inference_mode():
        with pytest.raises(TypeError):
            window_attention_kernel(q.half(), k.half(), v.half(), bias, mask)
        with pytest.raises(TypeError):
            window_attention_kernel(q.float(), k, v, bias, mask)
        with pytest.raises(TypeError):
            window_attention_kernel(q, k, v, bias.double(), mask)
        with pytest.raises(TypeError):
            window_attention_kernel(q, k, v, bias, mask.bfloat16())
        with pytest.raises(ValueError, match="contiguous"):
            window_attention_kernel(q.transpose(0, 1).contiguous()
                                    .transpose(0, 1), k, v, bias, mask)
        with pytest.raises(ValueError, match="head dim"):
            window_attention_kernel(*(t.reshape(8, 3, 49 // 7, 7 * 32)
                                      [..., :64].contiguous()
                                      for t in (q, k, v)),
                                    bias[:, :7, :7].contiguous(),
                                    mask[:, :7, :7].contiguous())
        big = torch.zeros(1, 1, 289, 32, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="256 tokens"):
            window_attention_kernel(big, big, big, torch.zeros(
                1, 289, 289, device=cuda), None)
    # with a gradient it launches too (its backward the plain VJP)
    out = window_attention_kernel(q, k, v, bias.clone().requires_grad_(True),
                                  mask)
    assert out.grad_fn is not None


@pytest.mark.parametrize("entry", ["split", "raster"])
def test_k7_gradients_are_the_plain_versions(cuda, entry):
    """K7 under autograd, JAX's `custom_vjp`: the forward is the kernel
    (one launch), the backward the VJP of the plain `window_attention`
    recompute, so every gradient equals autograd's through the plain
    path on the same inputs, bit for bit."""
    from geovpr_torch.ops import window_attention as wa
    if entry == "split":
        q, k, v, bias, mask = k7_case((8, 3, 49, 4), cuda)
        args = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        launch = lambda a: wa.window_attention_kernel(*a, mask)  # noqa
        plain = lambda a: wa.window_attention(*a, mask)  # noqa: E731
        counter = wa.window_attention_kernel
    else:
        qkv, table, h, res, win, shift = k7_raster_case(
            (2, 96, 3, 14, 7, 3), cuda)
        args = [t.clone().requires_grad_(True) for t in (qkv, table)]
        launch = lambda a: wa.window_attention_raster(  # noqa: E731
            *a, h, res, win, shift)
        plain = lambda a: wa.windowed_attention(  # noqa: E731
            wa.window_attention, *a, h, res, win, shift)
        counter = wa.window_attention_raster
    before = counter.launches
    out = launch(args)
    assert counter.launches == before + 1
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)
                    ).to(out)
    got = torch.autograd.grad(out, args, g)
    ref = [t.detach().clone().requires_grad_(True) for t in args]
    want = torch.autograd.grad(plain(ref), ref, g)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# Swin-T-224's four stages (B, C, H, resolution, window, shift) at B = 8,
# shifted where the stage has shifted blocks
_K7_RASTER_SHAPES = [(8, 96, 3, 56, 7, 3), (8, 192, 6, 28, 7, 3),
                     (8, 384, 12, 14, 7, 3), (8, 768, 24, 7, 7, 0)]


@pytest.mark.parametrize("shape", _K7_RASTER_SHAPES)
def test_k7_raster_matches_plain_version(cuda, shape):
    """K7's raster mode against its plain version (the windows gathered,
    `window_attention_serving_reference`, scattered back) under K1's bound;
    one launch a call."""
    from geovpr_torch.ops.window_attention import (
        window_attention_raster, window_attention_raster_reference)
    args = k7_raster_case(shape, cuda)
    before = window_attention_raster.launches
    e = ratio_errors(window_attention_raster,
                     window_attention_raster_reference, args, f32(args))
    assert window_attention_raster.launches == before + 1
    assert k1_within_bound(e), e


@pytest.mark.parametrize("shape", _K7_RASTER_SHAPES + [
    (64, 96, 3, 56, 7, 3), (2, 64, 2, 24, 12, 6), (1, 32, 1, 12, 3, 2)])
def test_k7_raster_f32_matches_plain_version(cuda, shape):
    """K7's raster mode in f32 (the window-7 half of a model built in f32)
    at Swin-T-224's four stages (B=8, and stage 0 at B=64), window 12 and
    a shift other than window // 2: the f32 bound, and bit-equal to the
    f32 split launch on the gathered windows."""
    from geovpr_torch.ops.window_attention import (
        window_attention_kernel, window_attention_raster,
        window_attention_raster_reference, windowed_attention)
    args = k7_raster_case(shape, cuda, dtype=torch.float32)
    _f32_within_bound(window_attention_raster,
                      window_attention_raster_reference, args)
    with torch.inference_mode():
        got = window_attention_raster(*args)
        want = windowed_attention(window_attention_kernel, *args)
        torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", _K7_RASTER_SHAPES + [
    (2, 64, 2, 21, 7, 3), (2, 64, 2, 24, 12, 6), (1, 32, 1, 12, 3, 2)])
def test_k7_raster_equals_split_launch(cuda, shape):
    """The raster launch is bit-equal to the split launch on the windows
    `_windows_qkv` gathers, its context scattered back by `_raster_ctx`:
    the four stages, a 3 x 3 grid of shifted windows, window 12 and a
    shift other than window // 2."""
    from geovpr_torch.ops.window_attention import (window_attention_kernel,
                                                   window_attention_raster,
                                                   windowed_attention)
    args = k7_raster_case(shape, cuda)
    with torch.inference_mode():
        got = window_attention_raster(*args)
        want = windowed_attention(window_attention_kernel, *args)
        torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)


def test_k7_raster_refuses_what_it_does_not_take(cuda):
    """The raster mode refuses an f16 qkv and an f64 table; an f32 qkv runs
    its f32 form within the f32 bound."""
    from geovpr_torch.ops.window_attention import (
        window_attention_raster, window_attention_raster_reference)
    qkv, table, h, res, win, shift = k7_raster_case((2, 96, 3, 14, 7, 3),
                                                    cuda)
    geom = (h, res, win, shift)
    _f32_within_bound(window_attention_raster,
                      window_attention_raster_reference,
                      (qkv.float(), table, *geom))
    with torch.inference_mode():
        with pytest.raises(TypeError):
            window_attention_raster(qkv.half(), table, *geom)
        with pytest.raises(TypeError):
            window_attention_raster(qkv, table.double(), *geom)
        with pytest.raises(ValueError, match="contiguous"):
            window_attention_raster(qkv.transpose(0, 1).contiguous()
                                    .transpose(0, 1), table, *geom)
        with pytest.raises(ValueError, match="head dim"):
            window_attention_raster(qkv, table[:, :1].contiguous(), 1, res,
                                    win, shift)
        with pytest.raises(ValueError, match="shift"):
            window_attention_raster(qkv, table, h, res, win, 7)
    # with a gradient it launches too (its backward the plain VJP)
    out = window_attention_raster(qkv, table.clone().requires_grad_(True),
                                  *geom)
    assert out.grad_fn is not None


def test_swin7_model_launches_per_block(cuda):
    """A two-stage window-7 Swin: one K7 (its raster mode) per block, one
    K6 at the boundary, no K4 and no split-mode K7."""
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.swin import SwinTransformer
    from geovpr_torch.ops.patch_merge import fused_patch_merge
    from geovpr_torch.ops.swin_block import fused_swin_attn_block
    from geovpr_torch.ops.window_attention import (window_attention_kernel,
                                                   window_attention_raster)

    model = SwinTransformer(embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                            window_size=7, image_size=56,
                            dtype=torch.bfloat16)
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    x = torch.randn(2, 56, 56, 3, device=cuda)
    fns = (window_attention_raster, fused_patch_merge, fused_swin_attn_block,
           window_attention_kernel)
    before = [f.launches for f in fns]
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [4, 1, 0, 0]
    assert torch.isfinite(out.tokens).all()


_K9_SHAPES = [(2, 128, 4, 24, 12, 6), (2, 256, 8, 24, 12, 6),
              (1, 512, 16, 24, 12, 6), (2, 1024, 32, 12, 12, 0)]


@pytest.mark.parametrize("shape", _K9_SHAPES)
def test_k9_matches_plain_version(cuda, shape):
    """chip_smoke's K9 check at small batches of Swin-B-384's four stage
    widths: K9a's y, qkv, ctx and p, K9b's dqkv and dbias, and K9c's (or,
    at C = 1024, the split backward's) dx and every weight gradient within
    K1's ratio bound; one launch each."""
    from chip_smoke import k9_kernels_vs_plain
    from geovpr_torch.ops import swin_block as sb
    fns = (sb.fused_swin_attn_train_fwd, sb.fused_swin_attn_bwd_core,
           sb.fused_swin_attn_bwd_all)
    before = [f.launches for f in fns]
    k9_kernels_vs_plain(cuda, shapes=(shape,))
    split = shape[1] > 512
    assert [f.launches - b for f, b in zip(fns, before)] == \
        [1, 2 if split else 1, 0 if split else 1]


def test_k9_refuses_what_it_does_not_take(cuda):
    from chip_smoke import k9_case
    from geovpr_torch.ops import swin_block as sb
    a, g, geom = k9_case((1, 128, 4, 24, 12, 6), cuda)
    args = [a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wo",
                           "bo", "table")]
    geo = list(geom.values())
    with torch.no_grad():
        with pytest.raises(TypeError):
            sb.fused_swin_attn_train_fwd(args[0].float(), *args[1:], *geo)
        with pytest.raises(TypeError):
            sb.fused_swin_attn_train_fwd(*args[:7], args[7].bfloat16(),
                                         *geo)
        x8 = args[0][:, :64].contiguous()
        with pytest.raises(ValueError, match="window 12"):
            sb.fused_swin_attn_train_fwd(x8, *args[1:7], torch.zeros(
                49, 4, device=cuda), 4, 8, 4, 2)
        _, qkv, ctx, p = sb.fused_swin_attn_train_fwd(*args, *geo)
        wide = torch.zeros(1, 144, 1024, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="C <= 512"):
            sb.fused_swin_attn_bwd_all(
                wide, *(torch.zeros(1024, device=cuda),) * 2,
                torch.zeros(1024, 3072, dtype=torch.bfloat16, device=cuda),
                torch.zeros(1024, 1024, dtype=torch.bfloat16, device=cuda),
                torch.zeros(1, 144, 3072, dtype=torch.bfloat16, device=cuda),
                wide, torch.zeros(1, 32, 144, 144, dtype=torch.bfloat16,
                                  device=cuda), wide, 32, 12, 12, 0)


@pytest.mark.parametrize("shape", _K9_SHAPES + [(2, 192, 6, 24, 12, 6)])
def test_k9a_launches_match_their_plain_parts(cuda, shape):
    """Each of K9a's four launches alone (`k9a_launch_part`), fed the plain
    parts' output of the launch before it, against its plain part
    (tests/test_torch_swin_train_hopper.py composes the parts to the whole
    plain version): the LayerNorm, qkv and its scaled q copy and the out
    projection within one bf16 spacing (f32 sums in another order), the
    attention's ctx and p within K1's ratio bound (`k9_ratio`: against the
    f32 plain parts on the f32 block, as chip_smoke.py holds the whole
    K9a). At C = 192 (H = 6) the GEMMs take 64-wide tiles and the last
    head pair has one head."""
    from chip_smoke import k9_case, k9_ratio
    from geovpr_torch.ops import swin_block as sb
    a, _, geom = k9_case(shape, cuda)
    geo = tuple(geom.values())
    fa = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"], a["wo"],
          a["bo"], a["table"], *geo, 1e-5)
    b, c, h = shape[:3]
    m = a["x"].numel() // c
    tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)
    with torch.no_grad():
        bufs = sb.k9a_buffers(a["x"], h, geom["window"])
        sb.k9a_launch_part(0, *fa, bufs=bufs)
        torch.cuda.synchronize()
        hh = sb.train_ln_reference(a["x"].reshape(m, c), a["ln_scale"],
                                   a["ln_bias"])
        assert _bf16_close(bufs["ctx"].reshape(m, c), hh)
        bufs["ctx"].copy_(hh.reshape(bufs["ctx"].shape))
        sb.k9a_launch_part(1, *fa, bufs=bufs)
        torch.cuda.synchronize()
        qkv, qs = sb.train_qkv_reference(hh, a["wqkv"], a["bqkv"], h)
        assert _bf16_close(bufs["qkv"].reshape(m, 3 * c), qkv)
        assert _bf16_close(bufs["qs"].reshape(m, c), qs)
        bufs["qkv"].copy_(qkv.reshape(bufs["qkv"].shape))
        bufs["qs"].copy_(qs.reshape(bufs["qs"].shape))
        sb.k9a_launch_part(2, *fa, bufs=bufs)
        torch.cuda.synchronize()
        want = sb.train_attention_reference(
            bufs["qs"], bufs["qkv"], a["table"], *geo)
        h32 = sb.train_ln_reference(a["x"].float().reshape(m, c),
                                    a["ln_scale"], a["ln_bias"])
        qkv32, qs32 = sb.train_qkv_reference(h32, a["wqkv"].float(),
                                             a["bqkv"], h)
        ref = sb.train_attention_reference(
            qs32.reshape(bufs["qs"].shape), qkv32.reshape(bufs["qkv"].shape),
            a["table"], *geo)
        k9_ratio("K9a.attention.ctx", tag, bufs["ctx"], want[0], ref[0])
        k9_ratio("K9a.attention.p", tag, bufs["p"], want[1], ref[1])
        bufs["ctx"].copy_(want[0])
        sb.k9a_launch_part(3, *fa, bufs=bufs)
        torch.cuda.synchronize()
        assert _bf16_close(bufs["y"].reshape(m, c), sb.train_out_proj_reference(
            want[0].reshape(m, c), a["wo"], a["bo"]))


def test_k9a_launches_one_by_one_equal_the_whole(cuda):
    """K9a's four launches run alone (`k9a_launch_part`, which
    chip_smoke.py times) leave one whole call's outputs, bit for bit, and
    count no launch."""
    from chip_smoke import k9_case
    from geovpr_torch.ops import swin_block as sb
    a, _, geom = k9_case((2, 128, 4, 24, 12, 6), cuda)
    fa = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"], a["wo"],
          a["bo"], a["table"], *geom.values(), 1e-5)
    with torch.no_grad():
        whole = sb.fused_swin_attn_train_fwd(*fa)
        bufs = sb.k9a_buffers(a["x"], geom["num_heads"], geom["window"])
        before = sb.fused_swin_attn_train_fwd.launches
        for part in range(len(sb.K9A_PARTS)):
            sb.k9a_launch_part(part, *fa, bufs=bufs)
        torch.cuda.synchronize()
    assert sb.fused_swin_attn_train_fwd.launches == before
    for name, want in zip(("y", "qkv", "ctx", "p"), whole):
        assert torch.equal(bufs[name], want), name


@pytest.mark.parametrize("shape", _K9_SHAPES + [(3, 128, 4, 96, 12, 6)])
def test_k9_core_matches_its_plain_version(cuda, shape):
    """The core backward (K9b's launch, and K9c's launch 3) at the four
    Swin-B-384 stage widths against `swin_attn_core_bwd_reference` on the
    bf16 plain forward's residuals: dqkv and dbias within K1's ratio bound
    (`k9_ratio`) of the bf16 plain version against the f32 one on the f32
    forward's residuals, as chip_smoke.py holds K9b. At B = 3,
    S = 96 each CTA walks two or three windows, so its ring reloads a
    stage; the wrapped quarters of the last window row and column load
    from their wrapped origin."""
    from chip_smoke import k9_case, k9_ratio
    from geovpr_torch.ops import swin_block as sb
    a, g, geom = k9_case(shape, cuda)
    geo = tuple(geom.values())
    fa = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"], a["wo"],
          a["bo"], a["table"], *geo, 1e-5)
    tag = "B{}_C{}_H{}_S{}_w{}_shift{}".format(*shape)

    def plain(qk, pp, dd):
        dq, db = sb.swin_attn_core_bwd_reference(
            sb._raster_to_rows(qk, *geo[1:]), pp,
            sb._raster_to_rows(dd, *geo[1:]), geo[0])
        return sb._rows_to_raster(dq, *geo[1:]), db

    fa32 = tuple(t.float() if torch.is_tensor(t) else t for t in fa)
    with torch.no_grad():
        _, qkv, _, p = sb._train_plain_fwd(*fa)
        _, qkv32, _, p32 = sb._train_plain_fwd(*fa32)
        before = sb.fused_swin_attn_bwd_core.launches
        got = sb.fused_swin_attn_bwd_core(qkv, p, g, *geo)
        torch.cuda.synchronize()
        want = plain(qkv, p, g)
        ref = plain(qkv32, p32, g.float())
    assert sb.fused_swin_attn_bwd_core.launches == before + 1
    for i, out in enumerate(("dqkv", "dbias")):
        k9_ratio(f"K9b.{out}", tag, got[i], want[i], ref[i])


def _f32_close(got, want):
    """An f32 sum over rows against its plain part summed in another order:
    within 1e-5 of the largest value plus 1e-4 relative."""
    err = (got - want).abs()
    return bool((err <= 1e-5 * want.abs().max() + 1e-4 * want.abs()).all())


@pytest.mark.parametrize("shape", [(2, 128, 4, 24, 12, 6),
                                   (1, 512, 16, 24, 12, 6),
                                   (2, 192, 6, 24, 12, 6)])
def test_k9c_launches_match_their_plain_parts(cuda, shape):
    """K9c's four products on the TMA + wgmma GEMM against their plain
    parts, after a whole backward run launch by launch: dh and da (the
    (in, out) weights read K-major) within one bf16 spacing, dWo and
    dWqkv (rows of both operands, in `wgrad_chunk` chunks) within f32
    reassociation. C = 192 takes 64-wide column tiles and a second row
    tile of the weight gradients that ends past C."""
    from chip_smoke import k9_case
    from geovpr_torch.ops import swin_block as sb
    a, g, geom = k9_case(shape, cuda)
    geo = tuple(geom.values())
    c = shape[1]
    with torch.no_grad():
        _, qkv, ctx, p = sb.fused_swin_attn_train_fwd(
            a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"],
            a["wo"], a["bo"], a["table"], *geo, 1e-5)
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["wo"], qkv,
                ctx, p, g, *geo, 1e-5)
        bufs = sb.k9c_buffers(a["x"], *geo[:3])
        for part in range(len(sb.K9C_PARTS)):
            sb.k9c_launch_part(part, *args, bufs=bufs)
        torch.cuda.synchronize()
        m = g.numel() // c
        g2, dqkv, h = (t.reshape(m, -1) for t in (g, bufs["dqkv"],
                                                  bufs["h"]))
        assert _bf16_close(bufs["da"].reshape(m, c),
                           sb.bwd_product_reference(dqkv, a["wqkv"]))
        assert _f32_close(bufs["dwo"], sb.weight_grad_reference(
            ctx.reshape(m, c), g2, sb.wgrad_chunk(m, c, c)))
        assert _f32_close(bufs["dwqkv"], sb.weight_grad_reference(
            h, dqkv, sb.wgrad_chunk(m, c, 3 * c)))
        sb.k9c_launch_part(0, *args, bufs=bufs)
        torch.cuda.synchronize()
        assert _bf16_close(bufs["da"].reshape(m, c),
                           sb.bwd_product_reference(g2, a["wo"]))


def test_k9c_launches_one_by_one_equal_the_whole(cuda):
    """K9c's launches run alone (`k9c_launch_part`, which chip_smoke.py
    times) leave one whole call's outputs, bit for bit, and count no
    launch: its sums have a fixed order."""
    from chip_smoke import k9_case
    from geovpr_torch.ops import swin_block as sb
    a, g, geom = k9_case((2, 128, 4, 24, 12, 6), cuda)
    geo = tuple(geom.values())
    with torch.no_grad():
        _, qkv, ctx, p = sb.fused_swin_attn_train_fwd(
            a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["bqkv"],
            a["wo"], a["bo"], a["table"], *geo, 1e-5)
        args = (a["x"], a["ln_scale"], a["ln_bias"], a["wqkv"], a["wo"], qkv,
                ctx, p, g, *geo, 1e-5)
        whole = sb.fused_swin_attn_bwd_all(*args)
        bufs = sb.k9c_buffers(a["x"], *geo[:3])
        before = sb.fused_swin_attn_bwd_all.launches
        for part in range(len(sb.K9C_PARTS)):
            sb.k9c_launch_part(part, *args, bufs=bufs)
        torch.cuda.synchronize()
    assert sb.fused_swin_attn_bwd_all.launches == before
    for name, want in zip(("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo",
                           "dbo", "dbias"), whole):
        assert torch.equal(bufs[name], want), name


def test_swin_train_launches_per_step(cuda):
    """A two-stage window-12 Swin under grad: one K9a and one K9c per
    block, no K4, and finite gradients for every parameter."""
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.swin import SwinTransformer
    from geovpr_torch.ops import swin_block as sb

    model = SwinTransformer(embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                            window_size=12, image_size=96,
                            dtype=torch.bfloat16, param_dtype=torch.float32,
                            drop_path_rate=0.0)
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).train()
    x = torch.randn(2, 96, 96, 3, device=cuda)
    fns = (sb.fused_swin_attn_train_fwd, sb.fused_swin_attn_bwd_all,
           sb.fused_swin_attn_bwd_core, sb.fused_swin_attn_block)
    before = [f.launches for f in fns]
    loss = model(x).pooled.square().sum()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [4, 4, 0, 0]
    assert all(bool(torch.isfinite(g).all()) and g.dtype == torch.float32
               for g in grads)


_K8_SHAPES = [(2, 257, 768, 12), (3, 50, 384, 6), (2, 17, 64, 1),
              (2, 257, 1024, 16)]


@pytest.mark.parametrize("shape", _K8_SHAPES)
def test_k8_matches_plain_version(cuda, shape):
    """chip_smoke's K8 check at small batches: K8a's out, qkv and ctx, K8b's
    dqkv, and K8c's (or, where `bwd_all_ok` fails, the split backward's)
    dx and every weight gradient within K9's ratio bound; one launch each
    (N = 17 and 50 end inside a 64-row tile; D = 1024 takes the split
    route)."""
    from chip_smoke import k8_kernels_vs_plain
    from geovpr_torch.ops import mhsa as mh
    fns = (mh.fused_mhsa_train_fwd, mh.fused_mhsa_bwd_core,
           mh.fused_mhsa_bwd_all)
    before = [f.launches for f in fns]
    k8_kernels_vs_plain(cuda, shapes=(shape,))
    split = not mh.bwd_all_ok(shape[2])
    assert [f.launches - b for f, b in zip(fns, before)] == \
        [1, 2 if split else 1, 0 if split else 1]


@pytest.mark.parametrize("shape", [(2, 257, 768, 12), (2, 257, 1024, 16)])
def test_k8a_residuals_feed_the_backward(cuda, shape):
    """The qkv and ctx that K8a keeps feed K8b (D = 1024, the split
    backward) and K8c (D = 768), whose outputs stay within K9's ratio bound
    of the plain backward on the plain forward's residuals, against the f32
    plain version on the f32 forward's."""
    from chip_smoke import (K8_OUTS, _k8_bwd_args, _k8_fwd_args, k8_case,
                            k9_ratio)
    from geovpr_torch.ops import mhsa as mh
    h = shape[3]
    tag = "B{}_N{}_D{}_H{}".format(*shape)
    a, g = k8_case(shape, cuda)
    a32 = {k: v.float() for k, v in a.items()}
    split = not mh.bwd_all_ok(shape[2])
    before = mh.fused_mhsa_bwd_core.launches, mh.fused_mhsa_bwd_all.launches
    with torch.no_grad():
        res = mh.fused_mhsa_train_fwd(*_k8_fwd_args(a, h))
        want = mh.mhsa_train_fwd_reference(*_k8_fwd_args(a, h))
        ref32 = mh.mhsa_train_fwd_reference(*_k8_fwd_args(a32, h))
        if split:
            got = mh.mhsa_train_bwd_reference(
                *_k8_bwd_args(a, res, g, h), split=True,
                core=mh.fused_mhsa_bwd_core)
        else:
            got = mh.fused_mhsa_bwd_all(*_k8_bwd_args(a, res, g, h))
        torch.cuda.synchronize()
        plain = mh.mhsa_train_bwd_reference(*_k8_bwd_args(a, want, g, h),
                                            split=split)
        ref = mh.mhsa_train_bwd_reference(
            *_k8_bwd_args(a32, ref32, g.float(), h), split=split)
    assert (mh.fused_mhsa_bwd_core.launches - before[0],
            mh.fused_mhsa_bwd_all.launches - before[1]) == \
        ((1, 0) if split else (0, 1))
    for i, out in enumerate(K8_OUTS):
        k9_ratio(f"K8a->{'K8b' if split else 'K8c'}.{out}", tag, got[i],
                 plain[i], ref[i])


def test_k8_refuses_what_it_does_not_take(cuda):
    from chip_smoke import _k8_bwd_args, _k8_fwd_args, k8_case
    from geovpr_torch.ops import mhsa as mh
    a, g = k8_case((1, 20, 1024, 16), cuda)
    with torch.no_grad():
        with pytest.raises(TypeError):
            mh.fused_mhsa_train_fwd(*_k8_fwd_args(
                {**a, "x": a["x"].float()}, 16))
        with pytest.raises(ValueError, match="head dim"):
            mh.fused_mhsa_train_fwd(*_k8_fwd_args(a, 8))
        res = mh.fused_mhsa_train_fwd(*_k8_fwd_args(a, 16))
        with pytest.raises(ValueError, match="bwd_all_ok"):
            mh.fused_mhsa_bwd_all(*_k8_bwd_args(a, res, g, 16))


@pytest.mark.parametrize("shape", [(2, 257, 768, 12), (3, 50, 384, 6),
                                   (2, 17, 64, 1)])
def test_k8c_launches_match_their_plain_parts(cuda, shape):
    """K8c's launches against their plain parts, after a whole backward
    run launch by launch: dy bit for bit; da and dh (the (in, out) weights
    read K-major) and the LN recompute within one bf16 spacing; dWo and
    dWqkv (rows of both operands, in `wgrad_chunk` chunks, M = B N with a
    row tail), dgamma (K8C_GY_ROWS-row partials), dbo, dbqkv, dls and dlb
    within f32 reassociation; dx within one bf16 spacing; the core on the
    da launch's output within K9's ratio bound of the bf16 plain core
    against the f32 one. N = 257 ends on a one-row tile, 50 and 17 inside
    one tile."""
    from chip_smoke import _k8_bwd_args, _k8_fwd_args, k8_case, k9_ratio
    from geovpr_torch.ops import mhsa as mh
    from geovpr_torch.ops.swin_block import _ln_parts, wgrad_chunk
    b, n, d, h = shape
    m = b * n
    a, g = k8_case(shape, cuda)
    with torch.no_grad():
        res = mh.fused_mhsa_train_fwd(*_k8_fwd_args(a, h))
        args = _k8_bwd_args(a, res, g, h)
        bufs = mh.k8c_buffers(a["x"], h)
        for part in range(len(mh.K8C_PARTS)):
            mh.k8c_launch_part(part, *args, bufs=bufs)
        torch.cuda.synchronize()
        gf = g.reshape(m, d).float()
        dy = bufs["dy"].reshape(m, d)
        ctx2, dqkv, hh = (t.reshape(m, -1) for t in (res[2], bufs["dqkv"],
                                                     bufs["h"]))
        assert torch.equal(dy, (gf * a["gamma"]).to(dy.dtype))
        assert _f32_close(bufs["dbo"], (gf * a["gamma"]).sum(0))
        assert _f32_close(bufs["dwo"], mh.vit_weight_grad_reference(
            ctx2, dy, wgrad_chunk(m, d, d)))
        assert _f32_close(bufs["dgamma"], mh.vit_dgamma_reference(
            ctx2, a["wo"], a["bo"], gf, mh.K8C_GY_ROWS))
        xhat, rstd, h_ref = _ln_parts(a["x"].reshape(m, d), a["ln_scale"],
                                      a["ln_bias"], 1e-6, a["x"].dtype)
        assert _bf16_close(hh, h_ref)
        assert _f32_close(bufs["dwqkv"], mh.vit_weight_grad_reference(
            hh, dqkv, wgrad_chunk(m, d, 3 * d)))
        assert _f32_close(bufs["dbqkv"], dqkv.float().sum(0))
        dh = bufs["da"].reshape(m, d)
        assert _bf16_close(dh, mh.vit_bwd_product_reference(dqkv,
                                                            a["wqkv"]))
        dx, dls, dlb = mh.vit_ln_vjp_reference(dh, xhat, rstd,
                                               a["ln_scale"], gf)
        assert _bf16_close(bufs["dx"].reshape(m, d), dx)
        assert _f32_close(bufs["dls"], dls) and _f32_close(bufs["dlb"], dlb)
        for part in (mh.K8C_PARTS.index("da"), mh.K8C_PARTS.index("core")):
            mh.k8c_launch_part(part, *args, bufs=bufs)
        torch.cuda.synchronize()
        da = bufs["da"]
        assert _bf16_close(da.reshape(m, d),
                           mh.vit_bwd_product_reference(dy, a["wo"]))
        k9_ratio("K8c.core", "B{}_N{}_D{}_H{}".format(*shape), bufs["dqkv"],
                 mh.mhsa_attn_bwd_core_reference(res[1], da, h),
                 mh.mhsa_attn_bwd_core_reference(res[1].float(), da.float(),
                                                 h))


def test_k8c_launches_one_by_one_equal_the_whole(cuda):
    """K8c's launches run alone (`k8c_launch_part`, which chip_smoke.py
    times) leave one whole call's outputs, bit for bit, and count no
    launch: its sums have a fixed order."""
    from chip_smoke import _k8_bwd_args, _k8_fwd_args, k8_case
    from geovpr_torch.ops import mhsa as mh
    a, g = k8_case((2, 257, 768, 12), cuda)
    with torch.no_grad():
        res = mh.fused_mhsa_train_fwd(*_k8_fwd_args(a, 12))
        args = _k8_bwd_args(a, res, g, 12)
        whole = mh.fused_mhsa_bwd_all(*args)
        bufs = mh.k8c_buffers(a["x"], 12)
        before = mh.fused_mhsa_bwd_all.launches
        for part in range(len(mh.K8C_PARTS)):
            mh.k8c_launch_part(part, *args, bufs=bufs)
        torch.cuda.synchronize()
    assert mh.fused_mhsa_bwd_all.launches == before
    for name, want in zip(("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo",
                           "dbo", "dgamma"), whole):
        assert torch.equal(bufs[name], want), name


def test_k8b_refuses_what_its_rule_refuses(cuda):
    """K8b's and K8c's wrappers raise on the shapes `k8b_shape_error` and
    `k8c_shape_error` reject, before any launch."""
    from geovpr_torch.ops import mhsa as mh
    qkv = torch.zeros(1, 20, 3 * 256, dtype=torch.bfloat16, device=cuda)
    da = torch.zeros(1, 20, 256, dtype=torch.bfloat16, device=cuda)
    before = mh.fused_mhsa_bwd_core.launches
    with pytest.raises(ValueError, match="head dim"):
        mh.fused_mhsa_bwd_core(qkv, da, 8)
    assert mh.fused_mhsa_bwd_core.launches == before
    assert mh.k8b_shape_error(256, 4) is None
    assert "K8c" in mh.k8c_shape_error(1024, 16)


@pytest.mark.parametrize("variant", ["base", "large"])
def test_dinov2_train_launches_per_step(cuda, variant):
    """A two-block DINOv2 under grad: one K8a and one K8c (D = 768) or one
    K8b (D = 1024) per block, no K1, and finite f32 gradients for every
    parameter."""
    from geovpr_torch.models.dinov2 import DinoV2
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.ops import mhsa as mh

    d, h = (768, 12) if variant == "base" else (1024, 16)
    model = DinoV2(hidden_size=d, num_layers=2, num_heads=h, image_size=42,
                   dtype=torch.bfloat16, param_dtype=torch.float32)
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).train()
    x = torch.randn(2, 42, 42, 3, device=cuda)
    fns = (mh.fused_mhsa_train_fwd, mh.fused_mhsa_bwd_all,
           mh.fused_mhsa_bwd_core, mh.fused_mhsa_block)
    before = [f.launches for f in fns]
    loss = model(x).tokens.float().square().sum()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    want = [2, 2, 0, 0] if variant == "base" else [2, 0, 2, 0]
    assert [f.launches - b for f, b in zip(fns, before)] == want
    assert all(bool(torch.isfinite(g).all()) and g.dtype == torch.float32
               for g in grads)


_K8_F32_SHAPES = [(2, 257, 768, 12), (3, 50, 384, 6), (2, 17, 64, 1),
                  (2, 257, 1024, 16), (2, 256, 768, 12), (1, 281, 128, 2),
                  (2, 50, 192, 3), (1, 564, 128, 2), (1, 565, 128, 2)]


@pytest.mark.parametrize("shape", _K8_F32_SHAPES)
def test_k8_f32_matches_plain_version(cuda, shape):
    """chip_smoke's [f32_training] kernel check at small batches: K8a.f32,
    K8b.f32 and (where `bwd_all_ok` holds) K8c.f32, whole and launch by
    launch, against their plain f32 versions within F32_BRANCH_REL; one
    launch each (N = 17 and 50 end inside a query tile and a key stage,
    N = 256 has no ragged tail, N = 257 one key past the last whole 32 and
    one query past the last whole tile, N = 281 keeps its score rows in the
    P and dS planes: past the 280 keys the dq CTA holds in shared memory;
    K8a.f32's attention keeps its score rows on chip at N = 564 and
    streams at 565, `k1_f32_attention_route`;
    at D = 192 the f32 GEMM's M = 100 rows, the weight gradients' 192
    output rows (1.5 tiles of 128) and their K = 100 rows of partial sums
    end inside a tile)."""
    from chip_smoke import f32_train_kernels_vs_plain
    from geovpr_torch.ops import mhsa as mh
    fns = (mh.fused_mhsa_train_fwd, mh.fused_mhsa_bwd_core,
           mh.fused_mhsa_bwd_all)
    before = [f.launches for f in fns]
    k8c = mh.bwd_all_ok(shape[2])
    f32_train_kernels_vs_plain(cuda, k8a=(shape,), k8b=(shape,),
                               k8c=(shape,) if k8c else ())
    # K8c.f32 once whole in the check and once after its launches one by
    # one
    assert [f.launches - b for f, b in zip(fns, before)] == \
        [1, 1, 2 if k8c else 0]


def test_k8b_f32_repeats_bit_for_bit(cuda):
    """K8b.f32 called twice on the same inputs gives the same bits (fixed-
    order sums, no atomics) at DINOv2-B/14's N = 257 and past the score
    rows' shared memory (N = 281): a large-14 step and its resume agree."""
    from chip_smoke import f32_train_case
    from geovpr_torch.ops import mhsa as mh
    for shape in ((2, 257, 768, 12), (1, 281, 128, 2)):
        args, da = f32_train_case(shape, cuda)
        with torch.no_grad():
            qkv = mh.mhsa_train_fwd_reference(*args[:8], shape[3], 1e-6)[1]
            runs = [mh.fused_mhsa_bwd_core(qkv, da, shape[3])
                    for _ in range(2)]
            torch.cuda.synchronize()
        assert runs[0].dtype == torch.float32
        assert torch.equal(runs[0], runs[1]), shape


def test_k8c_f32_launches_one_by_one_equal_the_whole(cuda):
    """K8c.f32's launches run alone (`k8c_launch_part`, which chip_smoke.py
    times) leave one whole call's outputs, bit for bit, and count no
    launch: its sums have a fixed order, so repeated calls agree too."""
    from chip_smoke import f32_train_case
    from geovpr_torch.ops import mhsa as mh
    args, g = f32_train_case((2, 257, 768, 12), cuda)
    x, ls, lb, wqkv, bqkv, wo, bo, gamma = args[:8]
    with torch.no_grad():
        res = mh.fused_mhsa_train_fwd(*args[:8], 12)
        ba = (x, ls, lb, wqkv, wo, bo, gamma, res[1], res[2], g, 12)
        whole = mh.fused_mhsa_bwd_all(*ba)
        again = mh.fused_mhsa_bwd_all(*ba)
        bufs = mh.k8c_buffers(x, 12)
        before = mh.fused_mhsa_bwd_all.launches
        for part in range(len(mh.K8C_PARTS)):
            mh.k8c_launch_part(part, *ba, bufs=bufs)
        torch.cuda.synchronize()
    assert mh.fused_mhsa_bwd_all.launches == before
    assert bufs["pds"].dtype == torch.float32
    for name, want, rep in zip(("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo",
                                "dbo", "dgamma"), whole, again):
        assert want.dtype == torch.float32
        assert torch.equal(bufs[name], want) and torch.equal(rep, want), name


@pytest.mark.parametrize("variant", ["base", "large"])
def test_dinov2_f32_train_launches_per_step(cuda, variant):
    """A two-block DINOv2 built with compute dtype f32 under grad: one
    K8a.f32 and one K8c.f32 (D = 768) or K8b.f32 (D = 1024) per block, each
    on an f32 stream, no K1, and finite f32 gradients for every
    parameter."""
    from chip_smoke import k8_dtypes
    from geovpr_torch.models.dinov2 import DinoV2
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.ops import mhsa as mh

    d, h = (768, 12) if variant == "base" else (1024, 16)
    model = DinoV2(hidden_size=d, num_layers=2, num_heads=h, image_size=42,
                   dtype=torch.float32, param_dtype=torch.float32)
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).train()
    x = torch.randn(2, 42, 42, 3, device=cuda)
    fns = (mh.fused_mhsa_train_fwd, mh.fused_mhsa_bwd_all,
           mh.fused_mhsa_bwd_core, mh.fused_mhsa_block)
    before = [f.launches for f in fns]
    with k8_dtypes() as seen:
        loss = model(x).tokens.float().square().sum()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
    want = [2, 2, 0, 0] if variant == "base" else [2, 0, 2, 0]
    assert [f.launches - b for f, b in zip(fns, before)] == want
    assert seen == {("k1", torch.float32), ("k8bc", torch.float32)}
    assert all(bool(torch.isfinite(g).all()) and g.dtype == torch.float32
               for g in grads)


def test_k8_f32_refuses_a_mixed_set_on_cuda(cuda):
    """An f32 stream with bf16 matrices, residuals or gradients (or the
    other way round) raises TypeError naming the tensor, before any
    launch: no f32 CUDA call gives way to the plain version."""
    from chip_smoke import f32_train_case
    from geovpr_torch.ops import mhsa as mh
    args, g = f32_train_case((1, 20, 128, 2), cuda)
    x, ls, lb, wqkv, bqkv, wo, bo, gamma = args[:8]
    fns = (mh.fused_mhsa_train_fwd, mh.fused_mhsa_bwd_core,
           mh.fused_mhsa_bwd_all)
    before = [f.launches for f in fns]
    with torch.no_grad():
        with pytest.raises(TypeError, match="wqkv is torch.bfloat16"):
            mh.fused_mhsa_train_fwd(x, ls, lb, wqkv.bfloat16(), bqkv, wo, bo,
                                    gamma, 2)
        res = mh.mhsa_train_fwd_reference(*args[:8], 2)
        with pytest.raises(TypeError, match="da is torch.bfloat16"):
            mh.fused_mhsa_bwd_core(res[1], g.bfloat16(), 2)
        with pytest.raises(TypeError, match="g is torch.bfloat16"):
            mh.fused_mhsa_bwd_all(x, ls, lb, wqkv, wo, bo, gamma, res[1],
                                  res[2], g.bfloat16(), 2)
        with pytest.raises(TypeError, match="bo"):
            mh.fused_mhsa_bwd_all(x, ls, lb, wqkv, wo, bo.bfloat16(), gamma,
                                  res[1], res[2], g, 2)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("shift", [0, 3])
def test_window7_int8_half_on_the_card(cuda, shift):
    """The window-7 w8a8 attention half (torch ops, no kernel of its own)
    on the card against the same ops on the CPU at Swin-T-224's stage-0
    width: the int8 scores are exact on both (bf16 products with f32
    sums), so what differs is the f32 softmax's and the products' order
    of sums; at most 1% of the outputs a dequant step apart."""
    from geovpr_torch.ops.swin_block import swin_attn_block_int8_unfused
    c, heads, res = 96, 3, 14
    gen = torch.Generator().manual_seed(shift)
    x = torch.randn(2, res * res, c, generator=gen).bfloat16()
    args = dict(
        ln_scale_q=torch.rand(c, generator=gen) * 40 + 20,
        ln_bias_q=torch.randn(c, generator=gen) * 5,
        wqkv_q_t=torch.randint(-127, 128, (3 * c, c), generator=gen,
                               dtype=torch.int8),
        sqkv_eff=torch.rand(3 * c, generator=gen) * 2e-3,
        bqkv_eff=torch.randn(3 * c, generator=gen),
        wo_q_t=torch.randint(-127, 128, (c, c), generator=gen,
                             dtype=torch.int8),
        so_eff=torch.rand(c, generator=gen) * 1e-3,
        bo=torch.randn(c, generator=gen) * 0.1,
        table=torch.randn(13 * 13, heads, generator=gen))
    geom = dict(num_heads=heads, resolution=res, window=7, shift=shift,
                cs=0.01)
    with torch.inference_mode():
        want = swin_attn_block_int8_unfused(x, **args, **geom)
        got = swin_attn_block_int8_unfused(
            x.to(cuda), **{k: v.to(cuda) for k, v in args.items()}, **geom)
    e = int8_errors(got.cpu(), want, args["so_eff"].max().item() * 127)
    assert int8_within_bound(e), e


@pytest.mark.parametrize("shape", [(2, 14, 128), (2, 7, 1024)])
def test_k3_convnext_separate_residual(cuda, shape):
    """K3 as the w8a8 ConvNeXt block runs it (the dwconv's output in, the
    pre-dwconv stream as the residual) against its plain version, under
    chip_smoke.py's K2/K3 rule, and one launch counted."""
    from chip_smoke import convnext_k3_case
    h, x, k3 = convnext_k3_case(shape, cuda)
    with torch.inference_mode():
        before = fused_mlp_block_int8.launches
        got = fused_mlp_block_int8(h, **k3, residual=x)
        torch.cuda.synchronize()
        want = mlp_block_int8_reference(h, **k3, residual=x)
    assert fused_mlp_block_int8.launches == before + 1
    e = int8_errors(got, want,
                    (k3["s2_eff"] * k3["gamma"]).abs().max().item())
    assert int8_within_bound(e), e


def test_convnext_int8_model_on_the_card(cuda):
    """A small w8a8 ConvNeXt (ConvNeXt-B's stage widths 128 and 256),
    calibrated on the card: K3 in every block, its kernel path against its
    plain path at cosine 0.999."""
    from geovpr_torch.models.convnext import ConvNeXt
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving
    from chip_smoke import perturb_cnn_
    gen = torch.Generator().manual_seed(0)
    model = ConvNeXt(depths=(2, 1), dims=(128, 256), dtype=torch.bfloat16,
                     int8_mlp=True)
    init_weights_(model, gen)
    perturb_cnn_(model, gen)
    model = model.to(cuda).eval()
    x = torch.randn(4, 64, 64, 3, generator=gen).to(cuda)
    quantize_for_serving(model, [x])
    with torch.inference_mode():
        before = fused_mlp_block_int8.launches
        got = model(x).pooled
        assert fused_mlp_block_int8.launches == before + 3
        for blk in model.blocks:
            blk.use_kernels = False
        want = model(x).pooled
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert cos.min().item() >= 0.999


def test_world1_nccl_step_bit_equal_to_the_single_process_step(cuda,
                                                                tmp_path):
    """A DINOv2 step (2 layers, D = 128, 2 heads: K8a and K8c) under a
    one-rank NCCL mesh equals the step without a mesh bit for bit: the
    loss, every parameter and moment (the collectives of one rank copy)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from geovpr_torch.cli.presets import build_preset, objective_for
    from geovpr_torch.data.pipeline import prefetch_to_device
    from geovpr_torch.models import dinov2
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import identity_scaler
    from geovpr_torch.parallel import create_mesh, initialize_distributed
    from geovpr_torch.train.state import TrainState, build_optimizer
    from geovpr_torch.train.steps import make_train_step

    dinov2.DINOV2_VARIANTS["card-test"] = dict(hidden_size=128, num_layers=2,
                                               num_heads=2)
    cfg = build_preset("dinov2_meanpool_huber")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, variant="card-test", image_size=28, head_dropout=0.0))
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 255, (4, 28, 28, 3)).astype(np.uint8),
             "target": rng.normal(size=(4, 2)).astype(np.float32),
             "mask": np.ones(4, bool), "_indices": np.arange(4)}

    def run(mesh):
        # f32 parameters, bf16 compute: what K8a and K8c take
        model = RegressionModel(cfg.model, torch.bfloat16,
                                train=True).to(cuda)
        init_weights_(model, torch.Generator().manual_seed(1))
        state = TrainState(0, model, build_optimizer(model, cfg.optim),
                           identity_scaler(2).to(cuda), 0)
        step = make_train_step(objective_for(cfg), mesh=mesh)
        losses = [step(state, next(prefetch_to_device([batch], cuda,
                                                      mesh=mesh)))["loss"]
                  for _ in range(2)]
        return torch.stack(losses), state

    want, ref = run(None)
    initialize_distributed(f"file://{tmp_path}/rdzv", 1, 0, device=cuda)
    try:
        got, state = run(create_mesh())
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
    for k, v in ref.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    for k, v in ref.opt.mu.items():
        assert torch.equal(state.opt.mu[k], v), k


_K9_F32_SHAPES = [(2, 128, 4, 24, 12, 6), (1, 256, 8, 24, 12, 6),
                  (1, 512, 16, 24, 12, 6), (2, 1024, 32, 12, 12, 0)]


@pytest.mark.parametrize("shape", _K9_F32_SHAPES)
def test_k9_f32_matches_plain_version(cuda, shape):
    """chip_smoke's [f32_training] K9 check at small batches of
    Swin-B-384's four stage widths: K9a.f32 and (C <= 512) K9c.f32, whole
    and launch by launch, and K9b.f32 against their plain f32 versions
    within F32_BRANCH_REL (a column sum within F32_COLSUM_SLACK x the plain
    version's own error against f64); one launch each call."""
    from chip_smoke import f32_k9_kernels_vs_plain
    from geovpr_torch.ops import swin_block as sb
    fns = (sb.fused_swin_attn_train_fwd, sb.fused_swin_attn_bwd_core,
           sb.fused_swin_attn_bwd_all)
    before = [f.launches for f in fns]
    k9c = shape[1] <= 512
    f32_k9_kernels_vs_plain(cuda, k9a=(shape,), k9b=(shape,),
                            k9c=(shape,) if k9c else ())
    # K9a.f32 and K9c.f32 once whole in the check and once after their
    # launches one by one
    assert [f.launches - b for f, b in zip(fns, before)] == \
        [2, 1, 2 if k9c else 0]


def test_k9_f32_repeats_bit_for_bit(cuda):
    """K9a.f32, K9b.f32 and K9c.f32 called twice on the same inputs give
    the same bits (fixed-order sums, no atomics): a step and its resume
    agree."""
    from chip_smoke import k9_case
    from geovpr_torch.ops import swin_block as sb
    a, g, geom = k9_case((2, 128, 4, 24, 12, 6), cuda, dtype=torch.float32)
    geo = tuple(geom.values())
    fa = [a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wo",
                         "bo", "table")]
    with torch.no_grad():
        runs = []
        for _ in range(2):
            y, qkv, ctx, p = sb.fused_swin_attn_train_fwd(*fa, *geo)
            core = sb.fused_swin_attn_bwd_core(qkv, p, g, *geo)
            grads = sb.fused_swin_attn_bwd_all(fa[0], fa[1], fa[2], fa[3],
                                               fa[5], qkv, ctx, p, g, *geo)
            runs.append((y, qkv, ctx, p, *core, *grads))
        torch.cuda.synchronize()
    assert all(t.dtype == torch.float32 for t in runs[0])
    assert all(torch.equal(u, v) for u, v in zip(*runs))


def test_swin_f32_train_launches_per_step(cuda):
    """A two-stage window-12 Swin built in f32 (C = 320, then 640) under
    grad: one K9a.f32 per block, K9c.f32 in the C <= 512 blocks and
    K9b.f32 in the C = 640 one, each on an f32 stream, no K4, and finite
    f32 gradients for every parameter."""
    from chip_smoke import k9_dtypes
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.swin import SwinTransformer
    from geovpr_torch.ops import swin_block as sb

    model = SwinTransformer(embed_dim=320, depths=(2, 1), num_heads=(10, 20),
                            window_size=12, image_size=96,
                            dtype=torch.float32)
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).train()
    x = torch.randn(2, 96, 96, 3, device=cuda)
    fns = (sb.fused_swin_attn_train_fwd, sb.fused_swin_attn_bwd_all,
           sb.fused_swin_attn_bwd_core, sb.fused_swin_attn_block)
    before = [f.launches for f in fns]
    with k9_dtypes() as seen:
        loss = model(x).pooled.square().sum()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [3, 2, 1, 0]
    assert seen == {("k9", torch.float32)}
    assert all(bool(torch.isfinite(g).all()) and g.dtype == torch.float32
               for g in grads)


def test_k9_f32_refuses_a_mixed_set_on_cuda(cuda):
    """An f32 stream with bf16 matrices, residuals or gradients (or the
    other way round) raises TypeError naming the tensor, before any
    launch: no f32 CUDA call gives way to the plain version."""
    from chip_smoke import k9_case
    from geovpr_torch.ops import swin_block as sb
    a, g, geom = k9_case((1, 128, 4, 24, 12, 6), cuda, dtype=torch.float32)
    geo = tuple(geom.values())
    fa = [a[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wo",
                         "bo", "table")]
    fns = (sb.fused_swin_attn_train_fwd, sb.fused_swin_attn_bwd_core,
           sb.fused_swin_attn_bwd_all)
    before = [f.launches for f in fns]
    with torch.no_grad():
        with pytest.raises(TypeError, match="wqkv is torch.bfloat16"):
            sb.fused_swin_attn_train_fwd(*fa[:3], fa[3].bfloat16(), *fa[4:],
                                         *geo)
        with pytest.raises(TypeError, match="x is torch.bfloat16"):
            sb.fused_swin_attn_train_fwd(fa[0].bfloat16(), *fa[1:], *geo)
        _, qkv, ctx, p = sb._train_plain_fwd(*fa, *geo, 1e-5)
        with pytest.raises(TypeError, match="p is torch.bfloat16"):
            sb.fused_swin_attn_bwd_core(qkv, p.bfloat16(), g, *geo)
        with pytest.raises(TypeError, match="g is torch.bfloat16"):
            sb.fused_swin_attn_bwd_all(fa[0], fa[1], fa[2], fa[3], fa[5], qkv,
                                       ctx, p, g.bfloat16(), *geo)
    assert [f.launches for f in fns] == before


def test_f32_patch_embedding_runs_without_tf32(cuda):
    """chip_smoke's TF32 check of the f32 Swin-B-384's patch embedding with
    cuDNN's TF32 setting at torch's default (on): the port's `conv2d`, its
    output and weight gradient, within F32_BRANCH_REL of f64, and the
    setting as it was after the call."""
    from chip_smoke import f32_tf32_conv_check
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        f32_tf32_conv_check(cuda)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ------------------------------------------------- w8a8 on an f32 stream --
# K2, K3 and K5 on an f32 stream (a model built with
# compute_dtype="float32"): the LN-quant pass reads f32 rows and the
# residual epilogue adds the f32 residual and stores f32. Held as
# chip_smoke.py's [int8_f32] holds them (`int8_f32_launch_checks`: the
# LN-quant launch alone, the rest of the call against the plain version fed
# the kernel's int8 rows under the int8 bound, the out projection alone),
# and each launch alone against its plain part.

_INT8_MODES = ["int8_scores", "int8_pv", "bf16_scores"]


@pytest.mark.parametrize("mode", _INT8_MODES)
@pytest.mark.parametrize("shape", [(2, 257, 768, 12), (3, 50, 384, 6)])
def test_k2_int8_f32_matches_plain_version(cuda, shape, mode):
    from chip_smoke import (int8_f32_launch_checks, int8_f32_within_bound,
                            int8_mode)
    b, n, d, h = shape
    with int8_mode(mode):
        x, k2, _ = int8_block_case(b, n, d, h, cuda, dtype=torch.float32)
    with torch.inference_mode():
        before = fused_mhsa_block_int8.launches
        got = fused_mhsa_block_int8(x, **k2, num_heads=h)
        torch.cuda.synchronize()
        assert fused_mhsa_block_int8.launches == before + 1
        assert got.dtype == torch.float32
        c = int8_f32_launch_checks("K2", x, dict(k2, num_heads=h), got, 1e-6)
        assert int8_f32_within_bound(c), c
        _k2_launch_checks(x, k2, h)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(2, 257, 768, 12), (2, 576, 128, 4),
                                   (2, 49, 1024, 16)])
def test_k3_int8_f32_matches_plain_version(cuda, shape, residual):
    """At DINOv2-B/14's width, Swin-B-384 stage 0's (C = 128: an LN-quant
    warp takes eight f32 rows) and stage 3's (C = 1024: one row); with
    and without the separate residual (ConvNeXt's block shape); its three
    launches one by one leave the whole call's output."""
    from chip_smoke import int8_f32_launch_checks, int8_f32_within_bound
    from geovpr_torch.ops import mlp_int8 as mi
    b, n, d, h = shape
    x, _, k3 = int8_block_case(b, n, d, h, cuda, dtype=torch.float32)
    res = torch.randn_like(x) if residual else None
    with torch.inference_mode():
        before = fused_mlp_block_int8.launches
        got = fused_mlp_block_int8(x, **k3, residual=res)
        torch.cuda.synchronize()
        assert fused_mlp_block_int8.launches == before + 1
        assert got.dtype == torch.float32
        c = int8_f32_launch_checks("K3", x, k3, got, 1e-6, res)
        assert int8_f32_within_bound(c), c
        bufs = mi.k3_buffers(x, k3["w1q_t"].shape[0])
        for part in range(len(mi.K3_PARTS)):
            mi.k3_launch_part(part, x, **k3, residual=res, bufs=bufs)
        torch.cuda.synchronize()
        assert torch.equal(bufs[2], got)


@pytest.mark.parametrize("mode", _INT8_MODES)
@pytest.mark.parametrize("shape", [(2, 128, 4, 24, 12, 6),
                                   (1, 1024, 32, 12, 12, 0)])
def test_k5_int8_f32_matches_plain_version(cuda, shape, mode):
    from chip_smoke import (int8_f32_launch_checks, int8_f32_within_bound,
                            int8_mode)
    from geovpr_torch.ops import swin_block as sb
    with int8_mode(mode):
        x, blk = swin_block_case(shape, cuda, int8=True, dtype=torch.float32)
    kw = k5_kwargs(blk)
    with torch.inference_mode():
        before = sb.fused_swin_attn_block_int8.launches
        got = sb.fused_swin_attn_block_int8(x, **kw)
        torch.cuda.synchronize()
        assert sb.fused_swin_attn_block_int8.launches == before + 1
        assert got.dtype == torch.float32
        c = int8_f32_launch_checks("K5", x, kw, got, 1e-5)
        assert int8_f32_within_bound(c), c
        _k5_launch_checks(x, kw)


def test_int8_f32_refuses_f16_and_mixed_streams(cuda):
    """`k2_dtype_error`, `k3_dtype_error` and `k5_dtype_error` on the card:
    an f16 x, and K3's residual in another dtype than x, raise TypeError
    naming the kernel, before any launch."""
    from geovpr_torch.ops import swin_block as sb
    x, k2, k3 = int8_block_case(1, 5, 64, 1, cuda, dtype=torch.float32)
    x5, blk = swin_block_case((1, 64, 2, 8, 4, 2), cuda, int8=True,
                              dtype=torch.float32)
    with torch.inference_mode():
        with pytest.raises(TypeError, match="K2"):
            fused_mhsa_block_int8(x.half(), **k2, num_heads=1)
        with pytest.raises(TypeError, match="K3"):
            fused_mlp_block_int8(x.half(), **k3)
        with pytest.raises(TypeError, match="K3"):
            fused_mlp_block_int8(x, **k3, residual=x.bfloat16())
        with pytest.raises(TypeError, match="K5"):
            sb.fused_swin_attn_block_int8(x5.half(), **k5_kwargs(blk))


def test_int8_f32_model_routes_on_the_card(cuda):
    """A small f32 int8 DINOv2 on the card: K2 takes a bf16 stream (the
    block casts around it, as JAX's does), K3 the f32 one, once a layer;
    the stream stays f32; the kernel route against the plain route (which
    keeps f32 through the attention) at cosine >= 0.999 a token."""
    from chip_smoke import int8_stream_dtypes
    from geovpr_torch.models.dinov2 import DinoV2
    from geovpr_torch.models.layers import init_weights_
    from geovpr_torch.models.quantize import quantize_for_serving

    model = DinoV2(hidden_size=128, num_layers=2, num_heads=2, image_size=28,
                   dtype=torch.float32, int8_attn=True, int8_mlp=True)
    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    x = torch.randn(3, 28, 28, 3, device=cuda)
    quantize_for_serving(model, [x])
    with torch.inference_mode(), int8_stream_dtypes() as seen:
        out = model(x).tokens
        torch.cuda.synchronize()
    assert seen == {("K2", torch.bfloat16): 2, ("K3", torch.float32): 2}
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = False
    with torch.inference_mode():
        plain = model(x).tokens
    cos = torch.nn.functional.cosine_similarity(out.flatten(0, 1),
                                                plain.flatten(0, 1), dim=-1)
    assert cos.min() >= 0.999
