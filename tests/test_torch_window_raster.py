"""K7's raster entry (`window_attention_raster`) on the CPU: its plain
version against the window-gather composition that the window-7 serving
path ran before the entry existed, its wrapper on CPU tensors and its shape
rule, and the unfused half around it against the half around the split
entry. JAX's interpreted kernel path is held to the whole window-7 Swin in
`tests/test_torch_window_attention.py`, which now goes through this
entry."""

import numpy as np
import pytest
import torch

from geovpr_torch.ops.swin_block import swin_attn_block_unfused
from geovpr_torch.ops.window_attention import (
    _raster_ctx, _windows_qkv, k7_raster_shape_error, relative_position_bias,
    shift_mask, window_attention_kernel, window_attention_raster,
    window_attention_raster_reference, window_attention_serving_reference,
    windowed_attention)

# Swin-T-224's stage geometries (C, H, resolution) at window 7; stage 3 is
# a single window
STAGES = [(96, 3, 56), (192, 6, 28), (384, 12, 14), (768, 24, 7)]


def _case(b, c, h, res, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, res * res, 3 * c))
                           .astype(np.float32)).to(dtype)
    table = torch.from_numpy(rng.normal(size=(13 * 13, h)).astype(np.float32))
    return qkv, table


def _composition(qkv, table, h, res, win, shift):
    """The window-7 serving path's arithmetic before the raster entry: the
    windows gathered, K7's plain version on them, the context scattered
    back."""
    ctx = window_attention_serving_reference(
        *_windows_qkv(qkv, res, win, shift, h),
        relative_position_bias(table, win),
        shift_mask(res, win, shift, qkv.device))
    return _raster_ctx(ctx, res, win, shift)


@pytest.mark.parametrize("shift", [0, 3], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("stage", range(4))
def test_raster_plain_equals_window_composition(stage, shift):
    """Bit for bit, in bf16, at each stage's geometry (B = 2); stage 3 is
    one window, shifted too (Swin does not shift it, the kernel takes it:
    its one window wraps both ways)."""
    c, h, res = STAGES[stage]
    qkv, table = _case(2, c, h, res, seed=stage + shift)
    got = window_attention_raster_reference(qkv, table, h, res, 7, shift)
    assert got.shape == (2, res * res, c) and got.dtype == torch.bfloat16
    assert torch.equal(got, _composition(qkv, table, h, res, 7, shift))


@pytest.mark.parametrize("shape", [(1, 64, 2, 21, 7, 3), (2, 64, 2, 14, 7, 0),
                                   (1, 32, 1, 12, 3, 2)],
                         ids=["shifted_3x3", "unshifted", "window3_shift2"])
def test_raster_wrapper_runs_plain_version_on_cpu(shape):
    """On CPU tensors the wrapper runs the plain version, counts no launch,
    and equals the split entry on the gathered windows (which runs its own
    plain version there)."""
    b, c, h, res, win, shift = shape
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(b, res * res, 3 * c))
                           .astype(np.float32))
    table = torch.from_numpy(rng.normal(size=((2 * win - 1) ** 2, h))
                             .astype(np.float32))
    args = (qkv, table, h, res, win, shift)
    before = window_attention_raster.launches
    got = window_attention_raster(*args)
    assert window_attention_raster.launches == before
    assert torch.equal(got, window_attention_raster_reference(*args))
    assert torch.equal(got, windowed_attention(window_attention_kernel,
                                               *args))


def test_raster_wrapper_checks_its_inputs():
    qkv, table = _case(1, 64, 2, 14, seed=1, dtype=torch.float32)
    geom = (2, 14, 7, 3)
    with pytest.raises(ValueError, match="qkv must be"):
        window_attention_raster(qkv[0], table, *geom)
    with pytest.raises(ValueError, match="qkv must be"):
        window_attention_raster(qkv[..., :-1], table, *geom)
    with pytest.raises(ValueError, match="grid"):
        window_attention_raster(qkv[:, :-1], table, *geom)
    with pytest.raises(ValueError, match="grid"):
        window_attention_raster(qkv, table, 3, 14, 7, 3)
    with pytest.raises(ValueError, match="table must be"):
        window_attention_raster(qkv, table[:, :1], *geom)
    with pytest.raises(ValueError, match="table must be"):
        window_attention_raster(qkv, table, 2, 14, 2, 1)
    with pytest.raises(ValueError, match="one device"):
        window_attention_raster(qkv, table.to("meta"), *geom)
    with pytest.raises(ValueError, match="unsupported device"):
        window_attention_raster(qkv.to("meta"), table.to("meta"), *geom)


@pytest.mark.parametrize("geom,ok", [
    ((96, 3, 56, 7, 3), True), ((768, 24, 7, 7, 0), True),
    ((64, 2, 24, 12, 6), True), ((32, 1, 12, 3, 2), True),
    ((96, 2, 56, 7, 3), False), ((96, 3, 54, 7, 3), False),
    ((96, 3, 56, 7, 7), False), ((96, 3, 56, 7, -1), False),
    ((32, 1, 17, 17, 0), False), ((64, 2, 32, 16, 8), False),
    ((32, 1, 12, 0, 0), False)],
    ids=["stage0", "stage3", "window12", "window3", "head_dim_48",
         "resolution_not_tiled", "shift_7", "shift_negative", "window_17",
         "window_16", "window_0"])
def test_raster_shape_rule(geom, ok):
    err = k7_raster_shape_error(*geom)
    assert (err is None) == ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 3], ids=["unshifted", "shifted"])
def test_unfused_half_raster_equals_split(dtype, shift):
    """`swin_attn_block_unfused` with the raster entry (the window-7
    serving path) equals the half around the split entry on the gathered
    windows, bit for bit, on the CPU."""
    rng = np.random.default_rng(shift)
    c, h, res = 64, 2, 14

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))

    x = r(2, res * res, c).to(dtype)
    args = (x, 1 + r(c, scale=0.1), r(c, scale=0.1),
            r(c, 3 * c, scale=c ** -0.5).to(dtype), r(3 * c, scale=0.1),
            r(c, c, scale=c ** -0.5).to(dtype), r(c, scale=0.1),
            r(13 * 13, h))
    geom = dict(num_heads=h, resolution=res, window=7, shift=shift)
    got = swin_attn_block_unfused(*args, **geom,
                                  attention=window_attention_raster)
    want = swin_attn_block_unfused(
        *args, **geom, attention=lambda *a: windowed_attention(
            window_attention_kernel, *a))
    assert got.dtype == dtype and torch.equal(got, want)
