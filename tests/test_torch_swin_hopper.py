"""The Hopper designs of K4 (Swin attention half-block) and K6 (Swin
PatchMerging), on the CPU: the per-launch bounds chip_smoke.py prints
beside each launch's time, and the shape rules of the kernels, which
every Swin preset of the port must satisfy so that no preset loses its
kernel. The kernels' arithmetic is held against JAX's interpreted kernels
through their plain versions in test_torch_swin_ops.py; the kernels
themselves run only on the card (test_torch_cuda.py).
"""

import pytest
import torch

from chip_smoke import (PEAK_BF16, SWIN_ATTN_SHAPES, SWIN_MERGE_SHAPES,
                        k4_part_bounds, k6_part_bounds, swin_bounds)
from geovpr_torch.cli.presets import ANGLE_PRESETS, GEOPOSE_PRESETS
from geovpr_torch.models.swin import (SWIN_VARIANTS, PatchMerging, SwinBlock,
                                      SwinTransformer)
from geovpr_torch.ops.patch_merge import K6_PARTS, k6_shape_error
from geovpr_torch.ops.swin_block import (K4_PARTS, fused_window_ok,
                                         k4_shape_error)

# the sums of the per-launch bounds at Swin-B-384, B=64 (ms): K4's four
# launches at stages 0-3, K6's two at its three boundaries
K4_SPLIT_MS = (0.586, 0.293, 0.160, 0.112)
K6_SPLIT_MS = (0.158, 0.084, 0.062)

SWIN_PRESETS = sorted(name for name, cfg in {**GEOPOSE_PRESETS,
                                             **ANGLE_PRESETS}.items()
                      if cfg.model.family == "swin")


@pytest.mark.parametrize("shape, want", zip(SWIN_ATTN_SHAPES, K4_SPLIT_MS))
def test_k4_part_bounds_add_up(shape, want):
    """The products of the QKV GEMM, the attention and the out projection
    are the half-block's operations; the four bounds add up to the split's
    bound (LayerNorm's f32 operations are its own)."""
    parts = {p: k4_part_bounds(p, shape) for p in K4_PARTS}
    products = sum(v["ops"] for p, v in parts.items() if p != "layernorm")
    whole = swin_bounds("K4", shape)
    assert products == whole["ops"]
    assert products / PEAK_BF16 * 1e3 == pytest.approx(whole["ops_bound_ms"])
    assert sum(v["bound_ms"] for v in parts.values()) == pytest.approx(
        want, rel=0.01)
    # each launch moves at least the bytes its inputs and outputs hold
    assert all(v["bytes_bound_ms"] > 0 for v in parts.values())


@pytest.mark.parametrize("shape, want", zip(SWIN_MERGE_SHAPES, K6_SPLIT_MS))
def test_k6_part_bounds_add_up(shape, want):
    parts = {p: k6_part_bounds(p, shape) for p in K6_PARTS}
    assert parts["gemm"]["ops"] == swin_bounds("K6", shape)["ops"]
    assert sum(v["bound_ms"] for v in parts.values()) == pytest.approx(
        want, rel=0.01)


def _swin_modules(preset):
    """The blocks and boundaries of a preset's backbone, built on the meta
    device (geometry only)."""
    cfg = {**GEOPOSE_PRESETS, **ANGLE_PRESETS}[preset]
    model = SwinTransformer(**SWIN_VARIANTS[cfg.model.variant],
                            device="meta")
    return model.blocks


@pytest.mark.parametrize("preset", SWIN_PRESETS)
def test_k4_rule_takes_every_fused_block_of(preset):
    """Every block that routes to the fused half-block takes K4's kernels;
    window-7 presets route none there (they run K7)."""
    blocks = [m for m in _swin_modules(preset) if isinstance(m, SwinBlock)]
    fused = [m for m in blocks if fused_window_ok(m.window)]
    for m in fused:
        c = m.norm1.weight.shape[0]
        assert k4_shape_error(c, m.num_heads, m.window, m.shift) is None, (
            c, m.num_heads, m.window, m.shift)
    variant = {**GEOPOSE_PRESETS, **ANGLE_PRESETS}[preset].model.variant
    assert len(fused) == (len(blocks) if SWIN_VARIANTS[variant][
        "window_size"] == 12 else 0)


@pytest.mark.parametrize("preset", SWIN_PRESETS)
def test_k6_rule_takes_every_boundary_of(preset):
    merges = [m for m in _swin_modules(preset) if isinstance(m, PatchMerging)]
    assert len(merges) == 3
    for m in merges:
        c = m.reduction_weight.shape[1] // 2
        assert k6_shape_error(c) is None, c


@pytest.mark.parametrize("c, heads, window, shift, words", [
    (128, 4, 12, 3, "shift"),         # not Swin's window // 2
    (1056, 33, 12, 6, "C <= 1024"),   # beyond the LayerNorm's registers
    (128, 2, 12, 6, "head dim"),      # head dim 64
    (128, 4, 7, 3, "head dim"),       # N = 49: the unfused half around K7
])
def test_k4_rule_refuses(c, heads, window, shift, words):
    err = k4_shape_error(c, heads, window, shift)
    assert err is not None and words in err


@pytest.mark.parametrize("c", [96, 192, 384, 128, 256, 512, 1024, 8, 40])
def test_k6_rule_takes(c):
    assert k6_shape_error(c) is None


@pytest.mark.parametrize("c", [100, 1032, 0])
def test_k6_rule_refuses(c):
    assert "multiple of 8 up to 1024" in k6_shape_error(c)


def test_wrappers_keep_the_plain_version_on_the_cpu():
    """The rules bind only the kernels: on a CPU tensor the wrappers run
    the plain versions, whatever the shift or width."""
    from geovpr_torch.ops.patch_merge import (fused_patch_merge,
                                              patch_merge_reference)
    from geovpr_torch.ops.swin_block import (fused_swin_attn_block,
                                             swin_attn_block_reference)
    g = torch.Generator().manual_seed(0)
    c, h, res, win, shift = 64, 2, 8, 4, 1     # shift 1: not a K4 shape
    args = (torch.randn(1, res * res, c, generator=g),
            torch.ones(c), torch.zeros(c),
            torch.randn(c, 3 * c, generator=g) * c ** -0.5,
            torch.zeros(3 * c), torch.randn(c, c, generator=g) * c ** -0.5,
            torch.zeros(c), torch.randn((2 * win - 1) ** 2, h, generator=g),
            h, res, win, shift)
    assert k4_shape_error(c, h, win, shift) is not None
    torch.testing.assert_close(fused_swin_attn_block(*args),
                               swin_attn_block_reference(*args))
    m = (torch.randn(1, 16, 4, generator=g), torch.ones(16), torch.zeros(16),
         torch.randn(16, 8, generator=g), 4)   # C = 4: not a K6 width
    assert k6_shape_error(4) is not None
    torch.testing.assert_close(fused_patch_merge(*m),
                               patch_merge_reference(*m))
