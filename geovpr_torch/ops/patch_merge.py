"""Fused Swin PatchMerging (kernel K6) and its plain version.

    out = LN(concat[x00, x10, x01, x11]) @ W      (W (4C, 2C), no bias)

The port of `geovpr/ops/pallas_patch_merge.py::fused_patch_merge_rolled`
in the port's raster layout: x is a stage's (B, L, C) stream (L =
resolution**2), out the next stage's (B, L/4, 2C) stream in raster order.
x_ij is the token at (2y + i, 2x + j) of the output token (y, x), the HF
`SwinPatchMerging` concat order (`geovpr/models/swin.py:818-824`). The
LayerNorm runs in f32 with two-pass statistics and its output is rounded to
the compute dtype before the product, as the JAX kernel does
(`_merge_kernel`, `pallas_patch_merge.py:97-105`). Nothing remains to
un-roll: the JAX kernel exists to consume the shifted window layout, which
the port never builds.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel of
`geovpr_torch/csrc/patch_merge.cu` (two launches: the merge-LN pass, then
the TMA + wgmma GEMM; in f32 the two launches of `csrc/f32_serving.cu`) or
raises; on a CPU tensor it runs `patch_merge_reference`.
"""

from __future__ import annotations

import torch

from geovpr_torch.ops.quant import (check_devices, check_shapes,
                                    layer_norm_f32, serving_dtype_error)

_K6_MAX_C = 1024


def merge_gather(x: torch.Tensor, resolution: int) -> torch.Tensor:
    """(B, L, C) -> (B, L/4, 4C) in the order [x00, x10, x01, x11]."""
    b, _, c = x.shape
    t = x.reshape(b, resolution, resolution, c)
    t = torch.cat([t[:, 0::2, 0::2], t[:, 1::2, 0::2], t[:, 0::2, 1::2],
                   t[:, 1::2, 1::2]], dim=-1)
    return t.reshape(b, (resolution // 2) ** 2, 4 * c)


def patch_merge_reference(x, ln_scale, ln_bias, w, resolution: int,
                          ln_eps: float = 1e-5):
    """Plain PyTorch version: gather, LN in f32 rounded to x.dtype, product
    with f32 accumulation rounded to x.dtype."""
    m = merge_gather(x, resolution).float()
    ln = (layer_norm_f32(m, ln_eps) * ln_scale.float()
          + ln_bias.float()).to(x.dtype)
    return torch.matmul(ln.float(), w.float()).to(x.dtype)


def k6_shape_error(c: int) -> str | None:
    """The rule of K6's kernels (`csrc/patch_merge.cu`), or None where they
    take the width: C a multiple of 8 (16-byte rows for TMA and the
    merge-LN pass's loads) up to 1024 (the merge-LN pass holds a 4C row in
    one warp's registers)."""
    if c % 8 or not 0 < c <= _K6_MAX_C:
        return (f"the kernel takes C a multiple of 8 up to {_K6_MAX_C}, "
                f"got C={c}")
    return None


def k6_dtype_error(dtypes: dict) -> str | None:
    """K6's type rule on CUDA (name -> dtype of its tensors): x and w both
    bf16 (`csrc/patch_merge.cu`) or both f32 (`csrc/f32_serving.cu`), the
    LayerNorm's vectors f32. The message, or None where the rule holds."""
    return serving_dtype_error("K6", dtypes, ("x", "w"))


def fused_patch_merge(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w: torch.Tensor,
                      resolution: int, ln_eps: float = 1e-5) -> torch.Tensor:
    """Swin stage boundary on the raster stream. CPU tensors run the plain
    version; CUDA tensors launch K6 (bf16 or f32 x and w, f32 LN vectors:
    `k6_dtype_error`; contiguous, `k6_shape_error`'s widths, forward only)
    or raise."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, C), got {tuple(x.shape)}")
    b, l, c = x.shape
    if l != resolution * resolution or resolution % 2:
        raise ValueError(f"L={l} is not an even {resolution}^2 grid")
    got = {"ln_scale": ln_scale, "ln_bias": ln_bias, "w": w}
    check_shapes({"ln_scale": (4 * c,), "ln_bias": (4 * c,),
                  "w": (4 * c, 2 * c)}, got)
    check_devices(x, got)
    if x.device.type == "cpu":
        return patch_merge_reference(x, ln_scale, ln_bias, w, resolution,
                                     ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), *got.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, *got.values())):
        raise RuntimeError("fused_patch_merge has no backward kernel; run "
                           "the forward under torch.inference_mode()")
    err = k6_dtype_error({k: t.dtype for k, t in (("x", x), *got.items())})
    if err:
        raise TypeError(err)
    err = k6_shape_error(c)
    if err:
        raise ValueError(err)
    bufs = (torch.empty((b, l // 4, 4 * c), dtype=x.dtype, device=x.device),
            torch.empty((b, l // 4, 2 * c), dtype=x.dtype, device=x.device))
    lib, args = _k6_args(x, got, resolution, ln_eps, bufs)
    entry = (lib.geovpr_patch_merge_f32 if x.dtype == torch.float32
             else lib.geovpr_patch_merge)
    with torch.cuda.device(x.device):
        rc = entry(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"patch_merge kernel launch failed: CUDA error {rc}")
    fused_patch_merge.launches += 1
    return bufs[1]


def _k6_args(x, got: dict, resolution: int, ln_eps: float, bufs):
    """The library and K6's C arguments (but the stream) for a checked
    CUDA x and the (LN(merged) (B, L/4, 4C), out) buffers `bufs`."""
    from geovpr_torch.ops._build import library_on
    init = ("geovpr_f32_serving_init" if x.dtype == torch.float32
            else "geovpr_patch_merge_init")
    lib = library_on(x.device.index, init)
    ptrs = [x, got["ln_scale"], got["ln_bias"], got["w"], *bufs]
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("K6 reads its tensors by TMA and 16-byte loads: "
                         "each must start 16-byte aligned")
    return lib, (*(t.data_ptr() for t in ptrs), x.shape[0], resolution,
                 x.shape[-1], float(ln_eps))


K6_PARTS = ("merge_ln", "gemm")


def k6_launch_part(part: int, x, ln_scale, ln_bias, w, resolution: int,
                   ln_eps: float = 1e-5, *, bufs) -> None:
    """One of K6's two launches (an index into K6_PARTS) alone, on the
    arguments of `fused_patch_merge` (bf16 or f32 CUDA tensors it takes)
    and the (LN(merged), out) buffers `bufs` of an earlier call, whose
    contents it reads. chip_smoke.py times K6's launches one by one with
    it; it counts no launch."""
    err = k6_shape_error(x.shape[-1])
    if err:
        raise ValueError(err)
    lib, args = _k6_args(x, {"ln_scale": ln_scale, "ln_bias": ln_bias,
                             "w": w}, resolution, ln_eps, bufs)
    entry = (lib.geovpr_patch_merge_f32_parts if x.dtype == torch.float32
             else lib.geovpr_patch_merge_parts)
    with torch.cuda.device(x.device):
        rc = entry(*args, part, part,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"patch_merge kernel launch failed: CUDA error {rc}")


fused_patch_merge.launches = 0
