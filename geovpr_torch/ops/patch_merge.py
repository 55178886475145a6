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
`geovpr_torch/csrc/patch_merge.cu` or raises; on a CPU tensor it runs
`patch_merge_reference`.
"""

from __future__ import annotations

import torch

from geovpr_torch.ops.quant import check_devices, check_shapes, layer_norm_f32


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


def fused_patch_merge(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w: torch.Tensor,
                      resolution: int, ln_eps: float = 1e-5) -> torch.Tensor:
    """Swin stage boundary on the raster stream. CPU tensors run the plain
    version; CUDA tensors launch K6 (bf16 x and w, f32 LN vectors,
    contiguous, C a multiple of 8, forward only) or raise."""
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
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
    for name in ("ln_scale", "ln_bias"):
        if got[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {got[name].dtype}")
    if c % 8:
        raise ValueError(f"the kernel takes C a multiple of 8, got C={c}")

    from geovpr_torch.ops._build import load_library
    lib = load_library()
    out = torch.empty((b, l // 4, 2 * c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_patch_merge(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w.data_ptr(), out.data_ptr(), b, resolution, c, float(ln_eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"patch_merge kernel launch failed: CUDA error {rc}")
    fused_patch_merge.launches += 1
    return out


fused_patch_merge.launches = 0
