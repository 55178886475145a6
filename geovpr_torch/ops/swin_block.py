"""Fused Swin attention half-blocks and their plain versions: kernel K4
(bf16) and kernel K5 (w8a8) for serving, and the training half-block's
kernels K9a (forward), K9b and K9c (backward) below.

    out = x + proj(W-MSA(LN(x)) + relative-position bias [+ shift mask])

The port of `geovpr/ops/pallas_swin_block.py::fused_swin_attn_block`
(`_rolled` too) and `fused_swin_attn_block_int8`, in the port's raster
layout: x is the (B, L, C) token stream of one stage (L = resolution**2)
and the window partition with the cyclic shift of SW-MSA
(`geovpr_torch.ops.window_attention.to_windows`) is part of the op, not of
its caller. The relative-position bias comes as the ((2w-1)^2, H) table of
the block; the shift mask follows from (resolution, window, shift). wqkv is
(C, 3C) with q|k|v column blocks and wo (C, C), both (in, out); the int8
matrices are (out, in), as K2 takes them.

On a CUDA tensor the wrappers launch the hand-written Hopper kernels of
`geovpr_torch/csrc/swin_attn.cu` (K4 in f32: `csrc/f32_serving.cu`) or
raise; on a CPU tensor they run the
plain versions, which round where the JAX kernels round (`_kernel`,
`_kernel_int8`, `pallas_swin_block.py:418-517`):
- q carries dh^-0.5 * log2(e) from the f32 qkv, before its rounding;
- scores, bias and mask are in the exp2 domain; the softmax is the serving
  one, p = exp2(min(s, 100)) with no max-shift (`_SKIP_MAX`), P rounded to
  the compute dtype for P.V, the f32 row sum dividing the context (K5 in
  int8 P.V: max-shifted, P in 127ths; `swin_attention8_reference`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from geovpr_torch.ops.quant import (attn_mode, check_devices,
                                    check_int8_kernel_args, check_shapes,
                                    int8_attn_dtype_rule,
                                    int8_resid_reference, int_mm,
                                    layer_norm_f32, ln_quant_reference,
                                    mode_constants, qkv_buffers,
                                    qkv_part_reference, round_clip_int8,
                                    serving_dtype_error, training_dtype_error)
from geovpr_torch.ops.window_attention import (_raster_ctx, _windows_qkv,
                                               add_bias_mask, from_windows,
                                               relative_position_bias,
                                               relative_position_index,
                                               shift_mask, to_windows,
                                               window_attention,
                                               windowed_attention)

LOG2E = math.log2(math.e)
_KERNEL_HEAD_DIM = 32
_SWIN_MAX_C = 1024


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with f32 accumulation and an f32 result for any input dtype."""
    return torch.matmul(a.float(), b.float())


def _proj(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) with f32 accumulation and an f32 result, as JAX's
    `jnp.dot(..., preferred_element_type=jnp.float32)`: bf16 operands on a
    CUDA device go to cuBLAS's tensor cores with an f32 output
    (`torch.mm(..., out_dtype=torch.float32)`; under autograd through
    `_ProjF32`, since that product has no derivative), anything else to
    an f32 matmul."""
    if a.is_cuda and a.dtype == w.dtype == torch.bfloat16:
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            return _ProjF32.apply(a, w)
        return _mm_f32_out(a, w)
    return _mm(a, w)


def _mm_f32_out(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    out = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], w.shape[-1])


class _ProjF32(torch.autograd.Function):
    """`_mm_f32_out` with the VJP JAX takes of a dot with
    `preferred_element_type=f32`: the f32 cotangent times the other
    operand in f32, rounded to the operand's dtype (the window-7 training
    half's projections on the card)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _mm_f32_out(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = (g2 @ w.float().t()).to(a.dtype).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            dw = (a.reshape(-1, a.shape[-1]).float().t() @ g2).to(w.dtype)
        return da, dw


def _exact_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of int8-valued tensors, exact (f64), as f32."""
    return torch.matmul(a.double(), b.double()).float()


def _log2_bias_mask(table, window, resolution, shift, device):
    """The kernels' exp2-domain bias (H, N, N) and mask (nW, N, N) | None:
    each f32 value times log2(e) in f32, as `_prep_bias` and
    `_forward` pre-scale them (`pallas_swin_block.py:232-239, 1049`)."""
    bias = relative_position_bias(table.float(), window) * LOG2E
    mask = shift_mask(resolution, window, shift, device)
    return bias, None if mask is None else mask * LOG2E


def swin_attn_block_reference(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                              table, num_heads: int, resolution: int,
                              window: int, shift: int,
                              ln_eps: float = 1e-5):
    """Plain PyTorch version of K4, rounding to x.dtype where `_kernel`
    rounds (LN output, qkv with the q pre-scale, P, context)."""
    b, l, c = x.shape
    dt = x.dtype
    xf = x.float()
    h = (layer_norm_f32(xf, ln_eps) * ln_scale.float()
         + ln_bias.float()).to(dt)
    srow = torch.ones(3 * c, device=x.device)
    srow[:c] = (c // num_heads) ** -0.5 * LOG2E
    qkv = ((_mm(h, wqkv) + bqkv.float()) * srow).to(dt)
    q, k, v = _windows_qkv(qkv, resolution, window, shift, num_heads)
    bias, mask = _log2_bias_mask(table, window, resolution, shift, x.device)
    s = add_bias_mask(_mm(q, k.transpose(-1, -2)), bias, mask)
    p = torch.exp2(torch.clamp(s, max=100.0))
    ctx = (_mm(p.to(dt), v) / p.sum(-1, keepdim=True)).to(dt)
    ctx = _raster_ctx(ctx, resolution, window, shift)
    return (_mm(ctx, wo) + bo.float() + xf).to(dt)


def swin_attn_block_unfused(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                            table, num_heads: int, resolution: int,
                            window: int, shift: int, ln_eps: float = 1e-5,
                            calib: dict | None = None, attention=None,
                            residual: bool = True):
    """The JAX package's unfused path (`SwinBlock` without the fused kernel,
    `geovpr/models/swin.py:559-584`): LN, the q/k/v projections (f32
    accumulation) rounded to x.dtype, the window attention, the out
    projection rounded to x.dtype, the residual added in x.dtype.
    `attention(qkv, table, num_heads, resolution, window, shift)` maps the
    raster qkv (B, L, 3C) to the raster context (B, L, C): on the window-7
    serving path `window_attention_raster` (K7, JAX's `use_pallas=True`) or
    its plain version; None (calibration) runs `window_attention` (JAX's
    XLA path: scaled scores, max-shifted softmax) on the gathered windows.
    With `calib` (a dict) it records the amaxes the int8 calibration reads,
    at the points JAX sows them: `attn_x` the LN output, `attn_q/k/v` the
    projections, `attn_ctx` the context before the out projection. With
    `residual=False` it returns the branch alone, the out projection in
    x.dtype, so that the window-7 training path can add it through
    DropPath (`residual_drop`, `geovpr/models/swin.py:441-451`)."""
    from geovpr_torch.ops.quant import amax_into

    c = x.shape[-1]
    dt = x.dtype
    h = (layer_norm_f32(x.float(), ln_eps) * ln_scale.float()
         + ln_bias.float()).to(dt)
    qkv = (_proj(h, wqkv) + bqkv.float()).to(dt)
    if calib is not None:
        amax_into(calib, "attn_x", h)
        for key, t in zip(("attn_q", "attn_k", "attn_v"), qkv.split(c, -1)):
            amax_into(calib, key, t)
    geom = (num_heads, resolution, window, shift)
    ctx = (windowed_attention(window_attention, qkv, table, *geom)
           if attention is None else attention(qkv, table, *geom))
    if calib is not None:
        amax_into(calib, "attn_ctx", ctx)
    branch = (_proj(ctx, wo) + bo.float()).to(dt)
    return x + branch if residual else branch


def _check_geometry(x, num_heads, resolution, window, shift):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if c % num_heads:
        raise ValueError(f"C={c} is not divisible by num_heads={num_heads}")
    if x.shape[1] != resolution * resolution or resolution % window:
        raise ValueError(f"L={x.shape[1]} is not a {resolution}^2 grid of "
                         f"{window}x{window} windows")
    if not 0 <= shift < window:
        raise ValueError(f"shift {shift} outside [0, {window})")


def _window_rule_error(c, num_heads, window) -> str | None:
    """What K4 and K5 both ask: head dim 32 and a window of 16..256 tokens
    in multiples of 16."""
    if c // num_heads != _KERNEL_HEAD_DIM or not fused_window_ok(window):
        return (f"the kernel takes head dim {_KERNEL_HEAD_DIM} and windows "
                f"of 16..256 tokens in multiples of 16, got C={c}, "
                f"{num_heads} heads, window {window} (N={window * window}; "
                f"other windows take the unfused half around K7, "
                f"`swin_attn_block_unfused`)")
    return None


def _swin_rule_error(name, c, num_heads, window, shift) -> str | None:
    """What K4's and K5's kernels both ask: head dim 32 and a window of
    16..256 tokens in multiples of 16, C <= 1024 (their LayerNorms hold a
    row in one warp's registers or staging) and a shift of 0 or window //
    2, Swin's own (a quarter of a window is one TMA box, so the cyclic
    shift never splits one)."""
    err = _window_rule_error(c, num_heads, window)
    if err:
        return err
    if c > _SWIN_MAX_C:
        return f"{name} takes C <= {_SWIN_MAX_C}, got C={c}"
    if shift not in (0, window // 2):
        return (f"{name} takes a shift of 0 or window // 2 = {window // 2} "
                f"(a quarter window is one TMA box), got shift {shift}")
    return None


def k4_shape_error(c: int, num_heads: int, window: int,
                   shift: int) -> str | None:
    """The rule of K4's kernels (`csrc/swin_attn.cu`), or None where they
    take the shape (`_swin_rule_error`)."""
    return _swin_rule_error("K4", c, num_heads, window, shift)


def k4_dtype_error(dtypes: dict) -> str | None:
    """K4's type rule on CUDA (name -> dtype of its tensors): x, wqkv and
    wo all bf16 (`csrc/swin_attn.cu`) or all f32 (`csrc/f32_serving.cu`),
    the vectors and the table f32. The message, or None where the rule
    holds."""
    return serving_dtype_error("K4", dtypes, ("x", "wqkv", "wo"))


def k5_shape_error(c: int, num_heads: int, window: int,
                   shift: int) -> str | None:
    """The rule of K5's kernels (`csrc/swin_attn.cu`), or None where they
    take the shape: K4's (`_swin_rule_error`) and C a multiple of 64, an
    even number of heads (the int8 q and k boxes are head pairs of 64
    bytes, and the QKV GEMM's 128-column tiles end where q | k ends)."""
    err = _swin_rule_error("K5", c, num_heads, window, shift)
    if err is None and c % 64:
        return (f"K5 takes C a multiple of 64 (an even number of heads: "
                f"int8 q and k in head pairs), got C={c}")
    return err


def fused_window_ok(window: int) -> bool:
    """Which attention half a Swin block takes: the fused half-block (K4,
    K5) for windows of N = window**2 tokens in multiples of 16 up to 256,
    the unfused half around K7 (`swin_attn_block_unfused` with
    `window_attention_raster`) otherwise, e.g. window 7 (N = 49). The JAX
    package routes with `swin_block_kernel_ok`
    (`geovpr/ops/pallas_swin_block.py:87-92`), which also asks C % 128 == 0:
    that is the TPU's 128-lane rule, which the port's kernels do not have
    (K4 takes any C = 32 H). At the repo's variants (window 7, and window 12
    with C a multiple of 128) both rules route every block alike."""
    n = window * window
    return n % 16 == 0 and n <= 256


def fused_swin_attn_block(x: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, wqkv: torch.Tensor,
                          bqkv: torch.Tensor, wo: torch.Tensor,
                          bo: torch.Tensor, table: torch.Tensor,
                          num_heads: int, resolution: int, window: int,
                          shift: int, ln_eps: float = 1e-5) -> torch.Tensor:
    """Swin attention half-block on the raster stream. CPU tensors run the
    plain version; CUDA tensors launch K4 (bf16 or f32 x and matrices, f32
    vectors and table: `k4_dtype_error`; contiguous, `k4_shape_error`'s
    geometry, forward only) or raise."""
    _check_geometry(x, num_heads, resolution, window, shift)
    b, l, c = x.shape
    got = {"ln_scale": ln_scale, "ln_bias": ln_bias, "wqkv": wqkv,
           "bqkv": bqkv, "wo": wo, "bo": bo, "table": table}
    check_shapes({"ln_scale": (c,), "ln_bias": (c,), "wqkv": (c, 3 * c),
                  "bqkv": (3 * c,), "wo": (c, c), "bo": (c,),
                  "table": ((2 * window - 1) ** 2, num_heads)}, got)
    check_devices(x, got)
    if x.device.type == "cpu":
        return swin_attn_block_reference(x, ln_scale, ln_bias, wqkv, bqkv,
                                         wo, bo, table, num_heads,
                                         resolution, window, shift, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), *got.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, *got.values())):
        raise RuntimeError(
            "fused_swin_attn_block (K4) is the serving half-block and has no "
            "backward; under grad the block runs fused_swin_attn_train (K9), "
            "or run this forward under torch.inference_mode()")
    err = k4_dtype_error({k: t.dtype for k, t in (("x", x), *got.items())})
    if err:
        raise TypeError(err)
    err = k4_shape_error(c, num_heads, window, shift)
    if err:
        raise ValueError(err)
    m = b * l
    bufs = (torch.empty((m, 3 * c), dtype=x.dtype, device=x.device),
            torch.empty((m, c), dtype=x.dtype, device=x.device),
            torch.empty_like(x))
    lib, args = _k4_args(x, got, num_heads, resolution, window, shift,
                         ln_eps, bufs)
    entry = (lib.geovpr_swin_attn_f32 if x.dtype == torch.float32
             else lib.geovpr_swin_attn_bf16)
    with torch.cuda.device(x.device):
        rc = entry(*args, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"swin_attn kernel launch failed: CUDA error {rc}")
    fused_swin_attn_block.launches += 1
    return bufs[2]


def _k4_args(x, got: dict, num_heads, resolution, window, shift, ln_eps,
             bufs):
    """The library and K4's C arguments (but the stream) for a checked
    CUDA x and the (qkv, ctx, out) buffers `bufs`."""
    from geovpr_torch.ops._build import library_on
    lib = library_on(x.device.index, "geovpr_f32_serving_init"
                     if x.dtype == torch.float32 else "geovpr_swin_init")
    ptrs = [x] + [got[k] for k in ("ln_scale", "ln_bias", "wqkv", "bqkv",
                                   "wo", "bo", "table")] + list(bufs)
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("K4 reads its tensors by TMA and 16-byte loads: "
                         "each must start 16-byte aligned")
    c = x.shape[-1]
    qscale = (c // num_heads) ** -0.5 * LOG2E
    return lib, (*(t.data_ptr() for t in ptrs), x.shape[0], resolution, c,
                 num_heads, window, shift, float(ln_eps), float(qscale))


K4_PARTS = ("layernorm", "qkv_gemm", "attention", "out_proj")


def k4_launch_part(part: int, x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                   table, num_heads: int, resolution: int, window: int,
                   shift: int, ln_eps: float = 1e-5, *, bufs) -> None:
    """One of K4's four launches (an index into K4_PARTS) alone, on the
    arguments of `fused_swin_attn_block` (bf16 or f32 CUDA tensors it
    takes) and the (qkv (B*L, 3C), ctx (B*L, C), out) buffers `bufs` of an
    earlier call, whose contents it reads. chip_smoke.py times K4's
    launches one by one with it; it counts no launch."""
    got = {"ln_scale": ln_scale, "ln_bias": ln_bias, "wqkv": wqkv,
           "bqkv": bqkv, "wo": wo, "bo": bo, "table": table}
    err = k4_shape_error(x.shape[-1], num_heads, window, shift)
    if err:
        raise ValueError(err)
    lib, args = _k4_args(x, got, num_heads, resolution, window, shift,
                         ln_eps, bufs)
    entry = (lib.geovpr_swin_attn_f32_parts if x.dtype == torch.float32
             else lib.geovpr_swin_attn_parts)
    with torch.cuda.device(x.device):
        rc = entry(*args, part, part, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"swin_attn kernel launch failed: CUDA error {rc}")


fused_swin_attn_block.launches = 0


# ------------------------------------------------------------------- K5 ----
#
# The w8a8 half-block in its three modes (`quant.ATTN_MODES`), on the
# arguments `SwinBlock`'s int8 fold produces (the port of
# `geovpr/models/swin.py:588-629`; no LayerScale). `cs` is the natural-log
# score constant a_q a_k dh^-0.5; the kernel works in the exp2 domain and
# the wrapper passes cs * log2(e), the factor JAX's caller applies
# (`swin.py:654`). `cpv` = a_v / (127 a_ctx) dequantises the int8 P.V
# product (no key split: Swin's kernel has none).

def swin_attn_block_int8_reference(x, ln_scale_q, ln_bias_q, wqkv_q_t,
                                   sqkv_eff, bqkv_eff, wo_q_t, so_eff, bo,
                                   table, num_heads: int, resolution: int,
                                   window: int, shift: int,
                                   ln_eps: float = 1e-5, cs=None, cpv=None):
    """Plain PyTorch version of K5 in all three modes of
    `fused_swin_attn_block_int8`: `cs` given (int8 q.k^T, bf16 P.V; the
    default), `cs` and `cpv` given (int8 P.V), `cs` None (bf16 scores).
    Rounding points as JAX's kernel body `_kernel_int8`, its attention as
    `swin_attention8_reference` says. The XLA fallback
    `SwinBlock._attention_int8` (`geovpr/models/swin.py:662-729`, the
    window-7 half `swin_attn_block_int8_unfused` here) differs there
    (natural-log softmax, normalised before P is rounded, and the context
    rounded to bf16 before int8). Composed of the plain parts of K5's four
    launches."""
    b, l, c = x.shape
    mode = attn_mode(cs, cpv)
    xq = ln_quant_reference(x, ln_scale_q, ln_bias_q, ln_eps)
    qk, v = qkv_part_reference(xq, wqkv_q_t, sqkv_eff, bqkv_eff, mode,
                               (c // num_heads) ** -0.5 * LOG2E)
    ctx8 = swin_attention8_reference(qk, v, table, num_heads, resolution,
                                     window, shift, cs, cpv)
    out = int8_resid_reference(ctx8, wo_q_t, so_eff, bo, x.reshape(b * l, c))
    return out.reshape(b, l, c)


def _int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of int8-valued (..., M, K) and (..., K, N) tensors, exact, as
    f32: JAX's int32 einsum. On CUDA a bf16 product with an f32 result:
    int8 values are exact in bf16, their products in f32, and every partial
    sum stays below 2^24 (K 127^2 <= 2^24, K <= 1040), so any order of sums
    is exact; elsewhere `_exact_bmm`."""
    if not a.is_cuda:
        return _exact_bmm(a, b)
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.bmm(a.reshape(-1, m, k).to(torch.bfloat16),
                    b.reshape(-1, k, n).to(torch.bfloat16),
                    out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], n)


def swin_attn_block_int8_unfused(x, ln_scale_q, ln_bias_q, wqkv_q_t,
                                 sqkv_eff, bqkv_eff, wo_q_t, so_eff, bo,
                                 table, num_heads: int, resolution: int,
                                 window: int, shift: int,
                                 ln_eps: float = 1e-5, cs=None, cpv=None):
    """The w8a8 attention half at a window K5 does not take (window 7), as
    torch ops: JAX runs it in XLA, the fallback of
    `SwinBlock._attention_int8` (`geovpr/models/swin.py:660-730`), in its
    three modes, on the folded arguments of K5. LayerNorm in f32 and the
    LN-quant, the int8 QKV product (`torch._int_mm`), on the raster rows;
    the windows of the dequantised qkv gathered in window order with the
    cyclic shift (`_windows_qkv`); then, in the natural-log domain, bias
    and shift mask added to the scores:
    - int8 scores (`cs`): q8 k8^T times cs, the f32 softmax, P.V on bf16 P
      and v, the context rounded to bf16;
    - int8 P.V (`cs`, `cpv`): the same scores, p = exp(s - max) in f32, z
      its sum, p rounded to 127ths, times the int8 v exactly, * cpv / z;
    - bf16 scores (`cs` None): bf16 q, k, v, f32 scores times dh^-0.5, the
      softmax, bf16 P.V, the context rounded to bf16 (`window_attention`).
    The context is scattered back to raster order, rounded to int8 for the
    int8 out projection, and the residual added in f32."""
    _check_geometry(x, num_heads, resolution, window, shift)
    mode = attn_mode(cs, cpv)
    b, l, c = x.shape
    xf = x.float()
    xq = round_clip_int8(layer_norm_f32(xf, ln_eps) * ln_scale_q + ln_bias_q)
    qkv_f = (int_mm(xq.reshape(-1, c), wqkv_q_t.t()).float() * sqkv_eff
             + bqkv_eff).reshape(b, l, 3 * c)
    bias = relative_position_bias(table.float(), window)
    mask = shift_mask(resolution, window, shift, x.device)
    if mode == "bf16_scores":
        ctx = window_attention(*_windows_qkv(qkv_f.to(torch.bfloat16),
                                             resolution, window, shift,
                                             num_heads), bias, mask)
    else:
        q, k, v = _windows_qkv(qkv_f, resolution, window, shift, num_heads)
        s = _int8_product(round_clip_int8(q),
                          round_clip_int8(k).transpose(-1, -2)) * cs
        s = add_bias_mask(s, bias, mask)
        if mode == "int8_pv":
            p = torch.exp(s - s.amax(-1, keepdim=True))
            z = p.sum(-1, keepdim=True)
            pi = torch.round(p * 127.0).to(torch.int8)
            ctx = _int8_product(pi, round_clip_int8(v)) * cpv / z
        else:
            p = torch.softmax(s, dim=-1)
            ctx = torch.matmul(p.to(torch.bfloat16).float(),
                               v.to(torch.bfloat16).float()
                               ).to(torch.bfloat16)
    ctxq = round_clip_int8(_raster_ctx(ctx, resolution, window, shift)
                           .reshape(b * l, c).float())
    out = int_mm(ctxq, wo_q_t.t()).float() * so_eff + bo
    return (out.reshape(b, l, c) + xf).to(x.dtype)


def score_constant(cs) -> float:
    """The kernels' exp2-domain score constant: cs * log2(e) in f32, as JAX
    forms it from its f32 cs."""
    return float(torch.tensor(float(cs), dtype=torch.float32) * LOG2E)


def fused_swin_attn_block_int8(x: torch.Tensor, ln_scale_q: torch.Tensor,
                               ln_bias_q: torch.Tensor,
                               wqkv_q_t: torch.Tensor,
                               sqkv_eff: torch.Tensor,
                               bqkv_eff: torch.Tensor, wo_q_t: torch.Tensor,
                               so_eff: torch.Tensor, bo: torch.Tensor,
                               table: torch.Tensor, num_heads: int,
                               resolution: int, window: int, shift: int,
                               ln_eps: float = 1e-5, cs=None,
                               cpv=None) -> torch.Tensor:
    """w8a8 Swin attention half-block on the raster stream. CPU tensors run
    the plain version; CUDA tensors launch K5 in the mode of (cs, cpv), in
    the form of x's dtype (bf16 or f32 x, int8 matrices, f32 vectors and
    table: `k5_dtype_error`; contiguous, `k5_shape_error`'s geometry,
    forward only) or raise."""
    _check_geometry(x, num_heads, resolution, window, shift)
    mode = attn_mode(cs, cpv)
    got = _k5_got(x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff,
                  wo_q_t, so_eff, bo, table, num_heads, window)
    if x.device.type == "cpu":
        return swin_attn_block_int8_reference(
            x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff, wo_q_t,
            so_eff, bo, table, num_heads, resolution, window, shift, ln_eps,
            cs, cpv)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    mats = {k: got[k] for k in ("wqkv_q_t", "wo_q_t")}
    vecs = {k: v for k, v in got.items() if k not in mats}
    check_int8_kernel_args(x, mats, vecs, k5_dtype_error)
    err = k5_shape_error(x.shape[-1], num_heads, window, shift)
    if err:
        raise ValueError(err)
    bufs = k5_buffers(x, mode)
    lib, args = _k5_args(x, got, num_heads, resolution, window, shift, ln_eps,
                         cs, cpv, bufs)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_swin_attn_int8_parts(*args, 0, len(K5_PARTS) - 1,
                                             _stream(x.device))
    if rc != 0:
        raise RuntimeError(
            f"swin_attn_int8 kernel launch failed: CUDA error {rc}")
    fused_swin_attn_block_int8.launches += 1
    return bufs[3]


# K5's type rule on CUDA (`quant.int8_attn_dtype_rule`)
k5_dtype_error = int8_attn_dtype_rule("K5")


def _k5_got(x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff, wo_q_t,
            so_eff, bo, table, num_heads, window) -> dict:
    """K5's tensor arguments by name, their shapes and devices checked."""
    c = x.shape[-1]
    got = {"ln_scale_q": ln_scale_q, "ln_bias_q": ln_bias_q,
           "wqkv_q_t": wqkv_q_t, "sqkv_eff": sqkv_eff, "bqkv_eff": bqkv_eff,
           "wo_q_t": wo_q_t, "so_eff": so_eff, "bo": bo, "table": table}
    check_shapes({"ln_scale_q": (c,), "ln_bias_q": (c,),
                  "wqkv_q_t": (3 * c, c), "sqkv_eff": (3 * c,),
                  "bqkv_eff": (3 * c,), "wo_q_t": (c, c), "so_eff": (c,),
                  "bo": (c,), "table": ((2 * window - 1) ** 2, num_heads)},
                 got)
    check_devices(x, got)
    return got


def k5_buffers(x: torch.Tensor, mode: str = "int8_scores") -> tuple:
    """K5's scratch and output for x (B, L, C) in `mode`: what the QKV
    launch writes (`quant.qkv_buffers`), ctx8 (B*L, C) int8 (the
    LN-quant rows until the attention writes it) and out."""
    m, c = x.shape[0] * x.shape[1], x.shape[-1]
    return (*qkv_buffers(m, c, mode, x.device),
            torch.empty((m, c), dtype=torch.int8, device=x.device),
            torch.empty_like(x))


def _k5_args(x, got: dict, num_heads, resolution, window, shift, ln_eps, cs,
             cpv, bufs):
    """The library and K5's C arguments up to the form of x's dtype (but
    the launches and the stream) for a checked CUDA x and the (qk, v, ctx8,
    out) buffers `bufs` of the mode of (cs, cpv)."""
    from geovpr_torch.ops._build import library_on
    lib = library_on(x.device.index, "geovpr_swin_init")
    ptrs = [x] + list(got.values()) + list(bufs)
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("K5 reads its tensors by TMA and 16-byte loads: "
                         "each must start 16-byte aligned")
    c = x.shape[-1]
    return lib, (*(t.data_ptr() for t in ptrs), x.shape[0], resolution, c,
                 num_heads, window, shift, float(ln_eps),
                 *mode_constants(cs, cpv, None, c // num_heads,
                                 score_constant)[:4],
                 int(x.dtype == torch.float32))


K5_PARTS = ("ln_quant", "qkv_gemm", "attention", "out_proj")


def k5_launch_part(part: int, x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff,
                   bqkv_eff, wo_q_t, so_eff, bo, table, num_heads: int,
                   resolution: int, window: int, shift: int,
                   ln_eps: float = 1e-5, cs=None, cpv=None, *, bufs) -> None:
    """One of K5's four launches (an index into K5_PARTS) alone, in the
    mode of (cs, cpv), on the arguments of `fused_swin_attn_block_int8`
    (CUDA tensors it takes) and the `k5_buffers` of that mode `bufs`, whose
    contents from an earlier call it reads. chip_smoke.py times K5's
    launches one by one with it and the card tests check each against its
    plain version; it counts no launch."""
    got = _k5_got(x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff,
                  wo_q_t, so_eff, bo, table, num_heads, window)
    err = k5_shape_error(x.shape[-1], num_heads, window, shift)
    if err:
        raise ValueError(err)
    lib, args = _k5_args(x, got, num_heads, resolution, window, shift, ln_eps,
                         cs, cpv, bufs)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_swin_attn_int8_parts(*args, part, part,
                                             _stream(x.device))
    if rc != 0:
        raise RuntimeError(
            f"swin_attn_int8 kernel launch failed: CUDA error {rc}")


def swin_attention8_reference(qk, v, table, num_heads: int, resolution: int,
                              window: int, shift: int, cs, cpv=None):
    """Plain version of K5's attention launch: ctx8 (M, C) int8 from the
    raster (qk, v) of the QKV launch (`qkv_part_reference`) in the mode of
    (cs, cpv), with the softmax of JAX's kernel body
    (`_swin_attention_stages[_qk8]`, `pallas_swin_block.py:243-380`) and
    the bias and mask in the exp2 domain (times log2(e) in f32):
    - int8 scores: s = (q8 k8^T) cs log2(e), exact sums rounded once, +
      bias [+ mask]; p = exp2(min(s, 100)) with no max-shift, rounded to
      bf16 for P.V; the f32 row sum divides the context;
    - bf16 scores: s = f32(q k^T) of the bf16 q (scale folded in) and k,
      + bias [+ mask], then as int8 scores;
    - int8 P.V: s as int8 scores; p = exp2(s - max_j s); z the f32 sum of
      p; p rounded to 127ths, times the int8 v exactly: ctx = ci (cpv / z).
    The context is rounded once to int8."""
    mode = attn_mode(cs, cpv)
    c = qk.shape[-1] // (2 if mode == "int8_scores" else 3)
    m = qk.shape[0]
    b = m // (resolution * resolution)

    def heads(t):
        w = to_windows(t.reshape(b, m // b, -1), resolution, window, shift)
        bw, n, _ = w.shape
        return w.reshape(bw, n, num_heads, -1).transpose(1, 2)

    q, k = heads(qk[:, :c]), heads(qk[:, c:2 * c])
    bias2, mask2 = _log2_bias_mask(table, window, resolution, shift,
                                   qk.device)
    if mode == "bf16_scores":
        s = _mm(q, k.transpose(-1, -2))
    else:
        s = _exact_bmm(q, k.transpose(-1, -2)) * score_constant(cs)
    s = add_bias_mask(s, bias2, mask2)
    if mode == "int8_pv":
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        z = p.sum(-1, keepdim=True)
        pi = torch.round(p * 127.0).to(torch.int8)
        ctx = _exact_bmm(pi, heads(qk[:, 2 * c:])) * (cpv / z)
    else:
        p = torch.exp2(torch.clamp(s, max=100.0))
        vh = heads(qk[:, 2 * c:] if mode == "bf16_scores" else v)
        ctx = _mm(p.to(torch.bfloat16), vh) / p.sum(-1, keepdim=True)
    return round_clip_int8(_raster_ctx(ctx, resolution, window, shift)
                           .reshape(m, c))


fused_swin_attn_block_int8.launches = 0


# ------------------------------------------------------------ K9a/b/c ----
#
# The training half-block, y = proj(W-MSA(LN(x))) with no residual (the
# caller adds DropPath and the residual), and its structured backward: the
# port of `fused_swin_attn_train` (`pallas_swin_block.py:1400-1486`), its
# forward kernel `_swin_train_fwd_pallas` (K9a), the attention-core
# backward `_swin_attn_bwd_pallas` (K9b) and the all-in-one backward
# `_swin_attn_bwd_all_pallas` (K9c). The plain versions keep JAX's window
# form, (BW, N, C) windows with an (H, N, N) bias and an (nW, N, N) mask,
# and its rounding points (`_train_kernel`, `_train_bwd_kernel`,
# `_train_bwd_all_kernel`); the wrappers take the raster stream as K4 does,
# so the shifted blocks' partition and its inverse (JAX's `repartition` and
# `roll_relayout`, K10b) are the kernels' row addressing. On CUDA the
# residuals are qkv and ctx in raster order and p (BW, H, N, N). Each
# kernel has a bf16 form (`csrc/swin_train.cu`) and an f32 form for a Swin
# built with compute_dtype="float32" (K9a.f32 on K4.f32's launches in
# `csrc/f32_serving.cu`, K9b.f32 and K9c.f32 in `csrc/f32_train.cu`); the
# wrappers take the form of the stream's dtype (`k9_dtype_error`).

_TRAIN_WINDOW = 12          # the training kernels take N = 144


def _heads(t, num_heads):
    """(BW, N, H * dh) -> (BW, H, N, dh)."""
    bw, n, c = t.shape
    return t.reshape(bw, n, num_heads, c // num_heads).transpose(1, 2)


def _unheads(t):
    """(BW, H, N, dh) -> (BW * N, H * dh)."""
    bw, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(bw * n, h * dh)


def swin_attn_train_reference(xw, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                              bias, mask, num_heads: int,
                              ln_eps: float = 1e-5):
    """Plain K9a on windows: xw (BW, N, C), bias (H, N, N) and mask (nW, N,
    N) | None in the natural-log domain. Returns y (BW, N, C) and the
    residuals qkv (BW*N, 3C, post-bias, unscaled), ctx (BW*N, C) and the
    normalised probabilities p (BW, H, N, N), all in xw.dtype, rounded where
    `_train_kernel` rounds: the LN output, qkv, the scaled q (from the f32
    qkv), p after its normalisation by the reciprocal row sum, ctx, y."""
    bw, n, c = xw.shape
    dt = xw.dtype
    h = (layer_norm_f32(xw.float().reshape(bw * n, c), ln_eps)
         * ln_scale.float() + ln_bias.float()).to(dt)
    qkvf = _mm(h, wqkv) + bqkv.float()
    srow = torch.ones(3 * c, device=xw.device)
    srow[:c] = (c // num_heads) ** -0.5 * LOG2E
    qs = (qkvf * srow).to(dt).reshape(bw, n, 3 * c)
    q, k, v = (_heads(t, num_heads) for t in qs.split(c, dim=-1))
    s = add_bias_mask(_mm(q, k.transpose(-1, -2)), bias.float() * LOG2E,
                      None if mask is None else mask.float() * LOG2E)
    p = torch.exp2(torch.clamp(s, max=100.0))
    p = (p * (1.0 / p.sum(-1, keepdim=True))).to(dt)
    ctx = _unheads(_mm(p, v)).to(dt)
    y = (_mm(ctx, wo) + bo.float()).to(dt)
    return y.reshape(bw, n, c), qkvf.to(dt), ctx, p


def swin_attn_core_bwd_reference(qkv, p, da, num_heads: int):
    """Plain K9b: qkv (BW*N, 3C), p (BW, H, N, N), da (BW*N, C) in window
    order -> dqkv (BW*N, 3C) in qkv.dtype and dbias (H, N, N) f32, rounded
    as `_train_bwd_kernel`: ds * dh^-0.5 to the stream dtype before dq and
    dk, dq, dk, dv each once."""
    bw, _, n, _ = p.shape
    c = da.shape[-1]
    dt = qkv.dtype
    scale = (c // num_heads) ** -0.5
    q, k, v = (_heads(t.reshape(bw, n, c), num_heads)
               for t in qkv.split(c, dim=-1))
    dah = _heads(da.reshape(bw, n, c), num_heads)
    pf = p.float()
    dp = _mm(dah, v.transpose(-1, -2))
    ds = pf * (dp - (dp * pf).sum(-1, keepdim=True))
    dsb = (ds * scale).to(dt)
    dq = _mm(dsb, k).to(dt)
    dk = _mm(dsb.transpose(-1, -2), q).to(dt)
    dv = _mm(p.transpose(-1, -2), dah).to(dt)
    dqkv = torch.cat([_unheads(dq), _unheads(dk), _unheads(dv)], dim=-1)
    return dqkv, ds.sum(0)


def _ln_parts(x2d, ln_scale, ln_bias, ln_eps, dt):
    """f32 xhat, 1/std and the LN output rounded to dt."""
    xf = x2d.float()
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + ln_eps)
    xhat = (xf - mu) * rstd
    return xhat, rstd, (xhat * ln_scale.float() + ln_bias.float()).to(dt)


def bwd_product_reference(a, w):
    """Plain version of K9c's da = g Wo^T and dh = dqkv Wqkv^T launches:
    a (M, K) times the transpose of an (in, out) weight w (N, K), f32
    accumulation, rounded once to a's dtype."""
    return _mm(a, w.t()).to(a.dtype)


def weight_grad_reference(a, b, chunk: int | None = None):
    """Plain version of K9c's dWo = ctx^T g and dWqkv = h^T dqkv launches:
    a^T b in f32 over the rows of a (M, C) and b (M, N). With `chunk`, as
    the kernel sums: one f32 partial per `chunk` rows, the partials added
    in order (`wgrad_chunk` gives the kernel's chunk)."""
    if chunk is None:
        return _mm(a.t(), b)
    out = _mm(a[:chunk].t(), b[:chunk])
    for i in range(chunk, a.shape[0], chunk):
        out = out + _mm(a[i:i + chunk].t(), b[i:i + chunk])
    return out


def _split_rows(k: int, tiles: int) -> int:
    """`csrc/train_gemm.cuh::split_rows`: the rows of a chunk of a sum over
    k rows split for `tiles` output tiles, about 528 items, whole 32-row
    steps."""
    splits = max(1, min(-(-528 // tiles), -(-k // 32)))
    return -(-(-(-k // splits)) // 32) * 32


def wgrad_chunk(k: int, m: int, nc: int) -> int:
    """The rows of a chunk of K9c's weight gradient (M, Nc) summed over K
    rows: `split_rows` over its 64 x 64 output tiles."""
    return _split_rows(k, -(-m // 64) * -(-nc // 64))


def f32_wgrad_chunk(k: int, m: int, nc: int) -> int:
    """The same for the f32 forms K8c.f32 and K9c.f32
    (`csrc/f32_train.cu::f32_wgrad_split`): `split_rows` over the f32
    GEMM's 128 x 64 output tiles."""
    return _split_rows(k, -(-m // 128) * -(-nc // 64))


def ln_vjp_reference(dh, xhat, rstd, ln_scale):
    """Plain version of K9c's LN VJP launch: from dh (M, C) and the LN
    recompute's xhat and 1/std, dx (f32, before its rounding), dls and
    dlb."""
    dhf = dh.float()
    dxhat = dhf * ln_scale.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, (dhf * xhat).sum(0), dhf.sum(0)


def swin_attn_train_bwd_reference(xw, ln_scale, ln_bias, wqkv, wo, qkv, ctx,
                                  p, g, num_heads: int,
                                  ln_eps: float = 1e-5, split: bool = False):
    """The plain structured backward from the saved tensors (window form,
    as `swin_attn_train_reference` returns them; g (BW, N, C) the
    cotangent of y). Returns dx (BW, N, C) in xw.dtype, dls, dlb (f32),
    dwqkv, dwo (in the weights' dtype), dbqkv, dbo (f32) and dbias (H, N,
    N) f32. `split=False` is the all-in-one form (`_train_bwd_all_kernel`:
    the LN VJP written out); `split=True` the split form of the C > 512
    blocks (`_train_bwd_core`: the LN VJP by autograd of the LN). Both round
    da, the recomputed LN output, dqkv and dh to the stream dtype."""
    bw, n, c = xw.shape
    dt = xw.dtype
    m = bw * n
    gb = g.reshape(m, c).to(dt)
    da = bwd_product_reference(gb, wo)
    dwo = weight_grad_reference(ctx, gb)
    dbo = gb.float().sum(0)
    dqkv, dbias = swin_attn_core_bwd_reference(qkv, p, da, num_heads)
    x2d = xw.reshape(m, c)
    if split:
        with torch.enable_grad():
            xs, ls, lb = (t.detach().requires_grad_() for t in
                          (x2d, ln_scale, ln_bias))
            h = _ln_parts(xs, ls, lb, ln_eps, dt)[2]
            dh = bwd_product_reference(dqkv, wqkv)
            dx, dls, dlb = torch.autograd.grad(h, (xs, ls, lb), dh)
        h = h.detach()
    else:
        xhat, rstd, h = _ln_parts(x2d, ln_scale, ln_bias, ln_eps, dt)
        dx, dls, dlb = ln_vjp_reference(bwd_product_reference(dqkv, wqkv),
                                        xhat, rstd, ln_scale)
    dwqkv = weight_grad_reference(h, dqkv)
    dbqkv = dqkv.float().sum(0)
    return (dx.to(dt).reshape(bw, n, c), dls.float(), dlb.float(),
            dwqkv.to(wqkv.dtype), dbqkv, dwo.to(wo.dtype), dbo, dbias)


def _raster_to_rows(t, resolution, window, shift):
    """raster (B, L, W) -> window-order rows (BW*N, W)."""
    return to_windows(t, resolution, window, shift).reshape(-1, t.shape[-1])


def _rows_to_raster(t, resolution, window, shift):
    n = window * window
    return from_windows(t.reshape(-1, n, t.shape[-1]), resolution, window,
                        shift)


def k9_shape_error(c: int, num_heads: int, window: int,
                   shift: int) -> str | None:
    """The rule of K9's kernels (`csrc/swin_train.cu`: K9a's four launches,
    the core backward of K9b and K9c), or None where they take the shape:
    head dim 32, window 12 (N = 144: the attention's and the core's
    tiling), C a multiple of 64 up to 1024 (the LayerNorm holds a row in a
    warp's registers) and a shift of 0 or window // 2, Swin's own (a
    quarter window is one TMA box, so the cyclic shift never splits one).
    K9c also asks C <= 512 (`fused_swin_attn_bwd_all`)."""
    if (c % num_heads or c // num_heads != _KERNEL_HEAD_DIM
            or window != _TRAIN_WINDOW or c % 64 or c > 1024):
        return (f"the training kernels take head dim {_KERNEL_HEAD_DIM}, "
                f"window {_TRAIN_WINDOW} and C a multiple of 64 up to 1024, "
                f"got C={c}, {num_heads} heads, window {window}")
    if shift not in (0, window // 2):
        return (f"K9 takes a shift of 0 or window // 2 = {window // 2} (a "
                f"quarter window is one TMA box), got shift {shift}")
    return None


# the tensors of K9a-K9c that share one dtype: the stream, the matrices,
# the residuals and the gradients
_K9_STREAM = ("x", "wqkv", "wo", "qkv", "ctx", "p", "g", "da")


def k9_dtype_error(dtypes: dict) -> str | None:
    """The type rule of the training kernels K9a-K9c on CUDA (name -> dtype
    of the tensors a wrapper takes): the stream, matrices, residuals and
    gradients (`_K9_STREAM`) all bf16 (`csrc/swin_train.cu`) or all f32
    (K9a.f32 in `csrc/f32_serving.cu`, K9b.f32 and K9c.f32 in
    `csrc/f32_train.cu`), the vectors and the table f32. The message,
    naming the tensor that breaks the rule, or None where it holds
    (`quant.training_dtype_error`)."""
    return training_dtype_error("K9", dtypes, _K9_STREAM)


def _check_train_cuda(tensors: dict, c, num_heads, window, shift):
    """What the training kernels take on CUDA: contiguous and 16-byte
    aligned (TMA, float4 loads); `k9_dtype_error`'s types, the whole set
    at once; `k9_shape_error`'s geometry."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the "
                             f"training kernels read it by TMA and 16-byte "
                             f"loads)")
    err = k9_dtype_error({k: t.dtype for k, t in tensors.items()})
    if err:
        raise TypeError(err)
    err = k9_shape_error(c, num_heads, window, shift)
    if err:
        raise ValueError(err)


def _check_residuals(b, l, c, num_heads, resolution, window, shift,
                     tensors: dict) -> None:
    """The shapes of K9's residuals and gradients on a (B, L, C) stream
    (raise ValueError on any other): x, ctx, g and da (B, L, C), qkv (B,
    L, 3C), p (BW, H, N, N), the matrices and vectors of the block."""
    _check_geometry(torch.empty(b, l, c, device="meta"), num_heads,
                    resolution, window, shift)
    n = window * window
    want = {"x": (b, l, c), "ctx": (b, l, c), "g": (b, l, c),
            "da": (b, l, c), "qkv": (b, l, 3 * c),
            "p": (b * l // n, num_heads, n, n), "wqkv": (c, 3 * c),
            "wo": (c, c), "ln_scale": (c,), "ln_bias": (c,)}
    check_shapes({k: want[k] for k in tensors}, tensors)
    first = next(iter(tensors.values()))
    check_devices(first, tensors)


# the C entries of K9a-K9c by stream dtype, by role: the library's init
# (the shared-memory limits of that form), K9a whole and by launches, K9b,
# K9c whole and by launches, and the floats of the backward's scratch
_K9_ENTRIES = {
    torch.bfloat16: dict(
        init="geovpr_swin_train_init", fwd="geovpr_swin_train_fwd",
        fwd_parts="geovpr_swin_train_fwd_parts",
        core="geovpr_swin_train_bwd_core", all="geovpr_swin_train_bwd_all",
        all_parts="geovpr_swin_train_bwd_all_parts",
        scratch="geovpr_swin_train_scratch_floats"),
    torch.float32: dict(
        init="geovpr_f32_swin_train_init", fwd="geovpr_swin_f32_train_fwd",
        fwd_parts="geovpr_swin_f32_train_fwd_parts",
        core="geovpr_swin_f32_bwd_core", all="geovpr_swin_f32_bwd_all",
        all_parts="geovpr_swin_f32_bwd_all_parts",
        scratch="geovpr_swin_f32_scratch_floats")}


def _train_entries(device, dtype) -> dict:
    """The C entries of K9's form for a `dtype` stream (`_K9_ENTRIES`) by
    role, the form's init run on `device` first (once per device)."""
    from geovpr_torch.ops._build import library_on
    names = _K9_ENTRIES[dtype]
    lib = library_on(device.index, names["init"])
    return {role: getattr(lib, n) for role, n in names.items()
            if role != "init"}


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# K9a's launches, as `geovpr_swin_train_fwd_parts` numbers them
K9A_PARTS = ("layernorm", "qkv_gemm", "attention", "out_proj")


def train_ln_reference(x2d, ln_scale, ln_bias, ln_eps: float = 1e-5):
    """Plain version of K9a's LayerNorm launch: LN(x) * ln_scale + ln_bias
    of the rows x2d (M, C), in f32 with two-pass statistics, rounded to
    x2d's dtype."""
    return (layer_norm_f32(x2d.float(), ln_eps) * ln_scale.float()
            + ln_bias.float()).to(x2d.dtype)


def train_qkv_reference(h, wqkv, bqkv, num_heads: int):
    """Plain version of K9a's QKV launch: from the LN output h (M, C), qkv
    = h Wqkv + bqkv (M, 3C) unscaled and the scaled q copy (M, C), its
    first C columns times dh^-0.5 log2(e), each rounded once from the f32
    value to h's dtype."""
    c = h.shape[-1]
    qkvf = _mm(h, wqkv) + bqkv.float()
    qscale = torch.full((c,), (c // num_heads) ** -0.5 * LOG2E,
                        device=h.device)
    return qkvf.to(h.dtype), (qkvf[:, :c] * qscale).to(h.dtype)


def train_attention_reference(qs, qkv, table, num_heads: int,
                              resolution: int, window: int, shift: int):
    """Plain version of K9a's attention launch on the raster stream: from
    the scaled q copy qs (B, L, C) and qkv (B, L, 3C) (its k and v), ctx
    (B, L, C) and p (BW, H, N, N) in qs's dtype: scores + bias [+ mask] in
    the exp2 domain, p = exp2(min(s, 100)) times the reciprocal of its f32
    row sum, rounded, and ctx = p v rounded once."""
    dt = qs.dtype
    c = qs.shape[-1]
    q = _heads(to_windows(qs, resolution, window, shift), num_heads)
    k, v = (_heads(t, num_heads) for t in to_windows(
        qkv[..., c:], resolution, window, shift).split(c, dim=-1))
    mask = shift_mask(resolution, window, shift, qs.device)
    s = add_bias_mask(_mm(q, k.transpose(-1, -2)),
                      relative_position_bias(table.float(), window) * LOG2E,
                      None if mask is None else mask.float() * LOG2E)
    p = torch.exp2(torch.clamp(s, max=100.0))
    p = (p * (1.0 / p.sum(-1, keepdim=True))).to(dt)
    bw, _, n, _ = p.shape
    ctx = _unheads(_mm(p, v)).to(dt).reshape(bw, n, c)
    return from_windows(ctx, resolution, window, shift), p


def train_out_proj_reference(ctx2d, wo, bo):
    """Plain version of K9a's out projection launch: y = ctx Wo + bo (M, C),
    f32 accumulation, rounded once to ctx's dtype."""
    return (_mm(ctx2d, wo) + bo.float()).to(ctx2d.dtype)


def _train_plain_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, table,
                     num_heads, resolution, window, shift, ln_eps):
    xw = to_windows(x, resolution, window, shift)
    y, qkv, ctx, p = swin_attn_train_reference(
        xw, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
        relative_position_bias(table.float(), window),
        shift_mask(resolution, window, shift, x.device), num_heads, ln_eps)
    return (from_windows(y, resolution, window, shift),
            _rows_to_raster(qkv, resolution, window, shift),
            _rows_to_raster(ctx, resolution, window, shift), p)


def fused_swin_attn_train_fwd(x: torch.Tensor, ln_scale: torch.Tensor,
                              ln_bias: torch.Tensor, wqkv: torch.Tensor,
                              bqkv: torch.Tensor, wo: torch.Tensor,
                              bo: torch.Tensor, table: torch.Tensor,
                              num_heads: int, resolution: int, window: int,
                              shift: int, ln_eps: float = 1e-5):
    """K9a on the raster stream: y (B, L, C), qkv (B, L, 3C), ctx (B, L, C)
    and p (BW, H, N, N). CPU tensors run the plain version; CUDA tensors
    launch K9a or raise."""
    _check_geometry(x, num_heads, resolution, window, shift)
    b, l, c = x.shape
    got = {"ln_scale": ln_scale, "ln_bias": ln_bias, "wqkv": wqkv,
           "bqkv": bqkv, "wo": wo, "bo": bo, "table": table}
    check_shapes({"ln_scale": (c,), "ln_bias": (c,), "wqkv": (c, 3 * c),
                  "bqkv": (3 * c,), "wo": (c, c), "bo": (c,),
                  "table": ((2 * window - 1) ** 2, num_heads)}, got)
    check_devices(x, got)
    if x.device.type == "cpu":
        return _train_plain_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                table, num_heads, resolution, window, shift,
                                ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_train_cuda({"x": x, **got}, c, num_heads, window, shift)
    bufs = k9a_buffers(x, num_heads, window)
    entries, args = _k9a_args(x, got, num_heads, resolution, window, shift,
                              ln_eps, bufs)
    with torch.cuda.device(x.device):
        rc = entries["fwd"](*args, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"swin_train_fwd launch failed: CUDA error {rc}")
    fused_swin_attn_train_fwd.launches += 1
    return bufs["y"], bufs["qkv"], bufs["ctx"], bufs["p"]


def k9a_buffers(x: torch.Tensor, num_heads: int, window: int) -> dict:
    """K9a's outputs and scratch for a (B, L, C) stream x (bf16 or f32), by
    name: qkv, ctx (the LN output until the attention writes ctx), p and y;
    for a bf16 stream also qs, the scaled q copy (the f32 form's attention
    scales q as it reads it, the same f32 product)."""
    b, l, c = x.shape
    n = window * window

    def buf(*shape):
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    bufs = dict(qkv=buf(b, l, 3 * c), ctx=buf(b, l, c),
                p=buf(b * l // n, num_heads, n, n), y=buf(b, l, c))
    if x.dtype == torch.bfloat16:
        bufs["qs"] = buf(b, l, c)
    return bufs


def _k9a_args(x, got: dict, num_heads, resolution, window, shift, ln_eps,
              bufs: dict):
    """K9a's C entries (`_train_entries`) and C arguments (but the first
    and last launch and the stream) for checked CUDA tensors and
    `k9a_buffers` `bufs`."""
    outs = ("qkv", "qs", "ctx", "p", "y") if "qs" in bufs else (
        "qkv", "ctx", "p", "y")
    ptrs = [x] + [got[k] for k in ("ln_scale", "ln_bias", "wqkv", "bqkv",
                                   "wo", "bo", "table")] + [
        bufs[k] for k in outs]
    c = x.shape[-1]
    qscale = (c // num_heads) ** -0.5 * LOG2E
    return _train_entries(x.device, x.dtype), (
        *(t.data_ptr() for t in ptrs), x.shape[0], resolution, c, num_heads,
        window, shift, float(ln_eps), float(qscale))


def k9a_launch_part(part: int, x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                    table, num_heads: int, resolution: int, window: int,
                    shift: int, ln_eps: float = 1e-5, *, bufs) -> None:
    """One of K9a's four launches (an index into K9A_PARTS) alone, on the
    CUDA arguments of `fused_swin_attn_train_fwd` and the `k9a_buffers`
    `bufs`, whose contents from an earlier call it reads. chip_smoke.py
    times K9a's launches one by one with it and the card tests check each
    against its plain part; it counts no launch."""
    got = {"ln_scale": ln_scale, "ln_bias": ln_bias, "wqkv": wqkv,
           "bqkv": bqkv, "wo": wo, "bo": bo, "table": table}
    _check_train_cuda({"x": x, **got}, x.shape[-1], num_heads, window, shift)
    entries, args = _k9a_args(x, got, num_heads, resolution, window, shift,
                              ln_eps, bufs)
    with torch.cuda.device(x.device):
        rc = entries["fwd_parts"](*args, part, part, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"swin_train_fwd launch failed: CUDA error {rc}")


fused_swin_attn_train_fwd.launches = 0


def _train_scratch(entries, b, resolution, c, num_heads, window, device):
    """The f32 scratch K9b and K9c take (`part`): their partial sums; in
    the f32 form also the core's ds plane (BW, H, N, N)."""
    floats = entries["scratch"](b, resolution, c, num_heads, window)
    return torch.empty(floats, dtype=torch.float32, device=device)


def fused_swin_attn_bwd_core(qkv: torch.Tensor, p: torch.Tensor,
                             da: torch.Tensor, num_heads: int,
                             resolution: int, window: int, shift: int):
    """K9b on raster residuals: qkv (B, L, 3C), p (BW, H, N, N), da (B, L,
    C) -> dqkv (B, L, 3C), dbias (H, N, N) f32. CPU tensors run the plain
    version; CUDA tensors launch K9b (all bf16 or all f32,
    `k9_dtype_error`) or raise."""
    b, l, c3 = qkv.shape
    c = c3 // 3
    _check_residuals(b, l, c, num_heads, resolution, window, shift,
                     {"qkv": qkv, "p": p, "da": da})
    if qkv.device.type == "cpu":
        dqkv, dbias = swin_attn_core_bwd_reference(
            _raster_to_rows(qkv, resolution, window, shift), p,
            _raster_to_rows(da, resolution, window, shift), num_heads)
        return _rows_to_raster(dqkv, resolution, window, shift), dbias
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    _check_train_cuda({"qkv": qkv, "p": p, "da": da}, c, num_heads, window,
                      shift)
    entries = _train_entries(qkv.device, qkv.dtype)
    n = window * window
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((num_heads, n, n), dtype=torch.float32,
                        device=qkv.device)
    part = _train_scratch(entries, b, resolution, c, num_heads, window,
                          qkv.device)
    with torch.cuda.device(qkv.device):
        rc = entries["core"](
            qkv.data_ptr(), p.data_ptr(), da.data_ptr(), dqkv.data_ptr(),
            part.data_ptr(), dbias.data_ptr(), b, resolution, c, num_heads,
            window, shift, float((c // num_heads) ** -0.5),
            _stream(qkv.device))
    if rc != 0:
        raise RuntimeError(f"swin_train_bwd_core launch failed: CUDA error "
                           f"{rc}")
    fused_swin_attn_bwd_core.launches += 1
    return dqkv, dbias


fused_swin_attn_bwd_core.launches = 0


def _train_plain_bwd(x, ln_scale, ln_bias, wqkv, wo, qkv, ctx, p, g,
                     num_heads, resolution, window, shift, ln_eps, split):
    def rows(t):
        return _raster_to_rows(t, resolution, window, shift)

    out = swin_attn_train_bwd_reference(
        to_windows(x, resolution, window, shift), ln_scale, ln_bias, wqkv,
        wo, rows(qkv), rows(ctx), p, rows(g), num_heads, ln_eps, split)
    return (from_windows(out[0], resolution, window, shift),) + out[1:]


def fused_swin_attn_bwd_all(x, ln_scale, ln_bias, wqkv, wo, qkv, ctx, p, g,
                            num_heads: int, resolution: int, window: int,
                            shift: int, ln_eps: float = 1e-5):
    """K9c on the raster stream: the whole attention-half backward from
    K9a's residuals and g = dL/dy (B, L, C). Returns dx (B, L, C), dls,
    dlb, dwqkv, dbqkv, dwo, dbo (f32) and dbias (H, N, N) f32. CPU tensors
    run the plain all-in-one form; CUDA tensors launch K9c (C <= 512; all
    bf16 or all f32, `k9_dtype_error`) or raise."""
    b, l, c = x.shape
    _check_residuals(b, l, c, num_heads, resolution, window, shift, {
        "x": x, "ln_scale": ln_scale, "ln_bias": ln_bias, "wqkv": wqkv,
        "wo": wo, "qkv": qkv, "ctx": ctx, "p": p, "g": g})
    if x.device.type == "cpu":
        out = _train_plain_bwd(x, ln_scale, ln_bias, wqkv, wo, qkv, ctx, p,
                               g, num_heads, resolution, window, shift,
                               ln_eps, split=False)
        return out[:3] + (out[3].float(), out[4], out[5].float()) + out[6:]
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_train_cuda({"x": x, "ln_scale": ln_scale, "ln_bias": ln_bias,
                       "wqkv": wqkv, "wo": wo, "qkv": qkv, "ctx": ctx,
                       "p": p, "g": g}, c, num_heads, window, shift)
    if c > 512:
        raise ValueError(f"K9c takes C <= 512 (the split backward with K9b "
                         f"takes the wider blocks), got C={c}")
    bufs = k9c_buffers(x, num_heads, resolution, window)
    entries, args = _k9c_args(x, ln_scale, ln_bias, wqkv, wo, qkv, ctx, p, g,
                              num_heads, resolution, window, shift, ln_eps,
                              bufs)
    with torch.cuda.device(x.device):
        rc = entries["all"](*args, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"swin_train_bwd_all launch failed: CUDA error "
                           f"{rc}")
    fused_swin_attn_bwd_all.launches += 1
    return tuple(bufs[k] for k in _K9C_OUTS)


# K9c's launches, as `geovpr_swin_train_bwd_all_parts` numbers them (a
# product's reduce of its partial sums runs with it)
K9C_PARTS = ("da", "dwo", "dbo", "core", "ln_rows", "dwqkv", "dbqkv", "dh",
             "ln_vjp")
_K9C_OUTS = ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo", "dbias")


def k9c_buffers(x: torch.Tensor, num_heads: int, resolution: int,
                window: int) -> dict:
    """K9c's scratch and outputs for a CUDA stream x (B, L, C), bf16 or
    f32, by name: da (dh once the dh launch has run), h, dqkv, stats, part
    and the outputs `fused_swin_attn_bwd_all` returns."""
    b, l, c = x.shape
    n = window * window
    entries = _train_entries(x.device, x.dtype)
    dev = x.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return dict(
        da=torch.empty_like(x), h=torch.empty_like(x), dx=torch.empty_like(x),
        dqkv=torch.empty((b, l, 3 * c), dtype=x.dtype, device=dev),
        stats=f32(b * l, 2),
        part=_train_scratch(entries, b, resolution, c, num_heads, window,
                            dev),
        dwqkv=f32(c, 3 * c), dbqkv=f32(3 * c), dwo=f32(c, c), dbo=f32(c),
        dbias=f32(num_heads, n, n), dls=f32(c), dlb=f32(c))


def _k9c_args(x, ln_scale, ln_bias, wqkv, wo, qkv, ctx, p, g, num_heads,
              resolution, window, shift, ln_eps, bufs: dict):
    """K9c's C entries (`_train_entries`) and C arguments (but the first
    and last launch and the stream) for checked CUDA tensors and
    `k9c_buffers` `bufs`."""
    ptrs = [x, qkv, p, ctx, g, wqkv, wo, ln_scale, ln_bias] + [
        bufs[k] for k in ("da", "dqkv", "h", "stats", "part", "dx", "dwqkv",
                          "dbqkv", "dwo", "dbo", "dbias", "dls", "dlb")]
    c = x.shape[-1]
    return _train_entries(x.device, x.dtype), (
        *(t.data_ptr() for t in ptrs), x.shape[0], resolution, c, num_heads,
        window, shift, float(ln_eps), float((c // num_heads) ** -0.5))


def k9c_launch_part(part: int, x, ln_scale, ln_bias, wqkv, wo, qkv, ctx, p,
                    g, num_heads: int, resolution: int, window: int,
                    shift: int, ln_eps: float = 1e-5, *, bufs) -> None:
    """One of K9c's launches (an index into K9C_PARTS, with the reduce of
    its partial sums) alone, on the CUDA arguments of
    `fused_swin_attn_bwd_all` and the `k9c_buffers` `bufs`, whose contents
    from an earlier call it reads. chip_smoke.py times K9c's launches one
    by one with it and the card tests check each against its plain part;
    it counts no launch."""
    entries, args = _k9c_args(x, ln_scale, ln_bias, wqkv, wo, qkv, ctx, p, g,
                              num_heads, resolution, window, shift, ln_eps,
                              bufs)
    with torch.cuda.device(x.device):
        rc = entries["all_parts"](*args, part, part, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"swin_train_bwd_all launch failed: CUDA error "
                           f"{rc}")


fused_swin_attn_bwd_all.launches = 0


def swin_attn_train_bwd_split(x, ln_scale, ln_bias, wqkv, wo, qkv, ctx, p,
                              g, num_heads: int, resolution: int,
                              window: int, shift: int, ln_eps: float = 1e-5):
    """The split backward of the C > 512 blocks (`_train_bwd_core`'s else
    branch): da, dWo, dbo, the LN recompute and VJP, dWqkv, dbqkv and dh as
    torch ops (products in the stream dtype with f32 accumulation, as JAX
    leaves them to XLA; f32 ones in full f32, torch's default) around K9b
    (`fused_swin_attn_bwd_core`). Same returns as
    `fused_swin_attn_bwd_all`."""
    b, l, c = x.shape
    dt = x.dtype
    gb = g.reshape(b * l, c)
    da = _proj(gb, wo.t().contiguous()).to(dt).reshape(b, l, c)
    dqkv, dbias = fused_swin_attn_bwd_core(qkv, p, da, num_heads, resolution,
                                           window, shift)
    dwo = _proj(ctx.reshape(-1, c).t().contiguous(), gb)
    dbo = gb.float().sum(0)
    dq2 = dqkv.reshape(-1, 3 * c)
    with torch.enable_grad():
        xs, ls, lb = (t.detach().requires_grad_() for t in
                      (x.reshape(-1, c), ln_scale, ln_bias))
        h = _ln_parts(xs, ls, lb, ln_eps, dt)[2]
        dh = _proj(dq2, wqkv.t().contiguous()).to(dt)
        dx, dls, dlb = torch.autograd.grad(h, (xs, ls, lb), dh)
    dwqkv = _proj(h.detach().t().contiguous(), dq2)
    return (dx.to(dt).reshape(b, l, c), dls, dlb, dwqkv,
            dq2.float().sum(0), dwo, dbo, dbias)


@functools.lru_cache(maxsize=None)
def _table_positions(window: int, device: torch.device) -> torch.Tensor:
    """(T^2, w^2): for each entry of the ((2w-1)^2, H) table the flat (i, j)
    positions of the (N, N) bias that read it, padded with N^2 (a zero
    row)."""
    n = window * window
    idx = relative_position_index(window).reshape(-1)
    t2 = (2 * window - 1) ** 2
    pos = np.full((t2, n), n * n, np.int64)
    for e in range(t2):
        where = np.flatnonzero(idx == e)
        pos[e, :where.size] = where
    with torch.inference_mode(False), torch.no_grad():
        return torch.from_numpy(pos).to(device)


def table_grad(dbias: torch.Tensor, window: int) -> torch.Tensor:
    """The relative-position table's gradient from the bias's, dbias (H, N,
    N) -> ((2w-1)^2, H): the VJP of the gather `relative_position_bias`,
    summed in a fixed order (a padded gather and a sum, no atomics), so
    that a step repeats bit for bit."""
    h = dbias.shape[0]
    flat = torch.cat([dbias.reshape(h, -1).t(),
                      dbias.new_zeros(1, h)])
    return flat[_table_positions(window, dbias.device)].sum(1)


class _SwinAttnTrain(torch.autograd.Function):
    """K9a forward, K9c (C <= 512) or the split backward with K9b (wider)
    backward, as `_bwd_fused_ok` routes (`pallas_swin_block.py:771-780`);
    `kernels=False` runs the plain versions on any device."""

    @staticmethod
    def forward(ctx_, x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, table,
                num_heads, resolution, window, shift, ln_eps, kernels):
        fwd = fused_swin_attn_train_fwd if kernels else _train_plain_fwd
        y, qkv, ctx, p = fwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, table,
                             num_heads, resolution, window, shift, ln_eps)
        ctx_.save_for_backward(x, ln_scale, ln_bias, wqkv, wo, table, qkv,
                               ctx, p)
        ctx_.geom = (num_heads, resolution, window, shift, ln_eps)
        ctx_.kernels = kernels
        return y

    @staticmethod
    def backward(ctx_, gy):
        x, ln_scale, ln_bias, wqkv, wo, table, qkv, ctx, p = \
            ctx_.saved_tensors
        num_heads, resolution, window, shift, ln_eps = ctx_.geom
        g = gy.to(x.dtype).contiguous()
        args = (x, ln_scale, ln_bias, wqkv, wo, qkv, ctx, p, g, num_heads,
                resolution, window, shift, ln_eps)
        split = x.shape[-1] > 512
        if not ctx_.kernels:
            out = _train_plain_bwd(*args, split=split)
        elif split:
            out = swin_attn_train_bwd_split(*args)
        else:
            out = fused_swin_attn_bwd_all(*args)
        dx, dls, dlb, dwqkv, dbqkv, dwo, dbo, dbias = out
        dtable = table_grad(dbias, window).to(table.dtype)
        return (dx, dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype),
                dwqkv.to(wqkv.dtype), dbqkv, dwo.to(wo.dtype), dbo, dtable,
                None, None, None, None, None, None)


def fused_swin_attn_train(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, table,
                          num_heads: int, resolution: int, window: int,
                          shift: int, ln_eps: float = 1e-5,
                          kernels: bool = True) -> torch.Tensor:
    """The differentiable training half-block on the raster stream:
    y = proj(W-MSA(LN(x))) (B, L, C), no residual. The gradients of the
    matrices come back in their own dtype, as JAX's `.astype(wqkv.dtype)`
    (`pallas_swin_block.py:1448-1451`); the table's is dbias gathered back
    through the relative-position index. On CUDA tensors K9a/K9b/K9c launch
    or raise; `kernels=False` takes the plain versions on any device."""
    return _SwinAttnTrain.apply(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                table, num_heads, resolution, window, shift,
                                ln_eps, kernels)
