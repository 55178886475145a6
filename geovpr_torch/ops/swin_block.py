"""Fused Swin attention half-blocks and their plain versions: kernel K4
(bf16) and kernel K5 (w8a8).

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
`geovpr_torch/csrc/swin_attn.cu` or raise; on a CPU tensor they run the
plain versions, which round where the JAX kernels round (`_kernel`,
`_kernel_int8`, `pallas_swin_block.py:418-517`):
- q carries dh^-0.5 * log2(e) from the f32 qkv, before its rounding;
- scores, bias and mask are in the exp2 domain; the softmax is the serving
  one, p = exp2(min(s, 100)) with no max-shift (`_SKIP_MAX`), P rounded to
  the compute dtype for P.V, the f32 row sum dividing the context.
"""

from __future__ import annotations

import math

import torch

from geovpr_torch.ops.quant import (check_devices, check_int8_kernel_args,
                                    check_shapes, int_mm, layer_norm_f32,
                                    round_clip_int8)
from geovpr_torch.ops.window_attention import (add_bias_mask, from_windows,
                                               relative_position_bias,
                                               shift_mask, to_windows,
                                               window_attention)

LOG2E = math.log2(math.e)
_KERNEL_HEAD_DIM = 32


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with f32 accumulation and an f32 result for any input dtype."""
    return torch.matmul(a.float(), b.float())


def _proj(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) with f32 accumulation and an f32 result, as JAX's
    `jnp.dot(..., preferred_element_type=jnp.float32)`: bf16 operands on a
    CUDA device go to cuBLAS's tensor cores with an f32 output
    (`torch.mm(..., out_dtype=torch.float32)`), anything else to an f32
    matmul."""
    if a.is_cuda and a.dtype == w.dtype == torch.bfloat16:
        out = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], w.shape[-1])
    return _mm(a, w)


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


def _windows_qkv(qkv, resolution, window, shift, num_heads):
    """(B, L, 3C) raster -> q, k, v each (BW, H, N, dh) in window order."""
    c = qkv.shape[-1] // 3
    w = to_windows(qkv, resolution, window, shift)
    bw, n, _ = w.shape
    return [t.reshape(bw, n, num_heads, c // num_heads).transpose(1, 2)
            for t in w.split(c, dim=-1)]


def _raster_ctx(ctx, resolution, window, shift):
    """(BW, H, N, dh) -> raster (B, L, C)."""
    bw, h, n, dh = ctx.shape
    return from_windows(ctx.transpose(1, 2).reshape(bw, n, h * dh),
                        resolution, window, shift)


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
                            calib: dict | None = None,
                            attention=window_attention):
    """The JAX package's unfused path (`SwinBlock` without the fused kernel,
    `geovpr/models/swin.py:559-584`): LN, the q/k/v projections (f32
    accumulation) rounded to x.dtype, `attention` on the (BW, H, N, dh)
    windows, the out projection rounded to x.dtype, the residual added in
    x.dtype. `attention` is `window_attention` (JAX's XLA path: scaled
    scores, max-shifted softmax) for calibration, or on the window-7 serving
    path `window_attention_kernel` (K7, JAX's `use_pallas=True`) or its
    plain version. With `calib` (a dict) it records the amaxes the int8
    calibration reads, at the points JAX sows them: `attn_x` the LN output,
    `attn_q/k/v` the projections, `attn_ctx` the context before the out
    projection."""
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
    q, k, v = (t.contiguous() for t in
               _windows_qkv(qkv, resolution, window, shift, num_heads))
    ctx = attention(q, k, v,
                    relative_position_bias(table, window).contiguous(),
                    shift_mask(resolution, window, shift, x.device))
    ctx = _raster_ctx(ctx, resolution, window, shift)
    if calib is not None:
        amax_into(calib, "attn_ctx", ctx)
    return x + (_proj(ctx, wo) + bo.float()).to(dt)


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


def _kernel_geometry_ok(c, num_heads, window):
    n = window * window
    if c // num_heads != _KERNEL_HEAD_DIM or not fused_window_ok(window):
        raise ValueError(
            f"the kernel takes head dim {_KERNEL_HEAD_DIM} and windows of "
            f"16..256 tokens in multiples of 16, got C={c}, {num_heads} "
            f"heads, window {window} (N={n}; other windows take the unfused "
            f"half around K7, `swin_attn_block_unfused`)")


def fused_window_ok(window: int) -> bool:
    """Which attention half a Swin block takes: the fused half-block (K4,
    K5) for windows of N = window**2 tokens in multiples of 16 up to 256,
    the unfused half around K7 (`swin_attn_block_unfused` with
    `window_attention_kernel`) otherwise, e.g. window 7 (N = 49). The JAX
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
    plain version; CUDA tensors launch K4 (bf16 x and matrices, f32
    vectors and table, contiguous, head dim 32, forward only) or raise."""
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
            "fused_swin_attn_block has no backward kernel yet (K9 in ROADMAP "
            "Queue 2); run the forward under torch.inference_mode()")
    for name, t in (("x", x), ("wqkv", wqkv), ("wo", wo)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
    for name in ("ln_scale", "ln_bias", "bqkv", "bo", "table"):
        if got[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {got[name].dtype}")
    _kernel_geometry_ok(c, num_heads, window)

    from geovpr_torch.ops._build import library_on
    lib = library_on(x.device.index, "geovpr_swin_init")
    m = b * l
    qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=x.device)
    ctx = torch.empty((m, c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    qscale = (c // num_heads) ** -0.5 * LOG2E
    with torch.cuda.device(x.device):
        rc = lib.geovpr_swin_attn_bf16(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            table.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(),
            b, resolution, c, num_heads, window, shift, float(ln_eps),
            float(qscale), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"swin_attn kernel launch failed: CUDA error {rc}")
    fused_swin_attn_block.launches += 1
    return out


fused_swin_attn_block.launches = 0


# ------------------------------------------------------------------- K5 ----
#
# The w8a8 half-block, on the arguments `SwinBlock`'s int8 fold produces
# (the port of `geovpr/models/swin.py:588-629`; no LayerScale). `cs` is the
# natural-log score constant a_q a_k dh^-0.5; the kernel works in the exp2
# domain and the wrapper passes cs * log2(e), the factor JAX's caller
# applies (`swin.py:654`).

def swin_attn_block_int8_reference(x, ln_scale_q, ln_bias_q, wqkv_q_t,
                                   sqkv_eff, bqkv_eff, wo_q_t, so_eff, bo,
                                   table, num_heads: int, resolution: int,
                                   window: int, shift: int,
                                   ln_eps: float = 1e-5, cs=None, cpv=None):
    """Plain PyTorch version of K5 in all three modes of the JAX fallback
    `SwinBlock._attention_int8` (`geovpr/models/swin.py:662-729`): `cs`
    given (int8 q.k^T, bf16 P.V; the default), `cs` and `cpv` given (int8
    P.V on max-shifted probabilities in 127ths), `cs` None (bf16 scores).
    The default mode rounds where the kernel and the JAX kernel body
    (`_swin_attention_stages_qk8`) do: exp2(min(s cs log2(e) + bias +
    mask, 100)) with no max-shift, P rounded to bf16, the f32 sum dividing
    the context, which is rounded to int8 once. The fallback differs there
    (normalised softmax, and the context rounded to bf16 before int8); the
    other two modes keep the fallback's arithmetic."""
    b, l, c = x.shape
    xf = x.float()
    xq = round_clip_int8(layer_norm_f32(xf, ln_eps) * ln_scale_q + ln_bias_q)
    yi = int_mm(xq.reshape(-1, c), wqkv_q_t.t())
    qkv_f = (yi.float() * sqkv_eff + bqkv_eff).reshape(b, l, 3 * c)
    bias = relative_position_bias(table.float(), window)
    mask = shift_mask(resolution, window, shift, x.device)

    def windows(t):
        return _windows_qkv(t, resolution, window, shift, num_heads)

    if cs is None:
        ctx = window_attention(*windows(qkv_f.to(torch.bfloat16)), bias,
                               mask).float()
    else:
        q8, k8, v8 = windows(round_clip_int8(qkv_f))
        si = _exact_bmm(q8, k8.transpose(-1, -2))
        if cpv is None:
            bias2, mask2 = _log2_bias_mask(table, window, resolution, shift,
                                           x.device)
            s = add_bias_mask(si * score_constant(cs), bias2, mask2)
            p = torch.exp2(torch.clamp(s, max=100.0))
            v = windows(qkv_f.to(torch.bfloat16))[2]
            ctx = _mm(p.to(torch.bfloat16), v) / p.sum(-1, keepdim=True)
        else:
            s = add_bias_mask(si * cs, bias, mask)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            z = p.sum(-1, keepdim=True)
            pi = torch.round(p * 127.0).to(torch.int8)
            ctx = _exact_bmm(pi, v8) * cpv / z
    ctxq = round_clip_int8(_raster_ctx(ctx, resolution, window, shift)
                           .reshape(b * l, c))
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
    the plain version in any mode; CUDA tensors launch K5 (int8 scores with
    `cs` given, bf16 P.V; bf16 x, int8 matrices, f32 vectors and table,
    contiguous, head dim 32, C a multiple of 64 up to 1024, forward only)
    or raise, also on the two modes the kernel does not take (`cs` None,
    or `cpv` given)."""
    _check_geometry(x, num_heads, resolution, window, shift)
    b, l, c = x.shape
    got = {"ln_scale_q": ln_scale_q, "ln_bias_q": ln_bias_q,
           "wqkv_q_t": wqkv_q_t, "sqkv_eff": sqkv_eff, "bqkv_eff": bqkv_eff,
           "wo_q_t": wo_q_t, "so_eff": so_eff, "bo": bo, "table": table}
    check_shapes({"ln_scale_q": (c,), "ln_bias_q": (c,),
                  "wqkv_q_t": (3 * c, c), "sqkv_eff": (3 * c,),
                  "bqkv_eff": (3 * c,), "wo_q_t": (c, c), "so_eff": (c,),
                  "bo": (c,), "table": ((2 * window - 1) ** 2, num_heads)},
                 got)
    check_devices(x, got)
    if x.device.type == "cpu":
        return swin_attn_block_int8_reference(
            x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff, wo_q_t,
            so_eff, bo, table, num_heads, resolution, window, shift, ln_eps,
            cs, cpv)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if cs is None or cpv is not None:
        raise NotImplementedError(
            "the K5 kernel takes only the default mode (int8 scores, bf16 "
            "P.V): cs=None and the int8-P.V mode are still to port (ROADMAP)")
    mats = {k: got[k] for k in ("wqkv_q_t", "wo_q_t")}
    vecs = {k: v for k, v in got.items() if k not in mats}
    check_int8_kernel_args(x, mats, vecs)
    _kernel_geometry_ok(c, num_heads, window)
    if c % 64 or c > 1024:
        raise ValueError(f"the kernel takes C a multiple of 64 up to 1024, "
                         f"got C={c}")

    from geovpr_torch.ops._build import library_on
    lib = library_on(x.device.index, "geovpr_swin_init")
    m = b * l
    qk8 = torch.empty((m, 2 * c), dtype=torch.int8, device=x.device)
    v = torch.empty((m, c), dtype=torch.bfloat16, device=x.device)
    ctx8 = torch.empty((m, c), dtype=torch.int8, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_swin_attn_int8(
            x.data_ptr(), ln_scale_q.data_ptr(), ln_bias_q.data_ptr(),
            wqkv_q_t.data_ptr(), sqkv_eff.data_ptr(), bqkv_eff.data_ptr(),
            wo_q_t.data_ptr(), so_eff.data_ptr(), bo.data_ptr(),
            table.data_ptr(), qk8.data_ptr(), v.data_ptr(), ctx8.data_ptr(),
            out.data_ptr(), b, resolution, c, num_heads, window, shift,
            float(ln_eps), score_constant(cs),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"swin_attn_int8 kernel launch failed: CUDA error {rc}")
    fused_swin_attn_block_int8.launches += 1
    return out


fused_swin_attn_block_int8.launches = 0
