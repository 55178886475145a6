"""Windowed multi-head attention, plain and unfused (the port of
`geovpr/ops/window_attention.py:28-50`), and the Swin window geometry it
runs on (`geovpr/models/swin.py:75-130`).

The port keeps the Swin token stream in raster (B, L, C) order. Only the
attention step needs to know which `window**2` rows form a window: here
`to_windows`/`from_windows` gather them (with the cyclic shift of SW-MSA)
into (B*nW, N, C) windows and back; the kernels K4/K5
(`geovpr_torch/csrc/swin_attn.cu`) and K7's raster entry do the same by
address arithmetic.

`window_attention` is the JAX package's XLA path (scaled scores, bias,
mask, max-shifted softmax, P.V with P rounded to v's dtype): the Swin
calibration pass runs it, as the JAX calibration pass does.

Kernel K7, the port of
`geovpr/ops/pallas_window_attention.py::window_attention_pallas`, has two
entries, two address modes of one hand-written Hopper kernel
(`geovpr_torch/csrc/window_attn.cu`):
- `window_attention_raster(qkv, table, num_heads, resolution, window,
  shift)`, the window-7 serving path's: the unfused half's raster qkv (B,
  L, 3C) in, the raster context (B, L, C) out, the window partition and the
  cyclic shift folded into the kernel's addressing, the bias taken from the
  relative-position table and the shift mask from the geometry. Its plain
  version, `window_attention_raster_reference`, gathers the windows
  (`_windows_qkv`), runs `window_attention_serving_reference` and scatters
  the context back (`_raster_ctx`).
- `window_attention_kernel(q, k, v, bias, mask)`, with JAX's operands and
  result: (BW, H, N, dh) q, k, v in, the same out, bias (H, N, N), mask
  (nW, N, N) or None.
On a CUDA tensor each launches the kernel or raises (bf16 operands; f32
operands, for a model built with compute_dtype="float32", launch the f32
form of both modes in `geovpr_torch/csrc/f32_serving.cu`); on a CPU tensor
each runs its plain version, which rounds where the JAX kernel body
`_kernel` rounds (serving softmax, `_SKIP_MAX`).

K7's gradient is JAX's `custom_vjp` (`pallas_window_attention.py:182-207`):
on CUDA each entry is a `torch.autograd.Function` whose forward is the
kernel and whose backward is the VJP of the plain `window_attention`
(JAX's `_window_attention_xla`: scaled scores, max-shifted softmax),
recomputed on the saved operands: q, k, v, bias and the mask for the
split entry; the raster qkv and the table, through the window gather and
the bias gather, for the raster entry. No training path of the port runs
it: JAX trains window 7 on its XLA route (`geovpr/models/swin.py:389-391`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from geovpr_torch.ops.quant import serving_dtype_error

LOG2E = math.log2(math.e)
_KERNEL_HEAD_DIM = 32
_KERNEL_MAX_N = 256
_RASTER_MAX_N = 144


def relative_position_index(window: int) -> np.ndarray:
    """Standard Swin (2w-1)^2 relative-position index table, (N, N) int32:
    idx[i, j] = (y_i - y_j + w - 1) * (2w - 1) + (x_i - x_j + w - 1)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))  # (2, w, w)
    flat = coords.reshape(2, -1)                    # (2, N)
    rel = flat[:, :, None] - flat[:, None, :]       # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)   # (N, N, 2)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).astype(np.int32)


def shifted_window_labels(h: int, w: int, window: int,
                          shift: int) -> np.ndarray:
    """Per-token region labels of the shifted windows, (num_windows, N)
    int32: two tokens of a window may attend iff their labels match (HF
    `get_attn_mask` semantics). Labels are 3 * row region + column region,
    the regions [0, S - window), [S - window, S - shift), [S - shift, S) of
    the rolled frame."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    return win.transpose(0, 2, 1, 3).reshape(-1, window * window)


def shifted_window_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Additive SW-MSA mask, (num_windows, N, N) float32 with 0 / -100."""
    win = shifted_window_labels(h, w, window, shift)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window*window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int,
                   w: int) -> torch.Tensor:
    """(B * nW, window*window, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def to_windows(x: torch.Tensor, resolution: int, window: int,
               shift: int) -> torch.Tensor:
    """Raster (B, L, C) -> the (B * nW, N, C) windows of the stream rolled
    by -shift on both axes (a token at rolled (Y, X) is the raster token
    ((Y + shift) mod S, (X + shift) mod S))."""
    b, _, c = x.shape
    t = x.reshape(b, resolution, resolution, c)
    if shift:
        t = torch.roll(t, shifts=(-shift, -shift), dims=(1, 2))
    return window_partition(t, window)


def from_windows(xw: torch.Tensor, resolution: int, window: int,
                 shift: int) -> torch.Tensor:
    """The inverse of `to_windows`: (B * nW, N, C) -> raster (B, L, C)."""
    t = window_reverse(xw, window, resolution, resolution)
    if shift:
        t = torch.roll(t, shifts=(shift, shift), dims=(1, 2))
    return t.reshape(t.shape[0], resolution * resolution, t.shape[-1])


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


def _constant(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A geometry constant on `device`, made outside inference mode and
    autograd: the caches below hand it to every later call, and a tensor
    made under `torch.inference_mode()` could not be saved for a later
    grad-enabled forward's backward (`table[index]` saves the index)."""
    with torch.inference_mode(False), torch.no_grad():
        return torch.from_numpy(array).to(device)


@functools.lru_cache(maxsize=None)
def _position_index(window: int, device: torch.device) -> torch.Tensor:
    return _constant(relative_position_index(window).reshape(-1)
                     .astype(np.int64), device)


def relative_position_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """(H, N, N) bias gathered from the ((2w-1)^2, H) table, as
    `SwinBlock` gathers it (`geovpr/models/swin.py:396-398`)."""
    n = window * window
    bias = table[_position_index(window, table.device)].reshape(
        n, n, table.shape[-1])
    return bias.permute(2, 0, 1)


@functools.lru_cache(maxsize=None)
def _shift_mask(resolution: int, window: int, shift: int,
                device: torch.device) -> torch.Tensor:
    return _constant(shifted_window_mask(resolution, resolution, window,
                                         shift), device)


def shift_mask(resolution: int, window: int, shift: int,
               device=None) -> Optional[torch.Tensor]:
    """The (nW, N, N) additive mask of a shifted block, None unshifted;
    built once per geometry and device (callers never write to it)."""
    if not shift:
        return None
    return _shift_mask(resolution, window, shift, torch.device(device or "cpu"))


def add_bias_mask(s: torch.Tensor, bias: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scores (BW, H, N, N) + bias (H, N, N) [+ mask (nW, N, N), windows
    of one image in order, images one after another]."""
    s = s + bias[None].to(s.dtype)
    if mask is not None:
        nw = mask.shape[0]
        bw = s.shape[0]
        s = (s.reshape(bw // nw, nw, *s.shape[1:])
             + mask[None, :, None].to(s.dtype)).reshape(bw, *s.shape[1:])
    return s


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Block-local attention over pre-partitioned windows; q, k, v
    (BW, H, N, dh), bias (H, N, N), mask (nW, N, N) or None. Returns
    (BW, H, N, dh) in v's dtype. The softmax and P.V are the JAX
    `_window_attention_from_scores`."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / q.shape[-1] ** 0.5)
    p = torch.softmax(add_bias_mask(s, bias, mask), dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def window_attention_serving_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, bias: torch.Tensor,
                                       mask: Optional[torch.Tensor]
                                       ) -> torch.Tensor:
    """Plain PyTorch version of K7: the serving form of the JAX kernel body
    (`pallas_window_attention.py:59-114`). q is rounded again after the f32
    scale dh^-0.5 log2(e); s = f32(qs k^T) + f32(bias) log2(e) [+ f32(mask)
    log2(e)]; p = exp2(min(s, 100)) with no max-shift, rounded to v's dtype
    for P.V; the f32 row sum divides the context, rounded to v's dtype."""
    dt = v.dtype
    qscale = 1.0 / (q.shape[-1] ** 0.5) * LOG2E
    qs = (q.float() * qscale).to(q.dtype).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    s = add_bias_mask(s, bias.float() * LOG2E,
                      None if mask is None else mask.float() * LOG2E)
    p = torch.exp2(torch.clamp(s, max=100.0))
    out = torch.matmul(p.to(dt).float(), v.float()) / p.sum(-1, keepdim=True)
    return out.to(dt)


def k7_dtype_error(dtypes: dict) -> str | None:
    """The type rule of K7's split entry on CUDA (name -> dtype of q, k, v,
    bias and, where given, mask): q, k and v all bf16 (`csrc/
    window_attn.cu`) or all f32 (`csrc/f32_serving.cu`), bias and mask
    f32. The message, or None where the rule holds."""
    return serving_dtype_error("K7", dtypes, ("q", "k", "v"))


def k7_raster_dtype_error(dtypes: dict) -> str | None:
    """The type rule of K7's raster entry on CUDA: qkv bf16 or f32, the
    table f32. The message, or None where the rule holds."""
    return serving_dtype_error("K7", dtypes, ("qkv",))


def window_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor,
                            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Window attention over pre-split windows (BW, H, N, dh), with JAX's
    operands. CPU tensors run the plain version; CUDA tensors launch K7
    (bf16 or f32 q, k, v; f32 bias and mask: `k7_dtype_error`; contiguous
    and 16-byte aligned; head dim 32; N up to 256; BW a multiple of nW) or
    raise. Its gradient is the
    VJP of `window_attention` on the same operands."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be one (BW, H, N, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bw, h, n, dh = q.shape
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias must be {(h, n, n)}, got {tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (n, n)
                             or bw % mask.shape[0]):
        raise ValueError(f"mask must be (nW, {n}, {n}) with nW dividing "
                         f"BW={bw}, got {tuple(mask.shape)}")
    tensors = {"q": q, "k": k, "v": v, "bias": bias}
    if mask is not None:
        tensors["mask"] = mask
    if any(t.device != q.device for t in tensors.values()):
        raise ValueError("q, k, v, bias and mask must be on one device")
    if q.device.type == "cpu":
        return window_attention_serving_reference(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    err = k7_dtype_error({k: t.dtype for k, t in tensors.items()})
    if err:
        raise TypeError(err)
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if dh != _KERNEL_HEAD_DIM or n > _KERNEL_MAX_N:
        raise ValueError(f"the kernel takes head dim {_KERNEL_HEAD_DIM} and "
                         f"windows of up to {_KERNEL_MAX_N} tokens, got "
                         f"dh={dh}, N={n}")
    return _K7Split.apply(q, k, v, bias, mask)


def _plain_vjp(fn, inputs, needs, g):
    """The gradients of `fn(*inputs)` against `g` for the inputs whose
    `needs` flag is set (None for the others), through autograd on
    detached copies: the plain recompute of a kernel's backward."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(fn(*leaves), wanted, g)
                   if wanted else ())
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in leaves)


class _K7Split(torch.autograd.Function):
    """K7's split entry forward; the VJP of `window_attention` backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        ctx.save_for_backward(q, k, v, bias, mask)
        return _k7_split_launch(q, k, v, bias, mask)

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(window_attention, ctx.saved_tensors,
                          ctx.needs_input_grad, g)


def _k7_split_launch(q, k, v, bias, mask) -> torch.Tensor:
    bw, h, n, dh = q.shape
    from geovpr_torch.ops._build import library_on
    f32 = q.dtype == torch.float32
    lib = library_on(q.device.index, "geovpr_f32_serving_init" if f32
                     else "geovpr_window_attention_init")
    entry = (lib.geovpr_window_attention_f32 if f32
             else lib.geovpr_window_attention)
    out = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), bw, h,
            n, 1 if mask is None else mask.shape[0],
            float(1.0 / (dh ** 0.5) * LOG2E),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window_attention kernel launch failed: CUDA "
                           f"error {rc}")
    window_attention_kernel.launches += 1
    return out


window_attention_kernel.launches = 0


def windowed_attention(attention, qkv, table, num_heads: int,
                       resolution: int, window: int,
                       shift: int) -> torch.Tensor:
    """`attention(q, k, v, bias, mask)` on the windows of the raster qkv
    (B, L, 3C), q | k | v column blocks: the windows gathered with the
    cyclic shift (`_windows_qkv`, then contiguous), the (H, N, N) bias from
    the ((2w-1)^2, H) table, the shift mask of the geometry; the (BW, H, N,
    dh) context scattered back to raster (B, L, C) (`_raster_ctx`)."""
    q, k, v = (t.contiguous() for t in
               _windows_qkv(qkv, resolution, window, shift, num_heads))
    ctx = attention(q, k, v, relative_position_bias(table, window)
                    .contiguous(),
                    shift_mask(resolution, window, shift, qkv.device))
    return _raster_ctx(ctx, resolution, window, shift)


def window_attention_raster_reference(qkv, table, num_heads: int,
                                      resolution: int, window: int,
                                      shift: int) -> torch.Tensor:
    """Plain PyTorch version of K7's raster entry:
    `window_attention_serving_reference` on the gathered windows, the
    context scattered back to raster order."""
    return windowed_attention(window_attention_serving_reference, qkv, table,
                              num_heads, resolution, window, shift)


def k7_raster_shape_error(c: int, num_heads: int, resolution: int,
                          window: int, shift: int) -> str | None:
    """The rule of K7's raster mode (`csrc/window_attn.cu`), or None where
    it takes the shape: head dim 32, a window of up to 144 tokens (the
    head's bias matrix sits in shared memory) tiling the resolution, 0 <=
    shift < window."""
    if c != _KERNEL_HEAD_DIM * num_heads:
        return (f"K7 takes head dim {_KERNEL_HEAD_DIM}, got C={c} with "
                f"{num_heads} heads")
    if (not 0 < window * window <= _RASTER_MAX_N or resolution % window
            or not 0 <= shift < window):
        return (f"K7's raster mode takes windows of up to {_RASTER_MAX_N} "
                f"tokens tiling the resolution and 0 <= shift < window, got "
                f"window {window}, resolution {resolution}, shift {shift}")
    return None


def window_attention_raster(qkv: torch.Tensor, table: torch.Tensor,
                            num_heads: int, resolution: int, window: int,
                            shift: int) -> torch.Tensor:
    """K7 on the raster qkv (B, L, 3C) of the unfused window-attention half
    (q | k | v column blocks, head h at columns 32 h of each, q unscaled) and
    the block's ((2w-1)^2, H) relative-position table; returns the context
    (B, L, C) in raster order. CPU tensors run the plain version; CUDA
    tensors launch K7's raster mode (bf16 or f32 qkv, f32 table:
    `k7_raster_dtype_error`; contiguous and 16-byte aligned;
    `k7_raster_shape_error`) or raise. Its gradient is
    the VJP of `window_attention` on the gathered windows."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, L, 3C), got {tuple(qkv.shape)}")
    b, l, c3 = qkv.shape
    c = c3 // 3
    if l != resolution * resolution or c % num_heads:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not a {resolution}^2 "
                         f"grid of {num_heads} heads")
    t = 2 * window - 1
    if tuple(table.shape) != (t * t, num_heads):
        raise ValueError(f"table must be {(t * t, num_heads)}, got "
                         f"{tuple(table.shape)}")
    if table.device != qkv.device:
        raise ValueError("qkv and table must be on one device")
    if qkv.device.type == "cpu":
        return window_attention_raster_reference(qkv, table, num_heads,
                                                 resolution, window, shift)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    err = k7_raster_dtype_error({"qkv": qkv.dtype, "table": table.dtype})
    if err:
        raise TypeError(err)
    for name, x in (("qkv", qkv), ("table", table)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    err = k7_raster_shape_error(c, num_heads, resolution, window, shift)
    if err:
        raise ValueError(err)
    return _K7Raster.apply(qkv, table, num_heads, resolution, window, shift)


class _K7Raster(torch.autograd.Function):
    """K7's raster entry forward; backward, the VJP of `window_attention`
    on the windows gathered from qkv, with the bias gathered from the
    table."""

    @staticmethod
    def forward(ctx, qkv, table, num_heads, resolution, window, shift):
        ctx.save_for_backward(qkv, table)
        ctx.geom = (num_heads, resolution, window, shift)
        return _k7_raster_launch(qkv, table, *ctx.geom)

    @staticmethod
    def backward(ctx, g):
        def plain(qkv, table):
            return windowed_attention(window_attention, qkv, table,
                                      *ctx.geom)
        return _plain_vjp(plain, ctx.saved_tensors,
                          ctx.needs_input_grad[:2], g) + (None,) * 4


def _k7_raster_launch(qkv, table, num_heads, resolution, window,
                      shift) -> torch.Tensor:
    b, l, c3 = qkv.shape
    c = c3 // 3
    from geovpr_torch.ops._build import library_on
    f32 = qkv.dtype == torch.float32
    lib = library_on(qkv.device.index, "geovpr_f32_serving_init" if f32
                     else "geovpr_window_attention_init")
    entry = (lib.geovpr_window_attention_raster_f32 if f32
             else lib.geovpr_window_attention_raster)
    out = torch.empty(b, l, c, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = entry(
            qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, resolution,
            c, num_heads, window, shift,
            float(1.0 / (_KERNEL_HEAD_DIM ** 0.5) * LOG2E),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"window_attention_raster kernel launch failed: "
                           f"CUDA error {rc}")
    window_attention_raster.launches += 1
    return out


window_attention_raster.launches = 0
