"""Windowed multi-head attention, plain and unfused (the port of
`geovpr/ops/window_attention.py:28-50`), and the Swin window geometry it
runs on (`geovpr/models/swin.py:75-130`).

The port keeps the Swin token stream in raster (B, L, C) order. Only the
attention step needs to know which `window**2` rows form a window: here
`to_windows`/`from_windows` gather them (with the cyclic shift of SW-MSA)
into (B*nW, N, C) windows and back; the kernels K4/K5
(`geovpr_torch/csrc/swin_attn.cu`) do the same by address arithmetic.

`window_attention` is the JAX package's XLA path (scaled scores, bias,
mask, max-shifted softmax, P.V with P rounded to v's dtype): the Swin
calibration pass runs it, as the JAX calibration pass does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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


def relative_position_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """(H, N, N) bias gathered from the ((2w-1)^2, H) table, as
    `SwinBlock` gathers it (`geovpr/models/swin.py:396-398`)."""
    n = window * window
    idx = torch.from_numpy(relative_position_index(window).reshape(-1)).long()
    bias = table[idx.to(table.device)].reshape(n, n, table.shape[-1])
    return bias.permute(2, 0, 1)


def shift_mask(resolution: int, window: int, shift: int,
               device=None) -> Optional[torch.Tensor]:
    """The (nW, N, N) additive mask of a shifted block, None unshifted."""
    if not shift:
        return None
    return torch.from_numpy(shifted_window_mask(
        resolution, resolution, window, shift)).to(device)


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
