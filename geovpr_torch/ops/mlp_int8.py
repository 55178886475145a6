"""Fused w8a8 MLP half-block (kernel K3) and its plain version.

    out = res + gamma * MLP_int8(LN(x))      (res = x unless `residual`)

The port of `geovpr/ops/pallas_mlp.py::fused_mlp_block_int8`, with the
same arguments and pre-folded static scales (the ones
`geovpr/models/layers.py:148-158` passes): `ln_scale_q`/`ln_bias_q` carry
1/a_in, `s1_eff` = a_in * s1, `s2_eff` = a_mid * s2, `inv_a_mid` = 1/a_mid.
One layout differs: the int8 weights are (out, in), nn.Linear's layout
(`w1q_t` (hidden, D), `w2q_t` (D, hidden)), the transpose of JAX's (in,
out), because the kernel's int8 tensor-core product takes both operands
k-contiguous.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
`geovpr_torch/csrc/mlp_int8.cu` (three launches: LN-quant, fc1 with the
GELU epilogue, fc2 with the residual epilogue; `K3_PARTS`) in the form of
the stream's dtype: bf16, or f32 for a model built with
compute_dtype="float32" (`k3_dtype_error`), or raises; on a CPU tensor it
runs `mlp_block_int8_reference`, the plain PyTorch version of the same
arithmetic, which computes in f32 and rounds once to x's dtype.
"""

from __future__ import annotations

import torch

from geovpr_torch.ops.quant import (check_int8_kernel_args, check_shapes,
                                    int8_stream_dtype_error, int_mm,
                                    layer_norm_f32, round_clip_int8)

_K3_MAX_D = 1024

_GELU_C = 0.7978845608028654  # sqrt(2 / pi)


def mlp_block_int8_reference(x, ln_scale_q, ln_bias_q, w1q_t, s1_eff, b1,
                             w2q_t, s2_eff, b2, gamma, inv_a_mid,
                             ln_eps: float = 1e-6, residual=None):
    """Plain PyTorch version: LN -> int8 -> int8 fc1 (exact int32) ->
    dequant -> tanh GELU in f32 -> int8 -> int8 fc2 -> dequant -> * gamma
    -> + residual, rounding where `_mlp_int8_core` rounds (the XLA fallback
    of `geovpr/models/layers.py:159-183` with the scales folded)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d).float()
    xq = round_clip_int8(layer_norm_f32(xf, ln_eps) * ln_scale_q + ln_bias_q)
    h = int_mm(xq, w1q_t.t()).float() * s1_eff + b1
    g = 0.5 * h * (1.0 + torch.tanh(_GELU_C * (h + 0.044715 * h * h * h)))
    gq = round_clip_int8(g * inv_a_mid)
    y = int_mm(gq, w2q_t.t()).float() * s2_eff + b2
    res = xf if residual is None else residual.reshape(-1, d).float()
    return (y * gamma + res).to(x.dtype).reshape(*lead, d)


def mlp_fc1_int8_reference(xq, w1q_t, s1_eff, b1, inv_a_mid):
    """Plain version of K3's fc1 launch: the int8 hidden (M, hidden) from
    the LN-quant rows xq (M, D) int8, rounded as `mlp_block_int8_reference`
    rounds it."""
    h = int_mm(xq, w1q_t.t()).float() * s1_eff + b1
    g = 0.5 * h * (1.0 + torch.tanh(_GELU_C * (h + 0.044715 * h * h * h)))
    return round_clip_int8(g * inv_a_mid)


def k3_shape_error(d: int, hidden: int) -> str | None:
    """The rule of K3's kernels (`csrc/mlp_int8.cu`), or None where they
    take the shape: D and hidden multiples of 16 (the int8 rows are read
    and written by TMA, in 16-byte strides) and D <= 1024 (the LN-quant
    pass stages a warp's rows, at least two, in 4 KB)."""
    if d <= 0 or hidden <= 0 or d % 16 or hidden % 16 or d > _K3_MAX_D:
        return (f"K3 takes D and hidden multiples of 16 and D <= "
                f"{_K3_MAX_D}, got D={d}, hidden={hidden}")
    return None


def k3_dtype_error(dtypes: dict) -> str | None:
    """K3's type rule on CUDA (name -> dtype of its tensors): x and the
    separate residual, where there is one, both bf16 or both f32 (the
    output is x's), the matrices int8, the vectors f32
    (`quant.int8_stream_dtype_error`). The message, or None where the rule
    holds."""
    return int8_stream_dtype_error("K3", dtypes, ("x", "residual"),
                                   ("w1q_t", "w2q_t"))


def _k3_got(x, ln_scale_q, ln_bias_q, w1q_t, s1_eff, b1, w2q_t, s2_eff, b2,
            gamma, residual) -> dict:
    """K3's tensor arguments by name, their shapes checked."""
    d = x.shape[-1]
    hidden = w1q_t.shape[0]
    want = {"ln_scale_q": (d,), "ln_bias_q": (d,), "w1q_t": (hidden, d),
            "s1_eff": (hidden,), "b1": (hidden,), "w2q_t": (d, hidden),
            "s2_eff": (d,), "b2": (d,), "gamma": (d,)}
    got = {"ln_scale_q": ln_scale_q, "ln_bias_q": ln_bias_q, "w1q_t": w1q_t,
           "s1_eff": s1_eff, "b1": b1, "w2q_t": w2q_t, "s2_eff": s2_eff,
           "b2": b2, "gamma": gamma}
    check_shapes(want, got)
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} != x "
                         f"{tuple(x.shape)}")
    return got


def fused_mlp_block_int8(x: torch.Tensor, ln_scale_q: torch.Tensor,
                         ln_bias_q: torch.Tensor, w1q_t: torch.Tensor,
                         s1_eff: torch.Tensor, b1: torch.Tensor,
                         w2q_t: torch.Tensor, s2_eff: torch.Tensor,
                         b2: torch.Tensor, gamma: torch.Tensor,
                         inv_a_mid, ln_eps: float = 1e-6,
                         residual: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """out = residual + gamma * MLP_int8(LN(x)); x (..., D), any leading
    shape. CPU tensors run the plain version; CUDA tensors launch K3 in
    the form of x's dtype (x and residual bf16 or f32, int8 matrices, f32
    vectors: `k3_dtype_error`; contiguous, `k3_shape_error`'s widths,
    forward only) or raise."""
    got = _k3_got(x, ln_scale_q, ln_bias_q, w1q_t, s1_eff, b1, w2q_t, s2_eff,
                  b2, gamma, residual)
    if x.device.type == "cpu":
        return mlp_block_int8_reference(x, ln_scale_q, ln_bias_q, w1q_t,
                                        s1_eff, b1, w2q_t, s2_eff, b2, gamma,
                                        inv_a_mid, ln_eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    bufs = k3_buffers(x, w1q_t.shape[0])
    lib, args = _k3_args(x, got, inv_a_mid, ln_eps, residual, bufs)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_mlp_int8_parts(
            *args, 0, len(K3_PARTS) - 1,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlp_int8 kernel launch failed: CUDA error {rc}")
    fused_mlp_block_int8.launches += 1
    return bufs[2]


def k3_buffers(x: torch.Tensor, hidden: int) -> tuple:
    """K3's scratch and output for x (..., D): xq (M, D) and the hidden
    (M, hidden) int8, and out."""
    d = x.shape[-1]
    m = x.numel() // d
    return (torch.empty((m, d), dtype=torch.int8, device=x.device),
            torch.empty((m, hidden), dtype=torch.int8, device=x.device),
            torch.empty_like(x))


def _k3_args(x, got: dict, inv_a_mid, ln_eps, residual, bufs):
    """The library and K3's C arguments up to the form of x's dtype (but
    the launches and the stream) for a CUDA x, or raise on what the
    kernels do not take."""
    mats = {k: got[k] for k in ("w1q_t", "w2q_t")}
    vecs = {k: v for k, v in got.items() if k not in mats}
    check_int8_kernel_args(x, mats, vecs, k3_dtype_error,
                           extra=() if residual is None
                           else (("residual", residual),))
    d, hidden = x.shape[-1], got["w1q_t"].shape[0]
    err = k3_shape_error(d, hidden)
    if err:
        raise ValueError(err)
    res = x if residual is None else residual
    ptrs = [x, res, *got.values(), *bufs]
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("K3 reads its tensors by TMA and 16-byte loads: "
                         "each must start 16-byte aligned")
    from geovpr_torch.ops._build import library_on
    lib = library_on(x.device.index, "geovpr_mlp_int8_init")
    return lib, (*(t.data_ptr() for t in ptrs), x.numel() // d, d, hidden,
                 float(inv_a_mid), float(ln_eps),
                 int(x.dtype == torch.float32))


K3_PARTS = ("ln_quant", "fc1", "fc2")


def k3_launch_part(part: int, x, ln_scale_q, ln_bias_q, w1q_t, s1_eff, b1,
                   w2q_t, s2_eff, b2, gamma, inv_a_mid, ln_eps: float = 1e-6,
                   residual=None, *, bufs) -> None:
    """One of K3's three launches (an index into K3_PARTS) alone, on the
    arguments of `fused_mlp_block_int8` (CUDA tensors it takes) and the
    `k3_buffers` `bufs`, whose contents from an earlier call it reads.
    chip_smoke.py times K3's launches one by one with it and the card tests
    check each against its plain version; it counts no launch."""
    got = _k3_got(x, ln_scale_q, ln_bias_q, w1q_t, s1_eff, b1, w2q_t, s2_eff,
                  b2, gamma, residual)
    lib, args = _k3_args(x, got, inv_a_mid, ln_eps, residual, bufs)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_mlp_int8_parts(
            *args, part, part, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlp_int8 kernel launch failed: CUDA error {rc}")


fused_mlp_block_int8.launches = 0
