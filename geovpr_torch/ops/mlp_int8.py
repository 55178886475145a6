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
`geovpr_torch/csrc/mlp_int8.cu` or raises; on a CPU tensor it runs
`mlp_block_int8_reference`, the plain PyTorch version of the same
arithmetic.
"""

from __future__ import annotations

import torch

from geovpr_torch.ops.quant import (check_int8_kernel_args, check_shapes,
                                    int_mm, layer_norm_f32, round_clip_int8)

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


def fused_mlp_block_int8(x: torch.Tensor, ln_scale_q: torch.Tensor,
                         ln_bias_q: torch.Tensor, w1q_t: torch.Tensor,
                         s1_eff: torch.Tensor, b1: torch.Tensor,
                         w2q_t: torch.Tensor, s2_eff: torch.Tensor,
                         b2: torch.Tensor, gamma: torch.Tensor,
                         inv_a_mid, ln_eps: float = 1e-6,
                         residual: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """out = residual + gamma * MLP_int8(LN(x)); x (..., D), any leading
    shape. CPU tensors run the plain version; CUDA tensors launch K3 (bf16
    x and residual, int8 matrices, f32 vectors, contiguous, D and hidden
    multiples of 64, D <= 1024, forward only) or raise."""
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
    if x.device.type == "cpu":
        return mlp_block_int8_reference(x, ln_scale_q, ln_bias_q, w1q_t,
                                        s1_eff, b1, w2q_t, s2_eff, b2, gamma,
                                        inv_a_mid, ln_eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    mats = {k: got[k] for k in ("w1q_t", "w2q_t")}
    vecs = {k: v for k, v in got.items() if k not in mats}
    check_int8_kernel_args(x, mats, vecs, extra=() if residual is None
                           else (("residual", residual),))
    if d % 64 or hidden % 64 or d > 1024:
        raise ValueError(f"the kernel takes D and hidden multiples of 64 and "
                         f"D <= 1024, got D={d}, hidden={hidden}")
    m = x.numel() // d
    out = torch.empty_like(x)
    from geovpr_torch.ops._build import library_on
    lib = library_on(x.device.index, "geovpr_mlp_int8_init")
    res = x if residual is None else residual
    with torch.cuda.device(x.device):
        rc = lib.geovpr_mlp_block_int8(
            x.data_ptr(), res.data_ptr(), ln_scale_q.data_ptr(),
            ln_bias_q.data_ptr(), w1q_t.data_ptr(), s1_eff.data_ptr(),
            b1.data_ptr(), w2q_t.data_ptr(), s2_eff.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), out.data_ptr(), m, d, hidden,
            float(inv_a_mid), float(ln_eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlp_int8 kernel launch failed: CUDA error {rc}")
    fused_mlp_block_int8.launches += 1
    return out


fused_mlp_block_int8.launches = 0
