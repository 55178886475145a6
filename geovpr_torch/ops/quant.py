"""w8a8 int8 quantization primitives of the serving path (the port of
`geovpr.ops.quant`).

Scheme (static post-training quantization, as in the JAX package):
- weights: symmetric per-out-channel int8, quantized once (`quantize_weight`);
- activations: symmetric per-tensor int8 with static scales calibrated on
  sample batches (`geovpr_torch.models.quantize`).

The attention halves run in one of three modes, chosen by the same
environment variables as the JAX package's (`geovpr/ops/quant.py:34-39`),
read once when this module is imported:
- `INT8_QK_SCORES` (on unless `GEOVPR_INT8_QK=0`): int8 q·kᵀ scores, bf16
  P·V (the default); off, bf16 scores;
- `INT8_PV` (`GEOVPR_INT8_PV=1`, and only with int8 scores): int8 P·V on
  the max-shifted probabilities quantized to 127ths.
The model folds read the two flags through this module when they fold
(`QuantBlock._attn_int8_fold`), so a test may set them per model.

Rounding: `torch.round` rounds half to even, as `jnp.round` does.
Exactness: an int8 product summed over K terms reaches 127² K, which f32
holds exactly only below 2²⁴ (K ≤ 1040), so every int8 GEMM here goes
through `torch._int_mm` (exact int32 sums).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

INT8_QK_SCORES = os.environ.get("GEOVPR_INT8_QK", "1") != "0"
INT8_PV = os.environ.get("GEOVPR_INT8_PV", "0") == "1" and INT8_QK_SCORES

# The attention modes of the int8 half-blocks K2 and K5, in the order of
# the kernels' mode codes: int8 scores with bf16 P.V (`cs` given), int8
# P.V on top (`cs` and `cpv` given), bf16 scores (`cs` None).
ATTN_MODES = ("int8_scores", "int8_pv", "bf16_scores")


def attn_mode(cs, cpv) -> str:
    """The mode of the folded constants: `cs` None is bf16 scores, `cpv`
    given int8 P.V (which needs int8 scores, as `INT8_PV` does)."""
    if cs is None:
        if cpv is not None:
            raise ValueError("int8 P.V (cpv) needs int8 scores (cs)")
        return "bf16_scores"
    return "int8_scores" if cpv is None else "int8_pv"


def quantize_weight(w) -> tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float kernel -> (int8 kernel (in, out), (out,) f32 scale),
    computed in numpy f32 exactly as `geovpr.ops.quant.quantize_weight`."""
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w, np.float32)
    scale = np.abs(w).max(axis=0) / 127.0 + 1e-12
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return torch.from_numpy(q), torch.from_numpy(scale.astype(np.float32))


def round_clip_int8(v: torch.Tensor) -> torch.Tensor:
    """f32 -> int8: round half to even, clip to [-127, 127]."""
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def quantize_act(x: torch.Tensor, a_scale) -> torch.Tensor:
    """f32 activations -> int8 with a static per-tensor scale."""
    return round_clip_int8(x * (1.0 / a_scale))


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 matmul, a (M, K) @ b (K, N), through
    `torch._int_mm`. On CUDA `_int_mm` needs M > 16 and K, N multiples of 8:
    fewer rows are padded with zeros (and cut off again); K or N off the
    multiple of 8 raises there."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros(17 - m, a.shape[1])])
    return torch._int_mm(a.contiguous(), b)[:m]


def int8_dense(x: torch.Tensor, a_scale, wq: torch.Tensor,
               w_scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """w8a8 matmul: f32 in -> int8 x int8 -> int32 -> dequantized f32 out.
    x (M, in) f32; wq (in, out) int8; w_scale, bias (out,)."""
    yi = int_mm(quantize_act(x, a_scale), wq)
    return yi.float() * (a_scale * w_scale) + bias


def amax_into(calib: dict, key: str, x: torch.Tensor) -> None:
    """Calibration hook (the JAX package's `sow` into "quant_calib"):
    keep the running max of |x| over calibration batches under `key`."""
    a = float(x.detach().float().abs().max())
    calib[key] = max(calib.get(key, a), a)


def act_scale(amax: float) -> torch.Tensor:
    """Static per-tensor activation scale from a calibration amax, computed
    as the JAX package does (in Python floats, then f32)."""
    return torch.tensor(amax / 127.0 + 1e-12, dtype=torch.float32)


def layer_norm_f32(xf: torch.Tensor, eps: float) -> torch.Tensor:
    """Unscaled LayerNorm in f32 with two-pass statistics, as the JAX
    kernels compute it."""
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def ln_quant_reference(x: torch.Tensor, ln_scale_q: torch.Tensor,
                       ln_bias_q: torch.Tensor, ln_eps: float) -> torch.Tensor:
    """Plain version of the LN-quant launch of K3 and K5: the int8 rows
    round_clip(LN(x) * s' + b') (M, D) of x (..., D), LayerNorm in f32
    (two-pass), 1/a_x folded into s' and b'."""
    d = x.shape[-1]
    return round_clip_int8(layer_norm_f32(x.reshape(-1, d).float(), ln_eps)
                           * ln_scale_q + ln_bias_q)


def qk8v_reference(xq, wqkv_q_t, sqkv_eff, bqkv_eff):
    """Plain version of the int8 GEMM's QK8V epilogue (the QKV launch of K2
    and K5): from the LN-quant rows xq (M, C) int8, qk8 (M, 2C) int8 (q |
    k) and v (M, C) bf16, rounded from the f32 dequantised sums as the
    half-blocks' plain versions round them."""
    c = xq.shape[-1]
    f = int_mm(xq, wqkv_q_t.t()).float() * sqkv_eff + bqkv_eff
    return round_clip_int8(f[:, :2 * c]), f[:, 2 * c:].to(torch.bfloat16)


def qkv_part_reference(xq, wqkv_q_t, sqkv_eff, bqkv_eff,
                       mode: str = "int8_scores", qscale: float = 1.0):
    """Plain version of the QKV launch of K2 and K5 in each attention mode
    (`ATTN_MODES`): from the LN-quant rows xq (M, C) int8, the (qk, v) the
    launch writes. int8 scores: `qk8v_reference`'s qk8 (M, 2C) and v (M, C)
    bf16; int8 P.V: q | k | v (M, 3C) rounded to int8; bf16 scores: q | k |
    v (M, 3C) bf16, the q third times `qscale` = dh^-0.5 log2(e) in f32
    before the rounding (JAX's `srow`). v is empty (M, 0) in the last two."""
    if mode == "int8_scores":
        return qk8v_reference(xq, wqkv_q_t, sqkv_eff, bqkv_eff)
    c = xq.shape[-1]
    f = int_mm(xq, wqkv_q_t.t()).float() * sqkv_eff + bqkv_eff
    none = f.new_empty((f.shape[0], 0), dtype=torch.bfloat16)
    if mode == "int8_pv":
        return round_clip_int8(f), none
    f[:, :c] = f[:, :c] * qscale
    return f.to(torch.bfloat16), none


def qkv_buffers(m: int, c: int, mode: str, device) -> tuple:
    """The (qk, v) buffers of K2's and K5's QKV launch in `mode`, shaped as
    `qkv_part_reference` returns them: qk8 (M, 2C) int8 and v (M, C) bf16
    (int8 scores), qkv8 (M, 3C) int8 (int8 P.V) or qkv (M, 3C) bf16 (bf16
    scores) and an empty v."""
    if mode == "int8_scores":
        return (torch.empty((m, 2 * c), dtype=torch.int8, device=device),
                torch.empty((m, c), dtype=torch.bfloat16, device=device))
    dt = torch.int8 if mode == "int8_pv" else torch.bfloat16
    return (torch.empty((m, 3 * c), dtype=dt, device=device),
            torch.empty((m, 0), dtype=torch.bfloat16, device=device))


def int8_resid_reference(a8: torch.Tensor, w_q_t: torch.Tensor,
                         s_eff: torch.Tensor, b: torch.Tensor,
                         res: torch.Tensor, gamma=None) -> torch.Tensor:
    """Plain version of the int8 GEMM's residual epilogue (K5's out
    projection, K3's fc2): (a8 w_q_t^T * s + b) [* gamma] + res in f32,
    rounded to res.dtype; a8 (M, K) int8, w_q_t (N, K) int8, res (M, N)."""
    y = int_mm(a8, w_q_t.t()).float() * s_eff + b
    if gamma is not None:
        y = y * gamma
    return (y + res.float()).to(res.dtype)


def mode_constants(cs, cpv, cpl, dh: int, score_constant) -> tuple:
    """The kernels' trailing scalars: (score constant, mode code, qscale,
    cpv, cpl). The score constant is cs in the exp2 domain
    (`score_constant(cs)`; 0 in bf16 scores), the mode code an index into
    `ATTN_MODES`, qscale = dh^-0.5 log2(e) (the q third's factor in bf16
    scores), cpv and cpl 0 where the mode has none."""
    mode = attn_mode(cs, cpv)
    return (0.0 if cs is None else score_constant(cs),
            ATTN_MODES.index(mode), dh ** -0.5 * math.log2(math.e),
            0.0 if cpv is None else float(cpv),
            0.0 if cpl is None else float(cpl))


def check_shapes(want: dict, got: dict) -> None:
    """Raise ValueError unless every tensor in `got` has the shape in
    `want`."""
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(got[name].shape)}")


def check_devices(x, tensors: dict) -> None:
    """Raise ValueError unless every tensor in `tensors` lies on x's
    device."""
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def serving_dtype_error(name: str, dtypes: dict,
                        stream: tuple) -> str | None:
    """The type rule of the serving kernels K1, K4, K6 and K7 on CUDA,
    each of which has a bf16 and an f32 form: the tensors named in
    `stream` (the activations and the matrices) all bf16 or all f32, every
    other tensor of `dtypes` (name -> dtype: vectors, tables, bias, mask)
    f32. The message, or None where the rule holds."""
    got = [dtypes[k] for k in stream]
    if got[0] not in (torch.bfloat16, torch.float32) or any(
            t != got[0] for t in got):
        return (f"{name} takes {', '.join(stream)} all torch.bfloat16 or all "
                f"torch.float32 on CUDA, got " + ", ".join(
                    f"{k} {t}" for k, t in zip(stream, got)))
    for k, t in dtypes.items():
        if k not in stream and t != torch.float32:
            return f"{name} takes {k} in torch.float32 on CUDA, got {t}"
    return None


def training_dtype_error(name: str, dtypes: dict,
                         stream: tuple) -> str | None:
    """The type rule of the training kernels K8a-K8c and K9a-K9c on CUDA,
    each of which has a bf16 and an f32 form: the tensors of `dtypes`
    (name -> dtype) named in `stream` (the activations, matrices, residuals
    and gradients) all bf16 or all f32, every other one (the vectors, the
    table) f32. The message, naming the tensor that breaks the rule against
    the dtype most of the stream has, or None where it holds."""
    names = [k for k in stream if k in dtypes]
    got = [dtypes[k] for k in names]
    want = max(got, key=got.count) if got else torch.bfloat16
    if want not in (torch.bfloat16, torch.float32):
        return (f"{name} takes {', '.join(names)} all torch.bfloat16 or all "
                f"torch.float32 on CUDA, got {want}")
    for k in names:
        if dtypes[k] != want:
            return (f"{name} takes {', '.join(names)} in one dtype, "
                    f"torch.bfloat16 or torch.float32, on CUDA: {k} is "
                    f"{dtypes[k]}, the rest {want}")
    for k, t in dtypes.items():
        if k not in names and t != torch.float32:
            return f"{name} takes {k} in torch.float32 on CUDA, got {t}"
    return None


def int8_stream_dtype_error(name: str, dtypes: dict, stream: tuple,
                            mats: tuple) -> str | None:
    """The type rule of the w8a8 kernels K2, K3 and K5 on CUDA, each of
    which has a bf16 and an f32 form (`csrc/hopper_gemm_s8.cuh`'s LN-quant
    pass and residual epilogues in the stream's type): the tensors of
    `dtypes` (name -> dtype) named in `stream` (x, and K3's separate
    residual where there is one) all bf16 or all f32, the output x's; those
    named in `mats` int8; every other one f32. The message, or None where
    the rule holds."""
    names = [k for k in stream if k in dtypes]
    got = [dtypes[k] for k in names]
    if got[0] not in (torch.bfloat16, torch.float32) or any(
            t != got[0] for t in got):
        return (f"{name} takes {', '.join(names)} all torch.bfloat16 or all "
                f"torch.float32 on CUDA, got " + ", ".join(
                    f"{k} {t}" for k, t in zip(names, got)))
    for k, t in dtypes.items():
        if k in mats and t != torch.int8:
            return f"{name} takes {k} in torch.int8, got {t}"
        if k not in mats and k not in names and t != torch.float32:
            return f"{name} takes {k} in torch.float32 on CUDA, got {t}"
    return None


def int8_attn_dtype_rule(name: str):
    """The type rule of the w8a8 attention half-block `name` (K2, K5) on
    CUDA as a function of name -> dtype, named `k2_dtype_error` ...: x
    bf16 or f32 (the output is x's), wqkv_q_t and wo_q_t int8, the vectors
    (and K5's table) f32 (`int8_stream_dtype_error`)."""
    def rule(dtypes: dict) -> str | None:
        return int8_stream_dtype_error(name, dtypes, ("x",),
                                       ("wqkv_q_t", "wo_q_t"))
    rule.__name__ = rule.__qualname__ = f"{name.lower()}_dtype_error"
    return rule


def check_int8_kernel_args(x, mats: dict, vecs: dict, dtype_error,
                           extra=()) -> None:
    """What the int8 kernels take on CUDA: x (and `extra` tensors, K3's
    residual) bf16 or f32 in one dtype, int8 matrices, f32 vectors
    (`dtype_error`, the kernel's rule on name -> dtype), all contiguous, on
    x's device, forward only. Raises on anything else."""
    tensors = {"x": x, **dict(extra), **mats, **vecs}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise RuntimeError("the int8 serving kernels have no backward; run "
                           "the forward under torch.inference_mode()")
    err = dtype_error({k: t.dtype for k, t in tensors.items()})
    if err:
        raise TypeError(err)
