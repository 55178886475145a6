"""Fused pre-LN attention half-blocks and their plain versions: kernel K1
(bf16) and, below, kernel K2 (w8a8).

    out = x + gamma * (MHSA(LN(x)) @ Wo + bo)

The port of `geovpr/ops/pallas_mhsa.py::fused_mhsa_block` (serving forward),
with the same signature and layouts: x (B, N, D); wqkv (D, 3D) with q|k|v
column blocks; wo (D, D); gamma (D,) LayerScale. On a CUDA tensor the
wrapper launches the hand-written Hopper kernel in `geovpr_torch/csrc/mhsa.cu`
or raises; on a CPU tensor it runs `mhsa_block_reference`, the plain PyTorch
version of the same arithmetic (the JAX oracle `_mhsa_block_xla`).
"""

from __future__ import annotations

import math

import torch

from geovpr_torch.ops.quant import (amax_into, check_int8_kernel_args,
                                    check_shapes, int_mm, layer_norm_f32,
                                    round_clip_int8)

_KERNEL_HEAD_DIM = 64


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with f32 accumulation and an f32 result for any input dtype
    (JAX's `preferred_element_type=jnp.float32`): bf16 operands are exact in
    f32, so this is the bf16 tensor-core product without the output rounding
    a bf16 `torch.matmul` would add."""
    return torch.matmul(a.float(), b.float())


def mhsa_block_reference(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma,
                         num_heads: int, ln_eps: float = 1e-6,
                         calib: dict | None = None):
    """Plain PyTorch version of the fused block, rounding to x.dtype at the
    same places as `_mhsa_block_xla` (LN output, qkv, probabilities, ctx).
    With `calib` (a dict) it also records the amaxes the int8 calibration
    reads, at the points JAX's calibration pass sows them (`attn_x` the LN
    output, `attn_q`/`attn_k`/`attn_v` the projections, `attn_ctx` the
    context before the out projection)."""
    b, n, d = x.shape
    dh = d // num_heads
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    h = ((xf - mu) * torch.rsqrt(var + ln_eps) * ln_scale.float()
         + ln_bias.float()).to(dt)
    qkv = (_mm(h, wqkv) + bqkv.float()).to(dt)
    q, k, v = qkv.split(d, dim=-1)
    if calib is not None:
        for key, t in (("attn_x", h), ("attn_q", q), ("attn_k", k),
                       ("attn_v", v)):
            amax_into(calib, key, t)

    def heads(t):
        return t.reshape(b, n, num_heads, dh).transpose(1, 2)

    s = _mm(heads(q), heads(k).transpose(-1, -2)) * dh ** -0.5
    p = torch.softmax(s, dim=-1)
    o = _mm(p.to(dt), heads(v)).transpose(1, 2).reshape(b, n, d).to(dt)
    if calib is not None:
        amax_into(calib, "attn_ctx", o)
    out = _mm(o, wo) + bo.float()
    return (out * gamma.float() + xf).to(dt)


def _check(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma, num_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got {tuple(x.shape)}")
    d = x.shape[-1]
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    want = {"ln_scale": (d,), "ln_bias": (d,), "wqkv": (d, 3 * d),
            "bqkv": (3 * d,), "wo": (d, d), "bo": (d,), "gamma": (d,)}
    got = {"ln_scale": ln_scale, "ln_bias": ln_bias, "wqkv": wqkv,
           "bqkv": bqkv, "wo": wo, "bo": bo, "gamma": gamma}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(got[name].shape)}")
        if got[name].device != x.device:
            raise ValueError(f"{name} is on {got[name].device}, x on "
                             f"{x.device}")
    return got


def _kernel_library(device_index: int):
    """The built library, made ready on one device (once per device), and
    the largest D its kernels take."""
    from geovpr_torch.ops._build import library_on
    lib = library_on(device_index, "geovpr_mhsa_init")
    return lib, lib.geovpr_mhsa_max_dim()


def fused_mhsa_block(x: torch.Tensor, ln_scale: torch.Tensor,
                     ln_bias: torch.Tensor, wqkv: torch.Tensor,
                     bqkv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                     gamma: torch.Tensor, num_heads: int,
                     ln_eps: float = 1e-6) -> torch.Tensor:
    """Fused pre-LN attention half-block. CPU tensors run the plain version;
    CUDA tensors launch the kernel (bf16 activations and matrices, f32
    vectors, contiguous, head dim 64, forward only) or raise."""
    got = _check(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma, num_heads)
    if x.device.type == "cpu":
        return mhsa_block_reference(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                    gamma, num_heads, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, *got.values())):
        raise RuntimeError(
            "fused_mhsa_block has no backward kernel yet (K8 in ROADMAP "
            "Queue 2); run the forward under torch.inference_mode()")
    for name, t in (("x", x), ("wqkv", wqkv), ("wo", wo)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
    for name in ("ln_scale", "ln_bias", "bqkv", "bo", "gamma"):
        if got[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {got[name].dtype}")
    for name, t in (("x", x), *got.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, n, d = x.shape
    if d // num_heads != _KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {_KERNEL_HEAD_DIM}, got "
                         f"{d // num_heads}")

    lib, max_dim = _kernel_library(x.device.index)
    if d > max_dim:
        raise ValueError(f"D={d} exceeds the kernel's shared-memory limit "
                         f"({max_dim})")
    qkv = torch.empty((b * n, 3 * d), dtype=x.dtype, device=x.device)
    ctx = torch.empty((b * n, d), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_mhsa_block_bf16(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            gamma.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(),
            b, n, d, num_heads, float(ln_eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mhsa kernel launch failed: CUDA error {rc}")
    fused_mhsa_block.launches += 1
    return out


fused_mhsa_block.launches = 0


# ------------------------------------------------------------------- K2 ----
#
# The w8a8 half-block: the port of `geovpr/ops/pallas_mhsa.py::
# fused_mhsa_block_int8` (with `cs` given and `cpv` not, the JAX defaults),
# on the arguments `DinoV2Block`'s int8 fold produces (`geovpr/models/
# dinov2.py:201-249`). As in K3 the int8 weights are (out, in): wqkv_q_t
# (3D, D) and wo_q_t (D, D). `cs` is the natural-log score constant
# a_q a_k dh^-0.5, as `_attention_int8` takes it; the kernel works in the
# exp2 domain and the wrapper multiplies by log2(e), the factor JAX's
# caller applies (`dinov2.py:267`).

LOG2E = math.log2(math.e)


def _exact_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of integer-valued tensors (int8 values), exact: in
    f64, whose 53-bit mantissa holds every such sum here, then rounded to
    f32 as JAX's int32 -> f32 cast rounds."""
    return torch.matmul(a.double(), b.double()).float()


def mhsa_block_int8_reference(x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff,
                              bqkv_eff, wo_q_t, so_eff, bo, gamma,
                              num_heads: int, ln_eps: float = 1e-6,
                              cs=None, cpv=None, cpl=None):
    """Plain PyTorch version, with the rounding points of the XLA fallback
    `DinoV2Block._attention_int8` (LN -> int8, qkv dequant, q/k -> int8,
    v -> bf16, ctx -> int8, out in f32) in all three of its modes: `cs`
    given (int8 q.k^T scores, bf16 P.V; the default), `cs` and `cpv` given
    (int8 P.V on max-shifted probabilities quantized to 127ths), and `cs`
    None (bf16 scores). In the default mode the softmax is the one K2 and
    the JAX kernel body run (`_stage_split_attention_qk8` with `skip_max`):
    exp2(min(s cs log2(e), 100)) with no max-shift, the unnormalised p
    rounded to bf16, the f32 sum dividing the context. The fallback's
    normalised softmax rounds p at another place, which on an H100 moved
    ~5% of the int8 contexts of a DINOv2-B block by one step against the
    kernel; this way kernel and plain version differ only in summation
    order. The other two modes keep the fallback's max-shifted softmax."""
    b, n, d = x.shape
    dh = d // num_heads
    xf = x.float()
    xq = round_clip_int8(layer_norm_f32(xf, ln_eps) * ln_scale_q + ln_bias_q)
    yi = int_mm(xq.reshape(-1, d), wqkv_q_t.t())
    qkv_f = (yi.float() * sqkv_eff + bqkv_eff).reshape(b, n, 3 * d)

    def heads(t):
        return t.reshape(b, n, num_heads, dh).transpose(1, 2)

    if cs is None:
        q, k, v = qkv_f.to(torch.bfloat16).split(d, dim=-1)
        s = _mm(heads(q), heads(k).transpose(-1, -2)) * dh ** -0.5
        p = torch.softmax(s, dim=-1).to(torch.bfloat16)
        ctx = _mm(p, heads(v))
    else:
        q8 = round_clip_int8(qkv_f[..., :d])
        k8 = round_clip_int8(qkv_f[..., d:2 * d])
        si = _exact_bmm(heads(q8), heads(k8).transpose(-1, -2))
        if cpv is None:
            cs2 = torch.tensor(float(cs) * LOG2E, dtype=torch.float32)
            p = torch.exp2(torch.clamp(si * cs2.to(si.device), max=100.0))
            v = qkv_f[..., 2 * d:].to(torch.bfloat16)
            ctx = _mm(p.to(torch.bfloat16), heads(v)) / p.sum(-1, keepdim=True)
        else:
            s = si * cs
            v8 = round_clip_int8(qkv_f[..., 2 * d:])
            p = torch.exp(s - s.amax(-1, keepdim=True))
            z = p.sum(-1, keepdim=True)
            pi = torch.round(p * 127.0).to(torch.int8)
            ctx = _exact_bmm(pi, heads(v8)) * cpv / z
    ctxq = round_clip_int8(ctx.transpose(1, 2).reshape(b * n, d))
    out = int_mm(ctxq, wo_q_t.t()).float() * so_eff + bo
    return (out.reshape(b, n, d) * gamma + xf).to(x.dtype)


def fused_mhsa_block_int8(x: torch.Tensor, ln_scale_q: torch.Tensor,
                          ln_bias_q: torch.Tensor, wqkv_q_t: torch.Tensor,
                          sqkv_eff: torch.Tensor, bqkv_eff: torch.Tensor,
                          wo_q_t: torch.Tensor, so_eff: torch.Tensor,
                          bo: torch.Tensor, gamma: torch.Tensor,
                          num_heads: int, ln_eps: float = 1e-6,
                          cs=None, cpv=None, cpl=None) -> torch.Tensor:
    """w8a8 fused attention half-block. CPU tensors run the plain version
    in any mode; CUDA tensors launch K2 (int8 scores with `cs` given, bf16
    P.V; bf16 x, int8 matrices, f32 vectors, contiguous, head dim 64,
    forward only) or raise, also on the two modes the kernel does not take
    (`cs` None, or `cpv`/`cpl` given)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    want = {"ln_scale_q": (d,), "ln_bias_q": (d,), "wqkv_q_t": (3 * d, d),
            "sqkv_eff": (3 * d,), "bqkv_eff": (3 * d,), "wo_q_t": (d, d),
            "so_eff": (d,), "bo": (d,), "gamma": (d,)}
    got = {"ln_scale_q": ln_scale_q, "ln_bias_q": ln_bias_q,
           "wqkv_q_t": wqkv_q_t, "sqkv_eff": sqkv_eff, "bqkv_eff": bqkv_eff,
           "wo_q_t": wo_q_t, "so_eff": so_eff, "bo": bo, "gamma": gamma}
    check_shapes(want, got)
    if x.device.type == "cpu":
        return mhsa_block_int8_reference(
            x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff, bqkv_eff, wo_q_t,
            so_eff, bo, gamma, num_heads, ln_eps, cs, cpv, cpl)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if cs is None or cpv is not None or cpl is not None:
        raise NotImplementedError(
            "the K2 kernel takes only the default mode (int8 scores, bf16 "
            "P.V): cs=None and the int8-P.V mode are still to port (ROADMAP)")
    mats = {k: got[k] for k in ("wqkv_q_t", "wo_q_t")}
    vecs = {k: v for k, v in got.items() if k not in mats}
    check_int8_kernel_args(x, mats, vecs)
    if d // num_heads != _KERNEL_HEAD_DIM or d > 1024:
        raise ValueError(f"the kernel takes head dim {_KERNEL_HEAD_DIM} and "
                         f"D <= 1024, got D={d}, {num_heads} heads")
    from geovpr_torch.ops._build import library_on
    lib = library_on(x.device.index, "geovpr_mhsa_int8_init")
    m = b * n
    qk8 = torch.empty((m, 2 * d), dtype=torch.int8, device=x.device)
    v = torch.empty((m, d), dtype=torch.bfloat16, device=x.device)
    ctx8 = torch.empty((m, d), dtype=torch.int8, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_mhsa_block_int8(
            x.data_ptr(), ln_scale_q.data_ptr(), ln_bias_q.data_ptr(),
            wqkv_q_t.data_ptr(), sqkv_eff.data_ptr(), bqkv_eff.data_ptr(),
            wo_q_t.data_ptr(), so_eff.data_ptr(), bo.data_ptr(),
            gamma.data_ptr(), qk8.data_ptr(), v.data_ptr(), ctx8.data_ptr(),
            out.data_ptr(), b, n, d, num_heads, float(ln_eps),
            float(cs) * LOG2E,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mhsa_int8 kernel launch failed: CUDA error {rc}")
    fused_mhsa_block_int8.launches += 1
    return out


fused_mhsa_block_int8.launches = 0
