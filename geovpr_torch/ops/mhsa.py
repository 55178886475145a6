"""Fused pre-LN attention half-blocks and their plain versions: kernel K1
(bf16 and f32 serving), kernel K2 (w8a8 serving) and, below, the training
half-block's kernels K8a (forward), K8b and K8c (backward), in bf16 and
f32.

    out = x + gamma * (MHSA(LN(x)) @ Wo + bo)

The port of `geovpr/ops/pallas_mhsa.py::fused_mhsa_block` (serving forward),
with the same signature and layouts: x (B, N, D); wqkv (D, 3D) with q|k|v
column blocks; wo (D, D); gamma (D,) LayerScale. On a CUDA tensor the
wrapper launches the hand-written Hopper kernel in `geovpr_torch/csrc/mhsa.cu`
(bf16) or its f32 form in `geovpr_torch/csrc/f32_serving.cu` (a model built
with compute_dtype="float32"), or raises; on a CPU tensor it runs
`mhsa_block_reference`, the plain PyTorch version of the same arithmetic
(the JAX oracle `_mhsa_block_xla`).
"""

from __future__ import annotations

import math

import torch

from geovpr_torch.ops.quant import (amax_into, attn_mode, check_devices,
                                    check_int8_kernel_args, check_shapes,
                                    int8_attn_dtype_rule,
                                    int8_resid_reference, layer_norm_f32,
                                    ln_quant_reference, mode_constants,
                                    qkv_buffers, qkv_part_reference,
                                    round_clip_int8, serving_dtype_error,
                                    training_dtype_error)
from geovpr_torch.ops.swin_block import (_heads, _ln_parts, _proj, _stream,
                                         _unheads)

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
    return _mhsa_forward(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma,
                         num_heads, ln_eps, calib)[0]


def _mhsa_forward(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma,
                  num_heads, ln_eps, calib=None):
    """The plain half-block: out, qkv (B, N, 3D) and ctx (B, N, D)."""
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
    return (out * gamma.float() + xf).to(dt), qkv, o


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
    CUDA tensors launch the kernel (bf16 or f32 activations and matrices,
    `k1_dtype_error`; f32 vectors, contiguous, head dim 64, forward only) or
    raise."""
    got = _check(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma, num_heads)
    if x.device.type == "cpu":
        return mhsa_block_reference(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                    gamma, num_heads, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, *got.values())):
        raise RuntimeError(
            "fused_mhsa_block is the serving forward (K1) and has no "
            "backward: under grad call fused_mhsa_block_train (K8a-K8c), or "
            "run the forward under torch.inference_mode()")
    _check_cuda_args({"x": x, **got}, x.shape[-1], num_heads,
                     k1_dtype_error)
    out = _launch_k1(x, got, num_heads, ln_eps)[0]
    fused_mhsa_block.launches += 1
    return out


# K1.f32's attention launch (and so K8a.f32's) keeps a 32-row query tile's
# score rows in shared memory up to this N, two CTAs an SM (FV_MAX_N in
# `csrc/f32_serving.cu`, which `geovpr_mhsa_f32_rows_max_n` returns)
K1_F32_ROWS_MAX_N = 564


def k1_f32_attention_route(n: int) -> str:
    """The kernel that runs K1.f32's (and K8a.f32's) attention launch on
    sequences of n tokens, a rule of shape between two hand-written
    kernels: "rows_on_chip" (`f32_vit_attn_kernel`: q k^T once into the
    score rows in shared memory, their exact max and sums, then E V) up to
    K1_F32_ROWS_MAX_N tokens (DINOv2 at up to 322 px; every preset's N =
    257, at 224 px, among them);
    "streamed" (`f32_attn_kernel`'s FA_VIT mode: two passes over the key
    tiles, a running max and sum, then P V) past it."""
    if n <= 0:
        raise ValueError(f"a sequence of {n} tokens")
    return "rows_on_chip" if n <= K1_F32_ROWS_MAX_N else "streamed"


# the f32 attention launches of K1's wrapper calls (K1.f32 and K8a.f32) by
# `k1_f32_attention_route`
K1_F32_ROUTE_LAUNCHES = {"rows_on_chip": 0, "streamed": 0}


def _launch_k1(x, got: dict, num_heads: int, ln_eps: float):
    """K1's launches on a checked bf16 or f32 CUDA stream x (B, N, D):
    out and the qkv (B, N, 3D; post-bias, unscaled) and ctx (B, N, D) that
    K1 writes to device memory between its launches."""
    b, n, d = x.shape
    qkv = torch.empty((b, n, 3 * d), dtype=x.dtype, device=x.device)
    ctx = torch.empty_like(x)
    out = torch.empty_like(x)
    lib, args = _k1_args(x, got, num_heads, ln_eps, (qkv, ctx, out))
    entry = (lib.geovpr_mhsa_block_f32 if x.dtype == torch.float32
             else lib.geovpr_mhsa_block_bf16)
    with torch.cuda.device(x.device):
        rc = entry(*args, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"mhsa kernel launch failed: CUDA error {rc}")
    if x.dtype == torch.float32:
        K1_F32_ROUTE_LAUNCHES[k1_f32_attention_route(n)] += 1
    return out, qkv, ctx


def _k1_args(x, got: dict, num_heads: int, ln_eps: float, bufs):
    """The library and K1's C arguments (but the stream) for x and the
    (qkv, ctx, out) buffers `bufs`; the f32 form takes any D = 64 H."""
    b, n, d = x.shape
    if x.dtype == torch.float32:
        from geovpr_torch.ops._build import library_on
        lib, max_dim = library_on(x.device.index,
                                  "geovpr_f32_serving_init"), d
    else:
        lib, max_dim = _kernel_library(x.device.index)
    if d > max_dim:
        raise ValueError(f"D={d} exceeds the largest D the kernels take "
                         f"({max_dim})")
    ptrs = [x] + [got[k] for k in ("ln_scale", "ln_bias", "wqkv", "bqkv",
                                   "wo", "bo", "gamma")] + list(bufs)
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("K1 reads its tensors by TMA and 16-byte loads: "
                         "each must start 16-byte aligned")
    return lib, (*(t.data_ptr() for t in ptrs), b, n, d, num_heads,
                 float(ln_eps))


K1_PARTS = ("layernorm", "qkv_gemm", "attention", "out_proj")


def k1_launch_part(part: int, x, got: dict, num_heads: int, ln_eps: float,
                   bufs) -> None:
    """One of K1's four launches (an index into K1_PARTS) alone on a
    checked bf16 or f32 CUDA stream x and the (qkv, ctx, out) buffers
    `bufs` of an earlier call, whose contents it reads. chip_smoke.py times
    K1's launches one by one with it; it counts no launch."""
    lib, args = _k1_args(x, got, num_heads, ln_eps, bufs)
    entry = (lib.geovpr_mhsa_f32_parts if x.dtype == torch.float32
             else lib.geovpr_mhsa_block_parts)
    with torch.cuda.device(x.device):
        rc = entry(*args, part, part, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"mhsa kernel launch failed: CUDA error {rc}")


fused_mhsa_block.launches = 0


# ------------------------------------------------------------------- K2 ----
#
# The w8a8 half-block: the port of `geovpr/ops/pallas_mhsa.py::
# fused_mhsa_block_int8` in its three modes (`quant.ATTN_MODES`), on the
# arguments `DinoV2Block`'s int8 fold produces (`geovpr/models/dinov2.py:
# 201-249`). As in K3 the int8 weights are (out, in): wqkv_q_t (3D, D) and
# wo_q_t (D, D). `cs` is the natural-log score constant a_q a_k dh^-0.5, as
# `_attention_int8` takes it; the kernel works in the exp2 domain and the
# wrapper multiplies by log2(e), the factor JAX's caller applies
# (`dinov2.py:267`). `cpv` = a_v / (127 a_ctx) and `cpl` = a_v / a_ctx
# dequantise the int8 P.V product and the split-off last key.

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
    """Plain PyTorch version of K2 in all three modes of
    `fused_mhsa_block_int8`: `cs` given (int8 q.k^T scores, bf16 P.V; the
    default), `cs` and `cpv`, `cpl` given (int8 P.V), `cs` None (bf16
    scores). Rounding points as JAX's kernel body `_mhsa_kernel_v3_int8`
    (LN -> int8, the qkv dequant, the attention, ctx -> int8 once, out in
    f32), its attention as `vit_attention8_reference` says. The XLA
    fallback `DinoV2Block._attention_int8` normalises p before rounding it
    (and in bf16 scores rounds q before its scale), which on an H100 moved
    ~5% of the int8 contexts of a DINOv2-B block by one step against the
    kernel; this way kernel and plain version differ only in summation
    order. Composed of the plain parts of K2's four launches."""
    b, n, d = x.shape
    mode = attn_mode(cs, cpv)
    xq = ln_quant_reference(x, ln_scale_q, ln_bias_q, ln_eps)
    qk, v = qkv_part_reference(xq, wqkv_q_t, sqkv_eff, bqkv_eff, mode,
                               (d // num_heads) ** -0.5 * LOG2E)
    ctx8 = vit_attention8_reference(qk, v, num_heads, n, cs, cpv, cpl)
    out = int8_resid_reference(ctx8, wo_q_t, so_eff, bo, x.reshape(b * n, d),
                               gamma=gamma)
    return out.reshape(b, n, d)


def fused_mhsa_block_int8(x: torch.Tensor, ln_scale_q: torch.Tensor,
                          ln_bias_q: torch.Tensor, wqkv_q_t: torch.Tensor,
                          sqkv_eff: torch.Tensor, bqkv_eff: torch.Tensor,
                          wo_q_t: torch.Tensor, so_eff: torch.Tensor,
                          bo: torch.Tensor, gamma: torch.Tensor,
                          num_heads: int, ln_eps: float = 1e-6,
                          cs=None, cpv=None, cpl=None) -> torch.Tensor:
    """w8a8 fused attention half-block. CPU tensors run the plain version;
    CUDA tensors launch K2 in the mode of (cs, cpv), in the form of x's
    dtype (bf16 or f32 x, int8 matrices, f32 vectors: `k2_dtype_error`;
    contiguous, head dim 64, forward only) or raise."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, D), got {tuple(x.shape)}")
    b, n, d = x.shape
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    mode = attn_mode(cs, cpv)
    if mode == "int8_pv" and cpl is None:
        raise ValueError("int8 P.V takes cpl (the last key's constant) too")
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
    mats = {k: got[k] for k in ("wqkv_q_t", "wo_q_t")}
    vecs = {k: v for k, v in got.items() if k not in mats}
    check_int8_kernel_args(x, mats, vecs, k2_dtype_error)
    err = k2_shape_error(d, num_heads)
    if err:
        raise ValueError(err)
    bufs = k2_buffers(x, mode)
    lib, args = _k2_args(x, got, num_heads, ln_eps, cs, cpv, cpl, bufs)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_mhsa_int8_parts(*args, 0, len(K2_PARTS) - 1,
                                        _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"mhsa_int8 kernel launch failed: CUDA error {rc}")
    fused_mhsa_block_int8.launches += 1
    return bufs[3]


# K2's type rule on CUDA (`quant.int8_attn_dtype_rule`)
k2_dtype_error = int8_attn_dtype_rule("K2")


def k2_shape_error(d: int, num_heads: int) -> str | None:
    """The rule of K2's kernels (`csrc/mhsa_int8.cu`), or None where they
    take the shape: head dim 64 (the attention's q8 and k8 boxes are one
    head of 64 bytes) and D <= 1024 (the LN-quant pass stages a row in one
    warp)."""
    if d % num_heads or d // num_heads != _KERNEL_HEAD_DIM:
        return (f"K2 takes head dim {_KERNEL_HEAD_DIM}, got D={d}, "
                f"{num_heads} heads")
    if d > 1024:
        return f"K2 takes D <= 1024, got D={d}"
    return None


def k2_buffers(x: torch.Tensor, mode: str = "int8_scores") -> tuple:
    """K2's scratch and output for x (B, N, D) in `mode`: what the QKV
    launch writes (`quant.qkv_buffers`), ctx8 (B*N, D) int8
    (the LN-quant rows until the attention writes it) and out."""
    m, d = x.shape[0] * x.shape[1], x.shape[-1]
    return (*qkv_buffers(m, d, mode, x.device),
            torch.empty((m, d), dtype=torch.int8, device=x.device),
            torch.empty_like(x))


_K2_ARGS = ("ln_scale_q", "ln_bias_q", "wqkv_q_t", "sqkv_eff", "bqkv_eff",
            "wo_q_t", "so_eff", "bo", "gamma")
K2_PARTS = ("ln_quant", "qkv_gemm", "attention", "out_proj")


def _k2_args(x, got: dict, num_heads: int, ln_eps: float, cs, cpv, cpl,
             bufs):
    """The library and K2's C arguments up to the form of x's dtype (but
    the launches and the stream) for a checked CUDA x, its arguments `got`
    by name and the (qk, v, ctx8, out) buffers `bufs` of the mode of (cs,
    cpv)."""
    from geovpr_torch.ops._build import library_on
    lib = library_on(x.device.index, "geovpr_mhsa_int8_init")
    ptrs = [x] + [got[k] for k in _K2_ARGS] + list(bufs)
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("K2 reads its tensors by TMA and 16-byte loads: "
                         "each must start 16-byte aligned")
    b, n, d = x.shape
    return lib, (*(t.data_ptr() for t in ptrs), b, n, d, num_heads,
                 float(ln_eps), *mode_constants(
                     cs, cpv, cpl, d // num_heads,
                     lambda c: float(c) * LOG2E),
                 int(x.dtype == torch.float32))


def k2_launch_part(part: int, x, ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff,
                   bqkv_eff, wo_q_t, so_eff, bo, gamma, num_heads: int,
                   ln_eps: float = 1e-6, cs=None, cpv=None, cpl=None, *,
                   bufs) -> None:
    """One of K2's four launches (an index into K2_PARTS) alone, in the
    mode of (cs, cpv), on the CUDA arguments of `fused_mhsa_block_int8` and
    the `k2_buffers` of that mode `bufs`, whose contents from an earlier
    call it reads. chip_smoke.py times K2's launches one by one with it and
    the card tests check each against its plain part; it counts no
    launch."""
    got = dict(zip(_K2_ARGS, (ln_scale_q, ln_bias_q, wqkv_q_t, sqkv_eff,
                              bqkv_eff, wo_q_t, so_eff, bo, gamma)))
    err = k2_shape_error(x.shape[-1], num_heads)
    if err:
        raise ValueError(err)
    lib, args = _k2_args(x, got, num_heads, ln_eps, cs, cpv, cpl, bufs)
    with torch.cuda.device(x.device):
        rc = lib.geovpr_mhsa_int8_parts(*args, part, part, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"mhsa_int8 kernel launch failed: CUDA error {rc}")


def vit_attention8_reference(qk, v, num_heads: int, n: int, cs, cpv=None,
                             cpl=None):
    """Plain version of K2's attention launch: ctx8 (B*N, D) int8 from the
    QKV launch's (qk, v) (`qkv_part_reference`) of images of N tokens, in
    the mode of (cs, cpv), with the softmax of JAX's kernel body
    (`_stage_split_attention[_qk8]` with `skip_max`, `pallas_mhsa.py:
    107-220`):
    - int8 scores: s = (q8 k8^T) cs log2(e), exact int32 sums rounded
      once; p = exp2(min(s, 100)) with no max-shift, rounded to bf16 for
      P.V; the f32 row sum divides the context;
    - bf16 scores: s = f32(q k^T) of the bf16 q (scale folded in) and k,
      then as int8 scores;
    - int8 P.V: s as int8 scores; p = exp2(s - max_j s) over every key;
      z the f32 sum of p; the first N - 1 keys' p rounded to 127ths and
      multiplied by int8 v exactly, the last key's p kept in f32 (JAX's
      key split): ctx = (ci cpv + (p_last cpl) v_last) / z.
    The context is rounded once to int8. JAX keeps the last key's p in f32
    in every mode; here it is rounded with the rest except in int8 P.V."""
    mode = attn_mode(cs, cpv)
    d = qk.shape[-1] // (2 if mode == "int8_scores" else 3)
    m = qk.shape[0]
    b = m // n

    def heads(t):
        return t.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)

    q, k = heads(qk[:, :d]), heads(qk[:, d:2 * d])
    if mode == "bf16_scores":
        s = _mm(q, k.transpose(-1, -2))
    else:
        cs2 = torch.tensor(float(cs) * LOG2E, dtype=torch.float32)
        s = _exact_bmm(q, k.transpose(-1, -2)) * cs2.to(qk.device)
    if mode == "int8_pv":
        v8 = heads(qk[:, 2 * d:])
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        z = p.sum(-1, keepdim=True)
        pi = torch.round(p[..., :n - 1] * 127.0).to(torch.int8)
        ci = _exact_bmm(pi, v8[..., :n - 1, :])
        ctx = (ci * cpv + (p[..., n - 1:] * cpl) * v8[..., n - 1:, :].float()
               ) / z
    else:
        p = torch.exp2(torch.clamp(s, max=100.0))
        vh = heads(qk[:, 2 * d:] if mode == "bf16_scores" else v)
        ctx = _mm(p.to(torch.bfloat16), vh) / p.sum(-1, keepdim=True)
    return round_clip_int8(ctx.transpose(1, 2).reshape(m, d))


fused_mhsa_block_int8.launches = 0


# ---------------------------------------------------------- K8a/b/c ----
#
# The training half-block, out = x + gamma * (MHSA(LN(x)) @ Wo + bo), and
# its structured backward: the port of `fused_mhsa_block`'s custom VJP
# (`pallas_mhsa.py:931-1015`), its forward kernel `_fused_mhsa_pallas_train`
# (K8a), the attention-core backward `_attn_bwd_pallas` (K8b) and the
# all-in-one backward `_mhsa_bwd_all_pallas` (K8c). The residuals are qkv
# (B, N, 3D; post-bias, unscaled) and ctx (B, N, D), unpadded: the kernels
# mask the keys past N, so JAX's padding of N to 16 rows has no
# counterpart. K8a on the card is K1's launches (`csrc/mhsa.cu`), which
# write qkv and ctx to device memory anyway: the training forward keeps
# them. K8b and K8c are `csrc/mhsa_train.cu`; K1's attention and their p
# recompute share `csrc/vit_attn.cuh`. A model built with
# compute_dtype="float32" trains on their f32 forms: K1's f32 launches
# (`csrc/f32_serving.cu`) and `csrc/f32_train.cu`, chosen by x.dtype as
# K1's wrapper chooses (`k8_dtype_error`). The kernels and the plain versions
# round where JAX's masked bodies round (`_mhsa_train_kernel`,
# `_attn_bwd_kernel`, `_mhsa_bwd_all_kernel`) and its split composition
# (`:971-1012`) rounds.


def bwd_all_ok(d: int) -> bool:
    """JAX's gate for the all-in-one backward (`_bwd_all_ok`,
    `pallas_mhsa.py:1226-1237`): its f32 dWqkv (D, 3D) and dWo (D, D)
    accumulators and six D vectors within 11 MiB. It holds at base-14 (D =
    768, K8c) and fails at large-14 (D = 1024), where the split backward runs
    K8b, in bf16 and in f32 alike. JAX's second clause, which sends an f32
    stream with NP D 4 > 512 KiB to the split route, is not copied: it is a
    TPU VMEM limit (the whole stream resident in VMEM), and the card's K8c
    streams its rows in either dtype."""
    return (4 * d * d + 6 * d) * 4 <= 11 * 1024 * 1024


def k8b_shape_error(d: int, num_heads: int) -> str | None:
    """The rule of K8b's core (`csrc/mhsa_train.cu`), or None where it
    takes the shape: head dim 64 (every DINOv2 variant's), any N (the keys
    stream through a ring of tiles)."""
    if num_heads <= 0 or d % num_heads or d // num_heads != _KERNEL_HEAD_DIM:
        return (f"K8b takes head dim {_KERNEL_HEAD_DIM}, got D={d}, "
                f"{num_heads} heads")
    return None


def k8c_shape_error(d: int, num_heads: int) -> str | None:
    """The rule of K8c (`csrc/mhsa_train.cu`), or None where it takes the
    shape: K8b's, and D where `bwd_all_ok` holds (the split backward with
    K8b takes the wider blocks; its LN VJP holds D <= 832 in a warp's
    registers)."""
    err = k8b_shape_error(d, num_heads)
    if err:
        return err.replace("K8b", "K8c")
    if not bwd_all_ok(d):
        return (f"K8c takes D where bwd_all_ok holds (the split backward "
                f"with K8b takes the wider blocks), got D={d}")
    return None


def mhsa_train_fwd_reference(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma,
                             num_heads: int, ln_eps: float = 1e-6):
    """Plain K8a: out (B, N, D) and the residuals qkv (B, N, 3D) and ctx
    (B, N, D), all in x.dtype, rounded where `_mhsa_train_kernel` rounds
    (the LN output, qkv, p after its normalisation, ctx, out): the
    arithmetic of `mhsa_block_reference`."""
    return _mhsa_forward(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma,
                         num_heads, ln_eps)


def mhsa_attn_bwd_core_reference(qkv, da, num_heads: int):
    """Plain K8b: qkv (B, N, 3D) and da = dL/dctx (B, N, D) -> dqkv (B, N,
    3D) in qkv.dtype, with p recomputed (f32, max-shifted, normalised) and
    rounded as `_attn_bwd_kernel` rounds: p to the stream dtype for dv =
    p^T da, ds = p (dp - sum(dp p)) in f32 and ds * dh^-0.5 to the stream
    dtype before dq = ds k and dk = ds^T q; dq, dk, dv each once."""
    d = da.shape[-1]
    dt = qkv.dtype
    scale = (d // num_heads) ** -0.5
    q, k, v = (_heads(t, num_heads) for t in qkv.split(d, dim=-1))
    dah = _heads(da, num_heads)
    p = torch.softmax(_mm(q, k.transpose(-1, -2)) * scale, dim=-1)
    dp = _mm(dah, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsb = (ds * scale).to(dt)
    grads = (_mm(dsb, k), _mm(dsb.transpose(-1, -2), q),
             _mm(p.to(dt).transpose(-1, -2), dah))
    return torch.cat([_unheads(t).to(dt) for t in grads],
                     dim=-1).reshape(qkv.shape)


def vit_bwd_product_reference(a, w):
    """Plain version of K8c's da = dy Wo^T and dh = dqkv Wqkv^T launches:
    a (M, K) times the transpose of an (in, out) weight w (N, K), f32
    accumulation, rounded once to a's dtype."""
    return _proj(a, w.t().contiguous()).to(a.dtype)


def vit_weight_grad_reference(a, b, chunk: int | None = None):
    """Plain version of K8c's dWo = ctx^T dy and dWqkv = h^T dqkv launches:
    a^T b in f32 over the rows of a (M, C) and b (M, N). With `chunk`, as
    the kernel sums: one f32 partial per `chunk` rows, the partials added
    in order (`swin_block.wgrad_chunk` gives the kernel's chunk)."""
    if chunk is None:
        return _proj(a.t().contiguous(), b)
    out = _proj(a[:chunk].t().contiguous(), b[:chunk])
    for i in range(chunk, a.shape[0], chunk):
        out = out + _proj(a[i:i + chunk].t().contiguous(), b[i:i + chunk])
    return out


def vit_dgamma_reference(ctx, wo, bo, gf, block: int | None = None):
    """Plain version of K8c's dgamma launch: sum over the rows of gf (M, D,
    f32) times the recomputed y = ctx Wo + bo in f32. With `block`, as the
    kernel sums: one partial per `block` rows (K8C_GY_ROWS), added in
    order."""
    gy = gf * (_proj(ctx, wo) + bo.float())
    if block is None:
        return gy.sum(0)
    out = gy[:block].sum(0)
    for i in range(block, gy.shape[0], block):
        out = out + gy[i:i + block].sum(0)
    return out


def vit_ln_vjp_reference(dh, xhat, rstd, ln_scale, gf):
    """Plain version of K8c's LN VJP launch: from dh (M, D), the LN
    recompute's xhat and 1/std and gf = g in f32, dx = g + dx_ln in f32
    (before its rounding), dls and dlb."""
    dhf = dh.float()
    dls = (dhf * xhat).sum(0)
    dlb = dhf.sum(0)
    dxhat = dhf * ln_scale.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True)) + gf
    return dx, dls, dlb


# The rows of one partial sum of K8c's dgamma launch (a consumer
# warpgroup's rows of the GEMM that recomputes y = ctx Wo + bo)
K8C_GY_ROWS = 64


def mhsa_train_bwd_reference(x, ln_scale, ln_bias, wqkv, wo, bo, gamma, qkv,
                             ctx, g, num_heads: int, ln_eps: float = 1e-6,
                             split: bool = False, core=None):
    """The plain structured backward from K8a's residuals and g = dL/dout
    (B, N, D). Returns dx (B, N, D) in x.dtype and dls, dlb, dwqkv, dbqkv,
    dwo, dbo, dgamma in f32. `split=False` is the all-in-one form
    (`_mhsa_bwd_all_kernel`: the LN VJP written out, dx = g + dx_ln summed
    in f32); `split=True` the split composition of the blocks where
    `bwd_all_ok` fails (`pallas_mhsa.py:971-1012`: the LN VJP by autograd of
    the LN, its dx_ln in the stream dtype before the f32 sum with g).
    `core(qkv, da, num_heads)` gives dqkv: the plain K8b by default, the K8b
    kernel on the card's split route. Both forms round dy = g gamma, da, the
    recomputed LN output and dh to the stream dtype."""
    b, n, d = x.shape
    dt = x.dtype
    m = b * n
    gf = g.reshape(m, d).float()
    dy = gf * gamma.float()
    dyb = dy.to(dt)
    da = vit_bwd_product_reference(dyb, wo)
    dqkv = (core or mhsa_attn_bwd_core_reference)(
        qkv, da.reshape(b, n, d), num_heads).reshape(m, 3 * d)
    c2 = ctx.reshape(m, d)
    dgamma = vit_dgamma_reference(c2, wo, bo, gf)
    dwo = vit_weight_grad_reference(c2, dyb)
    dbo = dy.sum(0)
    x2 = x.reshape(m, d)
    if split:
        with torch.enable_grad():
            xs, ls, lb = (t.detach().requires_grad_() for t in
                          (x2, ln_scale, ln_bias))
            h = _ln_parts(xs, ls, lb, ln_eps, dt)[2]
            dh = vit_bwd_product_reference(dqkv, wqkv)
            dx_ln, dls, dlb = torch.autograd.grad(h, (xs, ls, lb), dh)
        h = h.detach()
        dx = gf + dx_ln.float()
    else:
        xhat, rstd, h = _ln_parts(x2, ln_scale, ln_bias, ln_eps, dt)
        dx, dls, dlb = vit_ln_vjp_reference(
            vit_bwd_product_reference(dqkv, wqkv), xhat, rstd, ln_scale, gf)
    dwqkv = vit_weight_grad_reference(h, dqkv)
    return (dx.to(dt).reshape(b, n, d), dls.float(), dlb.float(), dwqkv,
            dqkv.float().sum(0), dwo, dbo, dgamma)


def k1_dtype_error(dtypes: dict) -> str | None:
    """K1's type rule on CUDA (name -> dtype of its tensors): x, wqkv and
    wo all bf16 (`csrc/mhsa.cu`) or all f32 (`csrc/f32_serving.cu`), the
    vectors f32. The message, or None where the rule holds."""
    return serving_dtype_error("K1", dtypes, ("x", "wqkv", "wo"))


# the tensors of K8a-K8c that share one dtype: the stream, the matrices,
# the residuals and the gradients
_K8_STREAM = ("x", "wqkv", "wo", "qkv", "ctx", "g", "da")


def k8_dtype_error(dtypes: dict) -> str | None:
    """The type rule of the training kernels K8a-K8c on CUDA (name -> dtype
    of the tensors a wrapper takes): the stream, matrices, residuals and
    gradients (`_K8_STREAM`) all bf16 (`csrc/mhsa.cu`,
    `csrc/mhsa_train.cu`) or all f32 (`csrc/f32_serving.cu`,
    `csrc/f32_train.cu`), every other tensor (the vectors) f32. The
    message, naming the tensor that breaks the rule, or None where it
    holds (`quant.training_dtype_error`)."""
    return training_dtype_error("K8", dtypes, _K8_STREAM)


def _check_cuda_args(tensors: dict, d: int, num_heads: int,
                     dtype_error=k8_dtype_error) -> None:
    """What K1 (`dtype_error=k1_dtype_error`) and the training kernels take
    on CUDA: the types of `dtype_error`, all contiguous and 16-byte aligned
    (TMA, float4 loads); head dim 64."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    err = dtype_error({k: t.dtype for k, t in tensors.items()})
    if err:
        raise TypeError(err)
    if d // num_heads != _KERNEL_HEAD_DIM:
        raise ValueError(f"the kernels take head dim "
                         f"{_KERNEL_HEAD_DIM}, got D={d}, {num_heads} heads")


def _check_residuals(x, tensors: dict, num_heads: int) -> None:
    """The shapes and devices of K8's residuals and gradients on a (B, N,
    D) stream (ValueError on any other)."""
    b, n, d = x.shape
    if d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")
    want = {"g": (b, n, d), "ctx": (b, n, d), "da": (b, n, d),
            "qkv": (b, n, 3 * d), "wqkv": (d, 3 * d), "wo": (d, d),
            "ln_scale": (d,), "ln_bias": (d,), "bo": (d,), "gamma": (d,)}
    check_shapes({k: want[k] for k in tensors}, tensors)
    check_devices(x, tensors)


# the C entries of K8b and K8c by stream dtype: the core, the whole
# backward, its launches one by one, the sizes of its scratch and of the
# core's planes
_K8_ENTRIES = {
    torch.bfloat16: ("geovpr_vit_train_bwd_core", "geovpr_vit_train_bwd_all",
                     "geovpr_vit_train_bwd_all_parts",
                     "geovpr_vit_train_scratch_floats",
                     "geovpr_vit_core_scratch_elems"),
    torch.float32: ("geovpr_vit_f32_bwd_core", "geovpr_vit_f32_bwd_all",
                    "geovpr_vit_f32_bwd_all_parts",
                    "geovpr_vit_f32_scratch_floats",
                    "geovpr_vit_f32_core_scratch_floats")}


def _train_entries(device, dtype=torch.bfloat16) -> dict:
    """The C entries of K8b's and K8c's form for a `dtype` stream
    (`_K8_ENTRIES`) by their role: core, all, parts, scratch, core_scratch;
    the built library's shared-memory limits of that form raised on
    `device` first (once per device)."""
    from geovpr_torch.ops._build import library_on
    lib = library_on(device.index, "geovpr_f32_train_init"
                     if dtype == torch.float32 else "geovpr_vit_train_init")
    return dict(zip(("core", "all", "parts", "scratch", "core_scratch"),
                    (getattr(lib, n) for n in _K8_ENTRIES[dtype])))


def fused_mhsa_train_fwd(x: torch.Tensor, ln_scale: torch.Tensor,
                         ln_bias: torch.Tensor, wqkv: torch.Tensor,
                         bqkv: torch.Tensor, wo: torch.Tensor,
                         bo: torch.Tensor, gamma: torch.Tensor,
                         num_heads: int, ln_eps: float = 1e-6):
    """K8a: out (B, N, D), qkv (B, N, 3D) and ctx (B, N, D). CPU tensors
    run the plain version; CUDA tensors launch K1's kernels (bf16, or their
    f32 form for an f32 set, `k8_dtype_error`), keeping the qkv and ctx they
    write as the residuals, or raise."""
    got = _check(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma, num_heads)
    if x.device.type == "cpu":
        return mhsa_train_fwd_reference(x, ln_scale, ln_bias, wqkv, bqkv, wo,
                                        bo, gamma, num_heads, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda_args({"x": x, **got}, x.shape[-1], num_heads)
    res = _launch_k1(x, got, num_heads, ln_eps)
    fused_mhsa_train_fwd.launches += 1
    return res


fused_mhsa_train_fwd.launches = 0


def _core_scratch(entries: dict, b: int, n: int, num_heads: int, device,
                  dtype=torch.bfloat16):
    """The core's scratch, which its dq launch writes and its dk/dv launch
    reads: for a bf16 stream the bf16 planes of bf16(p) and ds_b, (B H, N,
    N) with rows padded to a multiple of 8; for an f32 one the f32 planes of
    p and ds dh^-0.5, rows padded to a multiple of 4. `entries` as
    `_train_entries` gives them."""
    return torch.empty(entries["core_scratch"](b, n, num_heads), dtype=dtype,
                       device=device)


def fused_mhsa_bwd_core(qkv: torch.Tensor, da: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """K8b: qkv (B, N, 3D), da (B, N, D) -> dqkv (B, N, 3D). CPU tensors run
    the plain version; CUDA tensors launch K8b (`k8b_shape_error`'s shapes;
    both bf16 or both f32, `k8_dtype_error`) or raise."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    _check_residuals(da, {"qkv": qkv}, num_heads)
    if qkv.device.type == "cpu":
        return mhsa_attn_bwd_core_reference(qkv, da, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    _check_cuda_args({"qkv": qkv, "da": da}, d, num_heads)
    err = k8b_shape_error(d, num_heads)
    if err:
        raise ValueError(err)
    entries = _train_entries(qkv.device, qkv.dtype)
    dqkv = torch.empty_like(qkv)
    pds = _core_scratch(entries, b, n, num_heads, qkv.device, qkv.dtype)
    with torch.cuda.device(qkv.device):
        rc = entries["core"](
            qkv.data_ptr(), da.data_ptr(), dqkv.data_ptr(), pds.data_ptr(),
            b, n, d, num_heads, float((d // num_heads) ** -0.5),
            _stream(qkv.device))
    if rc != 0:
        raise RuntimeError(f"vit_train_bwd_core launch failed: CUDA error "
                           f"{rc}")
    fused_mhsa_bwd_core.launches += 1
    return dqkv


fused_mhsa_bwd_core.launches = 0


# K8c's launches, as `geovpr_vit_train_bwd_all_parts` numbers them (a
# product's reduce of its partial sums runs with it)
K8C_PARTS = ("dy", "dbo", "da", "dwo", "dgamma", "core", "ln_rows", "dwqkv",
             "dbqkv", "dh", "ln_vjp")
_K8C_OUTS = ("dx", "dls", "dlb", "dwqkv", "dbqkv", "dwo", "dbo", "dgamma")


def k8c_buffers(x: torch.Tensor, num_heads: int) -> dict:
    """K8c's scratch and outputs for a CUDA stream x (B, N, D), bf16 or
    f32, by name: dy, da (dh once the dh launch has run), h, dqkv, stats,
    pds (the core's planes, `_core_scratch`, in x.dtype), part and the
    outputs `fused_mhsa_bwd_all` returns."""
    b, n, d = x.shape
    entries = _train_entries(x.device, x.dtype)
    dev, m = x.device, b * n

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return dict(
        dy=torch.empty_like(x), da=torch.empty_like(x),
        h=torch.empty_like(x), dx=torch.empty_like(x),
        dqkv=torch.empty((b, n, 3 * d), dtype=x.dtype, device=dev),
        stats=f32(m, 2),
        pds=_core_scratch(entries, b, n, num_heads, dev, x.dtype),
        part=f32(entries["scratch"](b, n, d)),
        dwqkv=f32(d, 3 * d), dbqkv=f32(3 * d), dwo=f32(d, d), dbo=f32(d),
        dgamma=f32(d), dls=f32(d), dlb=f32(d))


def _k8c_args(x, ln_scale, ln_bias, wqkv, wo, bo, gamma, qkv, ctx, g,
              num_heads, ln_eps, bufs: dict):
    """K8c's C arguments (but the first and last launch and the stream)
    for checked CUDA tensors and `k8c_buffers` `bufs`."""
    ptrs = [x, qkv, ctx, g, wqkv, wo, bo, gamma, ln_scale, ln_bias] + [
        bufs[k] for k in ("dy", "da", "dqkv", "h", "stats", "pds", "part",
                          "dx", "dwqkv", "dbqkv", "dwo", "dbo", "dgamma",
                          "dls", "dlb")]
    b, n, d = x.shape
    return (*(t.data_ptr() for t in ptrs), b, n, d, num_heads, float(ln_eps),
            float((d // num_heads) ** -0.5))


def _check_k8c(x, tensors: dict, num_heads: int) -> None:
    """K8c's rule on CUDA tensors (ValueError or TypeError on any other)."""
    d = x.shape[-1]
    _check_cuda_args({"x": x, **tensors}, d, num_heads)
    err = k8c_shape_error(d, num_heads)
    if err:
        raise ValueError(err)


def fused_mhsa_bwd_all(x, ln_scale, ln_bias, wqkv, wo, bo, gamma, qkv, ctx,
                       g, num_heads: int, ln_eps: float = 1e-6):
    """K8c: the whole attention-half backward from K8a's residuals and g =
    dL/dout (B, N, D). Returns dx (B, N, D) and dls, dlb, dwqkv, dbqkv,
    dwo, dbo, dgamma in f32. CPU tensors run the plain all-in-one form;
    CUDA tensors launch K8c (`k8c_shape_error`'s shapes: where
    `bwd_all_ok`; bf16 or f32, `k8_dtype_error`) or raise."""
    tensors = {"ln_scale": ln_scale, "ln_bias": ln_bias, "wqkv": wqkv,
               "wo": wo, "bo": bo, "gamma": gamma, "qkv": qkv, "ctx": ctx,
               "g": g}
    _check_residuals(x, tensors, num_heads)
    if x.device.type == "cpu":
        return mhsa_train_bwd_reference(x, ln_scale, ln_bias, wqkv, wo, bo,
                                        gamma, qkv, ctx, g, num_heads, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_k8c(x, tensors, num_heads)
    bufs = k8c_buffers(x, num_heads)
    args = _k8c_args(x, ln_scale, ln_bias, wqkv, wo, bo, gamma, qkv, ctx, g,
                     num_heads, ln_eps, bufs)
    with torch.cuda.device(x.device):
        rc = _train_entries(x.device, x.dtype)["all"](*args,
                                                       _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"vit_train_bwd_all launch failed: CUDA error "
                           f"{rc}")
    fused_mhsa_bwd_all.launches += 1
    return tuple(bufs[k] for k in _K8C_OUTS)


def k8c_launch_part(part: int, x, ln_scale, ln_bias, wqkv, wo, bo, gamma,
                    qkv, ctx, g, num_heads: int, ln_eps: float = 1e-6, *,
                    bufs) -> None:
    """One of K8c's launches (an index into K8C_PARTS, with the reduce of
    its partial sums) alone, on the CUDA arguments of `fused_mhsa_bwd_all`
    and the `k8c_buffers` `bufs`, whose contents from an earlier call it
    reads. chip_smoke.py times K8c's launches one by one with it and the
    card tests check each against its plain part; it counts no launch."""
    args = _k8c_args(x, ln_scale, ln_bias, wqkv, wo, bo, gamma, qkv, ctx, g,
                     num_heads, ln_eps, bufs)
    with torch.cuda.device(x.device):
        rc = _train_entries(x.device, x.dtype)["parts"](
            *args, part, part, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"vit_train_bwd_all launch failed: CUDA error "
                           f"{rc}")


fused_mhsa_bwd_all.launches = 0


class _MhsaTrain(torch.autograd.Function):
    """K8a forward; K8c backward where `bwd_all_ok`, else the split
    backward (torch products around K8b), as JAX's `bwd` routes
    (`pallas_mhsa.py:946-1012`); `kernels=False` runs the plain versions
    on any device."""

    @staticmethod
    def forward(ctx_, x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma,
                num_heads, ln_eps, kernels):
        fwd = fused_mhsa_train_fwd if kernels else mhsa_train_fwd_reference
        out, qkv, ctx = fwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma,
                            num_heads, ln_eps)
        ctx_.save_for_backward(x, ln_scale, ln_bias, wqkv, wo, bo, gamma, qkv,
                               ctx)
        ctx_.num_heads, ctx_.ln_eps, ctx_.kernels = num_heads, ln_eps, kernels
        ctx_.bqkv_dtype = bqkv.dtype
        return out

    @staticmethod
    def backward(ctx_, g):
        x, ln_scale, ln_bias, wqkv, wo, bo, gamma, qkv, ctx = \
            ctx_.saved_tensors
        args = (x, ln_scale, ln_bias, wqkv, wo, bo, gamma, qkv, ctx,
                g.to(x.dtype).contiguous(), ctx_.num_heads, ctx_.ln_eps)
        split = not bwd_all_ok(x.shape[-1])
        if not ctx_.kernels:
            out = mhsa_train_bwd_reference(*args, split=split)
        elif split:
            out = mhsa_train_bwd_reference(*args, split=True,
                                           core=fused_mhsa_bwd_core)
        else:
            out = fused_mhsa_bwd_all(*args)
        dx, dls, dlb, dwqkv, dbqkv, dwo, dbo, dgamma = out
        return (dx, dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype),
                dwqkv.to(wqkv.dtype), dbqkv.to(ctx_.bqkv_dtype),
                dwo.to(wo.dtype), dbo.to(bo.dtype), dgamma.to(gamma.dtype),
                None, None, None)


def fused_mhsa_block_train(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma,
                           num_heads: int, ln_eps: float = 1e-6,
                           kernels: bool = True) -> torch.Tensor:
    """The differentiable half-block out = x + gamma * (MHSA(LN(x)) Wo +
    bo), (B, N, D): `fused_mhsa_block`'s training form (its custom VJP,
    `pallas_mhsa.py:931-1015`). The matrices' gradients come back in their
    own dtype, as JAX's `.astype(wqkv.dtype)`. On CUDA tensors K8a and K8c
    (or K8b) launch or raise; `kernels=False` takes the plain versions on
    any device."""
    return _MhsaTrain.apply(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, gamma,
                            num_heads, ln_eps, kernels)


def mhsa_attention_unfused(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                           num_heads: int, ln_eps: float = 1e-6):
    """The attention branch before LayerScale, h = proj(MHSA(LN(x))) in
    x.dtype, as torch ops under autograd: JAX's XLA route for a training
    block with DropPath (`geovpr/models/dinov2.py:166-172`, `_attention`),
    which rounds the LN output, q, k, v, p, the context and h to the
    compute dtype; the caller applies LayerScale, DropPath and the
    residual."""
    b, n, d = x.shape
    dt = x.dtype
    h = (layer_norm_f32(x.float(), ln_eps) * ln_scale.float()
         + ln_bias.float()).to(dt)
    qkv = (_mm(h, wqkv) + bqkv.float()).to(dt)
    q, k, v = (_heads(t, num_heads) for t in qkv.split(d, dim=-1))
    s = _mm(q, k.transpose(-1, -2)) * (d // num_heads) ** -0.5
    ctx = _unheads(_mm(torch.softmax(s, dim=-1).to(dt), v)).to(dt)
    return (_mm(ctx, wo) + bo.float()).to(dt).reshape(b, n, d)
