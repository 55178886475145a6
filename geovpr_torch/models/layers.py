"""Shared building blocks (the port of `geovpr.models.layers`).

Parameters are created empty; `init_weights_` fills a whole model from an
explicit `torch.Generator` with the JAX package's initialiser families
(lecun-normal matrices, zero biases, unit norms), or the weight bridge
(`geovpr_torch.models.convert_jax`) loads converted flax variables.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from geovpr_torch.ops import quant
from geovpr_torch.ops.quant import act_scale, amax_into, quantize_weight


@contextlib.contextmanager
def _exact_conv():
    """cuDNN's TF32 off and its deterministic algorithms on inside the
    block, the process-wide settings restored after: torch's default lets
    cuDNN convolve f32 in TF32 (a 10-bit mantissa) and pick a weight
    gradient algorithm that sums in a varying order, so that a training
    step would not repeat bit for bit."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


class _Conv2dF32(torch.autograd.Function):
    """F.conv2d and its backward inside `_exact_conv`."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (bias is not None, stride, padding, dilation, groups)
        with _exact_conv():
            return F.conv2d(x, weight, bias, stride, padding, dilation,
                            groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        has_bias, stride, padding, dilation, groups = ctx.conf
        need = ctx.needs_input_grad
        with _exact_conv():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, weight, [weight.shape[0]] if has_bias else None,
                _pair(stride), _pair(padding), _pair(dilation), False,
                [0, 0], groups, [need[0], need[1], has_bias and need[2]])
        return dx, dw, db, None, None, None, None


def _pair(v) -> list:
    return list(v) if isinstance(v, (tuple, list)) else [v, v]


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride=1, padding=0,
           dilation=1, groups=1) -> torch.Tensor:
    """`F.conv2d`, in full f32 for an f32 x: cuDNN's TF32 off and its
    deterministic algorithms on while the convolution and its backward run
    (`_Conv2dF32`), as the JAX package convolves f32 in f32 and a training
    step repeats bit for bit; other dtypes go to `F.conv2d` as they are.
    The models' convolutions all come here."""
    if x.dtype != torch.float32:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    return _Conv2dF32.apply(x, weight, bias, stride, padding, dilation,
                            groups)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """GELU that is erf-exact in f32 and tanh-approximate in bf16, as
    `geovpr.models.layers.gelu_fast` (a speed/accuracy trade the JAX package
    measured and accepted for bf16; parity tests run f32)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


def normalize_l2(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """L2 normalisation with the norm clamped below by eps (torch
    `F.normalize` semantics, as `geovpr.models.layers.normalize_l2`)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class DropPath(nn.Module):
    """Stochastic depth: drops the whole residual branch per sample in
    training, keeping it scaled by 1/keep (`geovpr.models.layers.DropPath`:
    `where(mask, x / keep, 0)`); identity at eval or rate 0. Draws from
    `self.generator`, which the training step sets (`set_rng`) from (seed,
    step); a caller that sets none draws from torch's default generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None
        self.rows: tuple | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = draw_rows(self.generator, self.rows, (x.shape[0],)
                         + (1,) * (x.dim() - 1), x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """flax `nn.Dropout` semantics: each element kept with probability
    1 - rate and scaled by 1/keep, all zeros at rate 1; identity at eval or
    rate 0. Draws from `self.generator`, as DropPath."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None
        self.rows: tuple | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        mask = draw_rows(self.generator, self.rows, x.shape, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def draw_rows(generator, rows: tuple | None, shape, device) -> torch.Tensor:
    """Uniform [0, 1) draws of `shape`, whose dim 0 is this rank's rows of
    a batch: with `rows` = (offset, global batch) the draw covers the
    global batch and rows [offset, offset + shape[0]) are kept, so every
    rank of a data-parallel step sees the numbers one process would."""
    if rows is None:
        return torch.rand(shape, generator=generator, device=device)
    offset, n = rows
    full = torch.rand((n,) + tuple(shape[1:]), generator=generator,
                      device=device)
    return full[offset:offset + shape[0]]


def set_rng(model: nn.Module, generator: torch.Generator | None,
            rows: tuple | None = None) -> None:
    """Point every DropPath and Dropout of `model` at `generator`; they
    draw from it in forward order, over the global batch where `rows`
    (offset, global batch) places this rank's rows in it."""
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = generator
            m.rows = rows


def remat_call(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """`module(x)` with its activations recomputed in the backward instead
    of kept (`torch.utils.checkpoint`, non-reentrant), as JAX's `nn.remat`
    runs a block (`geovpr/models/dinov2.py:467`, `swin.py:878`). The
    checkpoint restores only torch's default generators for the recompute;
    the explicit generators `set_rng` gives the module's DropPath and
    Dropout are set back to their state at the block's entry here, so the
    recompute draws the masks (over the global batch's `rows` too) that
    the forward drew, as `nn.remat` reuses the same key, and to their
    state before it afterwards. The kernels' autograd Functions keep what
    they save for the backward, so the recompute launches their forward
    again."""
    from torch.utils.checkpoint import checkpoint

    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, (DropPath, Dropout))
                 and m.generator is not None}.values())
    entry = [g.get_state() for g in gens]
    recompute = False

    def run(x):
        nonlocal recompute
        if not recompute:
            recompute = True
            return module(x)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, entry):
            g.set_state(state)
        try:
            return module(x)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return checkpoint(run, x, use_reentrant=False)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer(x)` in x's dtype: a layer held in f32 for training computes
    with its weight and bias cast to the compute dtype, as a flax Dense with
    `dtype` does; a serving layer in x's dtype is called unchanged."""
    w, b = layer.weight, layer.bias
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm with f32 parameters, computed in f32 and rounded back to
    the input dtype (`geovpr.models.dinov2._layer_norm`; eps 1e-6 there,
    not torch's 1e-5 default)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def _init_weights(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(use_running_average=not train, momentum=0.9,
    epsilon=eps, dtype=jnp.float32)` (`geovpr/models/efficientnet.py:
    83-85`), computed in f32 whatever the input dtype and returned in f32.
    Parameters `weight`, `bias` (flax `scale`, `bias`) and buffers
    `running_mean`, `running_var` (flax `batch_stats` `mean`, `var`);
    (B, C, H, W) input.

    Eval mode normalizes with the running statistics. Training mode
    normalizes with the batch's, over (B, H, W) and every row (a padded
    tail row included, as flax sees it), under autograd: flax's fast
    variance, max(E[x^2] - E[x]^2, 0), which is the biased one; then
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias in flax's order.
    The running statistics move as flax moves them, ra = 0.9 ra + 0.1
    batch, the biased variance included (torch's `F.batch_norm` would
    move `running_var` by the unbiased one), in place under no grad: a
    caller that must undo a step (the NaN skip) restores them.

    Under a mesh with more than one data shard (`set_batch_mesh`), the
    batch is the global, data-sharded one, as JAX's mean over a sharded
    batch: the per-channel sums of x and x^2 and the count are
    all-reduced over `data` (under autograd) before the variance is
    formed, so every rank normalizes alike and moves the same running
    statistics."""

    MOMENTUM = 0.9

    def __init__(self, channels: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels,
                                                         device=device))
        self.register_buffer("running_var", torch.ones(channels,
                                                       device=device))
        self.mesh = None

    def _init_weights(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean,
                                self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        # flax's `_compute_stats` with `use_fast_variance`, over (B, H, W)
        x = x.float()
        if self.mesh is not None and self.mesh.axis_size("data") > 1:
            mean, var = self._global_stats(x)
        else:
            mean = x.mean((0, 2, 3))
            var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])

    def _global_stats(self, x: torch.Tensor) -> tuple:
        from geovpr_torch.parallel.mesh import all_reduce_sum_autograd
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c)
        sums = all_reduce_sum_autograd(torch.cat(
            [x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)), count]), self.mesh)
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
        return mean, var


def set_batch_mesh(model: nn.Module, mesh) -> None:
    """Make every BatchNorm of `model` take its training statistics over
    the global batch of `mesh`'s data axis (None: the local batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh


def batch_stat_buffers(model: nn.Module) -> list:
    """Every BatchNorm running statistic of `model`, in module order: the
    float state a training step moves besides the parameters (flax's
    `batch_stats` collection)."""
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]


class ConvBNAct(nn.Module):
    """Conv (no bias, in the compute dtype) -> BatchNorm in f32 -> SiLU on
    that f32 (`geovpr/models/efficientnet.py:56-88`). The input and the
    conv weight are cast to the compute dtype `dtype` for the conv (a
    serving build holds its weight in it, so the cast is a no-op; a
    training build holds it in `param_dtype`, f32, as flax keeps f32
    params); the output is f32. Padding "torch" is symmetric, (k-1)//2 a
    side (torchvision); "tf" is TF-SAME's asymmetric (k//2 - 1, k//2) for
    stride 2 (HF / google checkpoints) and symmetric otherwise."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, use_act: bool = True,
                 conv_padding: str = "torch", bn_eps: float = 1e-3,
                 dtype: torch.dtype = torch.float32, device=None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        half = kernel // 2
        if conv_padding == "tf" and stride == 2:
            lo = half - 1 if half > 0 else 0
            self.pad, sym = (lo, half, lo, half), 0
        elif conv_padding in ("torch", "tf"):
            self.pad, sym = None, (kernel - 1) // 2
        else:
            raise ValueError(f"unknown conv_padding {conv_padding!r}")
        self.use_act = use_act
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding=sym,
                              groups=groups, bias=False,
                              dtype=param_dtype or dtype, device=device)
        self.bn = BatchNorm(out_ch, bn_eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.pad is not None:
            x = F.pad(x, self.pad)
        conv = self.conv
        x = self.bn(conv2d(x, conv.weight.to(self.dtype), None,
                           conv.stride, conv.padding, conv.dilation,
                           conv.groups))
        return F.silu(x) if self.use_act else x


class SqueezeExcite(nn.Module):
    """SE gate (`geovpr/models/layers.py:53-71`, torchvision
    `SqueezeExcitation`): spatial mean (in the input's dtype) -> 1x1 conv
    `fc1` -> SiLU -> 1x1 conv `fc2` -> sigmoid, the convs and the gate in
    the compute dtype `dtype` (weights held in `param_dtype` and cast, as
    `ConvBNAct`), the product in the input's dtype promoted with the
    gate's; (B, C, H, W)."""

    def __init__(self, channels: int, squeeze_channels: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.fc1 = nn.Conv2d(channels, squeeze_channels, 1, dtype=pdt,
                             device=device)
        self.fc2 = nn.Conv2d(squeeze_channels, channels, 1, dtype=pdt,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        s = x.mean(dim=(2, 3), keepdim=True).to(dt)
        s = F.silu(conv2d(s, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        s = conv2d(s, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        return x * torch.sigmoid(s)


def register_quant_buffers(module: nn.Module, specs) -> None:
    """Register the int8 serving state of `module` as buffers named as in
    the JAX package's "quant" collection, at their JAX init values (0-d
    scales and f32 vectors ones or zeros, int8 kernels zeros, (in, out)):
    `specs` holds (name, shape, dtype, fill)."""
    for name, shape, dtype, fill in specs:
        module.register_buffer(name, torch.full(shape, fill, dtype=dtype))


class Mlp(nn.Module):
    """Transformer MLP: Linear -> gelu_fast -> Linear, in the compute dtype
    (`geovpr.models.layers.Mlp`).

    - `calib` (a dict, set by `geovpr_torch.models.quantize`): the float
      path records the amax of its input (`a_in`) and of its activation
      output (`a_mid`), as the JAX `calibrate=True` sow points do.
    - `int8=True`: the w8a8 serving state lives in buffers named as in
      JAX's "quant" collection (`a_in_scale`, `fc1_kernel_q` (in, hidden)
      int8, ...). The int8 forward is the fused half-block (LN -> K3),
      driven by the owning block (`DinoV2Block`) with scales folded once,
      when the state is installed. Called on its own (and not
      calibrating, which runs the float path), it runs JAX's unfused
      arithmetic (`geovpr/models/layers.py:168-182`): `int8_dense`
      -> tanh GELU in f32 -> `int8_dense`, returned in x's dtype.
    """

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int | None = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 int8: bool = False):
        super().__init__()
        out_dim = out_dim or in_dim
        self.int8 = int8
        self.calib: dict | None = None
        self.fc1 = nn.Linear(in_dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_dim, out_dim, dtype=dtype, device=device)
        if int8:
            f32, i8 = torch.float32, torch.int8
            register_quant_buffers(self, (
                ("a_in_scale", (), f32, 1.0), ("a_mid_scale", (), f32, 1.0),
                ("fc1_kernel_q", (in_dim, hidden_dim), i8, 0),
                ("fc1_kernel_scale", (hidden_dim,), f32, 1.0),
                ("fc1_bias", (hidden_dim,), f32, 0.0),
                ("fc2_kernel_q", (hidden_dim, out_dim), i8, 0),
                ("fc2_kernel_scale", (out_dim,), f32, 1.0),
                ("fc2_bias", (out_dim,), f32, 0.0)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8 and self.calib is None:
            h = x.reshape(-1, x.shape[-1]).float()
            h = quant.int8_dense(h, self.a_in_scale, self.fc1_kernel_q,
                                 self.fc1_kernel_scale, self.fc1_bias)
            h = F.gelu(h, approximate="tanh")
            h = quant.int8_dense(h, self.a_mid_scale, self.fc2_kernel_q,
                                 self.fc2_kernel_scale, self.fc2_bias)
            return h.reshape(*x.shape[:-1], -1).to(x.dtype)
        if self.calib is not None:
            amax_into(self.calib, "a_in", x)
        h = gelu_fast(linear(x, self.fc1))
        if self.calib is not None:
            amax_into(self.calib, "a_mid", h)
        return linear(h, self.fc2)

    def quant_state(self, amax: dict) -> dict:
        """The JAX "quant" entries of this Mlp from its calibration amaxes
        (`geovpr/models/quantize.py:34-47`)."""
        w1q, s1 = quantize_weight(self.fc1.weight.t())
        w2q, s2 = quantize_weight(self.fc2.weight.t())
        return {"a_in_scale": act_scale(amax["a_in"]),
                "a_mid_scale": act_scale(amax["a_mid"]),
                "fc1_kernel_q": w1q, "fc1_kernel_scale": s1,
                "fc1_bias": self.fc1.bias.detach().float().cpu(),
                "fc2_kernel_q": w2q, "fc2_kernel_scale": s2,
                "fc2_bias": self.fc2.bias.detach().float().cpu()}

    def int8_args(self, ln_scale, ln_bias, gamma) -> dict:
        """K3's arguments with the static scales folded as
        `geovpr/models/layers.py:148-158` folds them, and the int8 kernels
        transposed to (out, in)."""
        a_in, a_mid = self.a_in_scale, self.a_mid_scale
        return dict(ln_scale_q=ln_scale.float() / a_in,
                    ln_bias_q=ln_bias.float() / a_in,
                    w1q_t=self.fc1_kernel_q.t().contiguous(),
                    s1_eff=a_in * self.fc1_kernel_scale, b1=self.fc1_bias,
                    w2q_t=self.fc2_kernel_q.t().contiguous(),
                    s2_eff=a_mid * self.fc2_kernel_scale, b2=self.fc2_bias,
                    gamma=gamma.float())


def int8_kernel_route(x: torch.Tensor, use_kernels: bool) -> bool:
    """Whether a block's w8a8 attention half runs on its kernel (K2, K5):
    `use_kernels` set and x on CUDA, the counterpart of JAX's `use_pallas`
    on the TPU backend. There the block hands the kernel a bf16 stream and
    casts its output back to x's dtype, as JAX's blocks do around their
    Pallas calls (`geovpr/models/dinov2.py:261-268`, `swin.py:646-657`);
    elsewhere the stream keeps its dtype, as on JAX's XLA fallback."""
    return use_kernels and x.is_cuda


class QuantBlock(nn.Module):
    """The int8 serving state shared by the transformer blocks
    (`DinoV2Block`, `SwinBlock`) and, for its MLP half only,
    `ConvNeXtBlock`: the JAX "quant" collection's attention
    entries as buffers of the same names, the folding of a kernel's static
    scales into non-persistent buffers, once per installed state, and the
    quant entries built from calibration amaxes. A block owns `attn` (with
    `qkv_weight`, `proj_weight`), `norm1` and `mlp`; subclasses fold their
    own kernels' arguments in `fold_int8`."""

    def _init_quant(self, dim: int, int8_attn: bool, int8_mlp: bool) -> None:
        self.int8_attn = int8_attn
        self.calib: dict | None = None
        if int8_attn:
            f32, i8 = torch.float32, torch.int8
            register_quant_buffers(self, (
                *((n, (), f32, 1.0) for n in (
                    "attn_a_x", "attn_a_ctx", "attn_a_q", "attn_a_k",
                    "attn_a_v")),
                ("attn_wqkv_q", (dim, 3 * dim), i8, 0),
                ("attn_wqkv_scale", (3 * dim,), f32, 1.0),
                ("attn_wo_q", (dim, dim), i8, 0),
                ("attn_wo_scale", (dim,), f32, 1.0)))
        if int8_attn or int8_mlp:
            self.register_load_state_dict_post_hook(
                lambda module, _keys: module.fold_int8())

    def fold_int8(self) -> None:
        raise NotImplementedError

    @property
    def calibrating(self) -> bool:
        return self.calib is not None or self.mlp.calib is not None

    def _fold(self, kernel: str, args: dict) -> dict:
        """Register a kernel's tensor arguments as non-persistent buffers
        (`_k2_ln_scale_q`, ...); return the argument dict naming them,
        scalars as Python floats and None (a mode's absent constant) as
        None."""
        out = {}
        for k, v in args.items():
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                name = f"_{kernel}_{k}"
                self.register_buffer(name, v.detach().contiguous(),
                                     persistent=False)
                out[k] = name
            else:
                out[k] = None if v is None else float(v)
        return out

    def _folded_args(self, folded: dict | None) -> dict:
        if folded is None:
            raise RuntimeError(
                "int8 block without a quantized state: calibrate with "
                "geovpr_torch.models.quantize.quantize_for_serving or load "
                "a state_dict that carries one")
        return {k: getattr(self, v) if isinstance(v, str) else v
                for k, v in folded.items()}

    def _int8_attention(self, attn, x: torch.Tensor, **kwargs):
        """The w8a8 attention half `attn` (the kernel's wrapper or its
        plain version) on x, through a bf16 stream on the kernel route
        (`int8_kernel_route`), the output in x's dtype."""
        if (int8_kernel_route(x, self.use_kernels)
                and x.dtype != torch.bfloat16):
            return attn(x.bfloat16(), **kwargs).to(x.dtype)
        return attn(x, **kwargs)

    def _attn_int8_fold(self, last_key: bool) -> dict:
        """The attention half's fold in the mode `quant.INT8_QK_SCORES` and
        `quant.INT8_PV` name when it runs (`_attn_int8_fold` in
        `geovpr/models/dinov2.py:201-249` and `swin.py:588-629`): 1/a_x into
        the LN scale and bias; a_x * column scale into the qkv dequant row,
        with its thirds scaled per mode; a_ctx * column scale into the
        out-projection row. int8 scores: 1/a_q, 1/a_k, 1/a_ctx into the q,
        k, v thirds, cs = a_q a_k dh^-0.5; int8 P.V: 1/a_v into the v
        third instead, cpv = a_v / (127 a_ctx) and, with `last_key` (the
        ViT's key split), cpl = a_v / a_ctx; bf16 scores: 1/a_ctx into the
        v third alone, cs None."""
        d = self.attn.proj_weight.shape[0]
        a_x, a_ctx = self.attn_a_x, self.attn_a_ctx
        col3 = torch.arange(3 * d, device=a_x.device)
        cs = cpv = cpl = None
        if quant.INT8_QK_SCORES:
            a_q, a_k = self.attn_a_q, self.attn_a_k
            v_fold = 1.0 / a_ctx
            if quant.INT8_PV:
                a_v = self.attn_a_v
                v_fold = 1.0 / a_v
                cpv = a_v / (127.0 * a_ctx)
                cpl = a_v / a_ctx
            thirds = torch.where(col3 < d, 1.0 / a_q,
                                 torch.where(col3 < 2 * d, 1.0 / a_k,
                                             v_fold))
            cs = a_q * a_k * (d // self.num_heads) ** -0.5
        else:
            thirds = torch.where(col3 < 2 * d, 1.0, 1.0 / a_ctx)
        out = dict(ln_scale_q=self.norm1.weight.float() / a_x,
                   ln_bias_q=self.norm1.bias.float() / a_x,
                   wqkv_q_t=self.attn_wqkv_q.t().contiguous(),
                   sqkv_eff=a_x * self.attn_wqkv_scale * thirds,
                   bqkv_eff=self.attn.qkv_bias.float() * thirds,
                   wo_q_t=self.attn_wo_q.t().contiguous(),
                   so_eff=a_ctx * self.attn_wo_scale,
                   bo=self.attn.proj_bias.float(), cs=cs, cpv=cpv)
        if last_key:
            out["cpl"] = cpl
        return out

    def quant_state(self, amax: dict) -> dict:
        """The JAX "quant" entries of this block's attention from its
        calibration amaxes (`geovpr/models/quantize.py:60-83`)."""
        wq, sq = quantize_weight(self.attn.qkv_weight)
        woq, so = quantize_weight(self.attn.proj_weight)
        out = {f"attn_a_{k}": act_scale(amax[f"attn_{k}"])
               for k in ("x", "ctx", "q", "k", "v")}
        out.update(attn_wqkv_q=wq, attn_wqkv_scale=sq, attn_wo_q=woq,
                   attn_wo_scale=so)
        return out


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax `lecun_normal`: truncated normal (at +-2 std) with variance
    1/fan_in. Drawn in f32 on the CPU, so one seed gives the same weights on
    any device and in any dtype."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(t.shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    with torch.no_grad():
        t.copy_(w)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init of every parameter of `model`, module by module in
    registration order: `nn.Linear`/`nn.Conv2d` lecun-normal with zero bias,
    and each of the port's own modules through its `_init_weights`."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif hasattr(m, "_init_weights"):
            m._init_weights(generator)
    return model
