"""The port's EfficientNet-B0 training step, BatchNorm in training mode,
against the JAX package's `make_train_step(..., has_batch_stats=True)`,
parameter for parameter and statistic for statistic.

The whole architecture at 64 px (its last stages at 2 x 2), B = 8 with one
padded row (seven valid rows and a copy of the last, the mask false
there, as `iterate_batches` pads), f32 on both sides, head dropout and
stochastic depth off, no augmentation. Each EfficientNet preset's own
head, loss and optimizer (lr raised to 1e-3). After each of three steps
the loss agrees within rtol 1e-5, and every parameter element, and every
running mean and variance, within the tolerances of
`tests/test_torch_train_step.py::test_three_steps_match_jax`: rtol 1e-5
and atol 1e-7 plus 2 % of its tensor's largest update, but for at most
1e-5 of all elements, which stay within the size of the updates taken
(2 lr each for a parameter; for a statistic, twice its largest update).
A BatchNorm bias that only a 1x1 conv and another training-mode
BatchNorm follow (each block's `project.bn.bias`) has a zero gradient in
exact arithmetic, roundoff in both packages, like the attention's key
bias in the transformer tests: its update is bounded, not compared.

The state both start from. At flax's init (BatchNorm scale 1, bias 0) a
random EfficientNet-B0 normalizing small batches is chaotic: f32 roundoff
grows by orders of magnitude through its 49 BatchNorms (at 32 px and
B = 4 two identical rows of one batch leave the port 6e-3 apart; at
64 px the two packages' gradients differ by 5e-5 of each tensor's
largest element, and so do two memory layouts of the port's own). So the
BatchNorm scales start at U(0.3, 0.8) times their init and the biases at
N(0, 0.2), every BatchNorm input then mattering, and JAX takes two steps
on other batches first, its parameters, statistics and Adam state
(moments, count) carried to the port through the weight and optimizer
bridges: Adam's first step divides each gradient by its own size, which
turns the sign of a gradient below that roundoff into a full step of
either sign (measured: 120 to 300 of 4,050,318 elements), while later
steps divide by the moments already gathered. From there the three steps
compared take every element within the tolerance (measured: none
outside, at 64 and 128 px).

Beyond EfficientNet's steps: BatchNorm alone against flax's in training
mode (at n = 4, a 1 x 1 map, the biased and unbiased variances part by a
third); a narrow ConvNeXt's steps against JAX's `make_train_step`; the
MBConv DropPath route against JAX's on one fixed per-image mask; a
NaN-target step that keeps the parameters, moments and running statistics
bit for bit; a resume (2 + 1 epochs) bit-equal to the unbroken run,
statistics included; `cli.evaluate --run-dir` and `cli.fuse --angle-run`
serving a CNN run on its own running statistics; the frozen-feature cache
refusing a model with batch statistics; `--pretrained` carrying a
backbone's `batch_stats`. They share this file, and so one test worker,
with EfficientNet's steps: the test workers take a file each, the files
with fewer tests last, and the JAX compiles here (about 140 s a preset on
the CPU) would otherwise start last.
"""

import dataclasses
import json
import os
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.convnext as jconvnext
import geovpr.models.efficientnet as jeff
import geovpr_torch.cli.presets as tpresets
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.data.transforms import normalize as j_normalize
from geovpr.train.model import RegressionModel as JModel
from geovpr.train.optimizer import build_optimizer as j_build_optimizer
from geovpr.train.state import create_train_state as j_create_state
from geovpr.train.steps import make_train_step as j_make_train_step
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.models import convnext as tconvnext
from geovpr_torch.models.convert_jax import (optimizer_state_from_flax,
                                             state_dict_from_flax)
from geovpr_torch.models.layers import BatchNorm, DropPath, batch_stat_buffers
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.objectives.scaler import identity_scaler
from geovpr_torch.train.state import TrainState, build_optimizer
from geovpr_torch.train.steps import make_train_step

B, SIZE, STEPS, WARMUP = 8, 64, 3, 2
RTOL, ATOL, UPDATE_SHARE, OUTLIER_SHARE = 1e-5, 1e-7, 0.02, 1e-5
LR = 1e-3
EFF_PRESETS = ("efficientnet_sincos_gemini", "efficientnet_direct_maae")
STAT = ("running_mean", "running_var")
ROUNDOFF_GRAD = "project.bn.bias"


class _JaxNoDropPath(fnn.Module):
    """JAX's DropPath at rate 0 whatever the rate it is given: the step
    comparison runs with stochastic depth off."""
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small shapes: the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(preset, size=SIZE, variant=None):
    """The preset at `size` px, head dropout 0, no augmentation, f32, lr
    1e-3 (three steps move the parameters well past f32 roundoff)."""
    out = []
    for build in (j_build_preset, build_preset):
        cfg = build(preset)
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, head_dropout=0.0, compute_dtype="float32",
                image_size=size, variant=variant or cfg.model.variant),
            data=dataclasses.replace(cfg.data, image_size=size, batch_size=B,
                                     augment="none"),
            optim=dataclasses.replace(cfg.optim, lr=LR)))
    return out


def _batches(size=SIZE, seed=0, pad=True, b=B):
    """STEPS batches of `b` images and angles; the last row of each a copy
    of the row before it, masked out, where `pad`."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        img = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
        ang = rng.uniform(0, 360, size=b).astype(np.float32)
        mask = np.ones(b, bool)
        if pad:
            img[-1], ang[-1], mask[-1] = img[-2], ang[-2], False
        out.append(dict(image=img, target=ang, mask=mask))
    return out


def _np_state(variables) -> dict:
    """A flax variables tree -> the port's state_dict as numpy arrays."""
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)).items()}


def _variables(jstate) -> dict:
    v = {"params": jstate.params}
    if jstate.batch_stats:
        v["batch_stats"] = jstate.batch_stats
    return v


def _perturb_bn(params):
    """BatchNorm scales at U(0.3, 0.8) times their value, biases plus
    N(0, 0.2), drawn per leaf from its path."""
    def one(path, v):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        key = jax.random.PRNGKey(zlib.crc32(name.encode()))
        if name.endswith("bn/scale"):
            return v * jax.random.uniform(key, v.shape, minval=0.3,
                                          maxval=0.8)
        if name.endswith("bn/bias"):
            return v + 0.2 * jax.random.normal(key, v.shape)
        return v
    return jax.tree_util.tree_map_with_path(one, params)


def _assert_close(got: dict, want: dict, before: dict, what: str,
                  steps: int):
    """Every element within rtol/atol + UPDATE_SHARE of its tensor's
    largest update, except at most OUTLIER_SHARE of all elements, which
    stay within `steps` updates (2 lr each) for a parameter, twice the
    tensor's largest update for a running statistic."""
    outliers, total = 0, 0
    for k, w in want.items():
        g = got[k].detach().numpy()
        b = before[k]
        if k.endswith(ROUNDOFF_GRAD):
            # a constant added before a 1x1 conv whose BatchNorm (training
            # mode) subtracts the batch mean again: its gradient is zero in
            # exact arithmetic and roundoff in both packages, which Adam
            # scales to about +-lr with independent signs (as the
            # attention's key bias in the transformer tests). Its update is
            # bounded: Adam's normalized step is at most 1.011 in its first
            # five counts whatever the gradients, and the weight decay adds
            # 0.01 |p| < 0.01.
            assert np.abs(g - b).max() <= steps * LR * 1.03, k
            continue
        err = np.abs(g - w)
        step = np.abs(w - b).max()
        tol = RTOL * np.abs(w) + ATOL + UPDATE_SHARE * step
        limit = 2 * step + ATOL if k.endswith(STAT) else 2 * LR * steps
        assert err.max() <= limit, f"{what}: {k} off by {err.max()}"
        outliers += int((err > tol).sum())
        total += err.size
    assert outliers <= OUTLIER_SHARE * total, \
        f"{what}: {outliers} of {total} elements outside the tolerance"


class _JitInit:
    """A flax model as `create_train_state` uses it (`init`, `apply`), its
    init jitted: one compile in place of an op-by-op trace (EfficientNet-B0:
    17 s against 44 s on the CPU), the same values."""

    def __init__(self, model):
        self.init, self.apply = jax.jit(model.init), model.apply


def _jax_setup(preset, variant=None, size=SIZE, warmup=WARMUP):
    """JAX's state for `preset` (BatchNorms perturbed where there are
    any) after `warmup` steps on batches of their own, and its jitted
    step."""
    jcfg, tcfg = _cfgs(preset, size, variant)
    has_stats = jcfg.model.family == "efficientnet"
    jstate = j_create_state(
        _JitInit(JModel(config=jcfg.model, dtype=jnp.float32)),
        j_build_optimizer(jcfg.optim), jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3)), out_dim=jcfg.model.out_dim)
    if has_stats:
        jstate = jstate.replace(params=_perturb_bn(jstate.params))
    jstep = jax.jit(j_make_train_step(j_objective_for(jcfg),
                                      normalize_fn=j_normalize,
                                      has_batch_stats=has_stats))
    for batch in _batches(size, seed=9)[:warmup]:
        jstate, _ = jstep(jstate, _jbatch(batch))
    return dict(jcfg=jcfg, tcfg=tcfg, jstate=jstate, jstep=jstep)


@pytest.fixture(scope="module")
def eff():
    """JAX's warmed-up state and jitted step for each EfficientNet preset
    (one compile each), stochastic depth off while they trace and run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeff, "DropPath", _JaxNoDropPath)
        yield {p: _jax_setup(p) for p in EFF_PRESETS}


def _port_state(tcfg, jstate) -> TrainState:
    """The port's state from JAX's: parameters, running statistics, Adam's
    moments and count, the step; stochastic depth off."""
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, _variables(jstate))))
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    opt = build_optimizer(model, tcfg.optim)
    opt.load_state_dict(optimizer_state_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.opt_state)))
    return TrainState(step=int(jstate.step), model=model, opt=opt,
                      scaler=identity_scaler(2), seed=0)


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def three_steps(s, batches, what):
    """Three steps in both packages from JAX's state; returns both
    states."""
    jstate = s["jstate"]
    tstate = _port_state(s["tcfg"], jstate)
    start = tstate.step
    tstep = make_train_step(objective_for(s["tcfg"]))
    for i, batch in enumerate(batches):
        before = _np_state(_variables(jstate))
        jstate, jm = s["jstep"](jstate, _jbatch(batch))
        tm = tstep(tstate, _tbatch(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=RTOL, abs=1e-6)
        assert float(tm["skipped"]) == float(jm["skipped"]) == 0.0
        _assert_close(dict(tstate.model.state_dict()),
                      _np_state(_variables(jstate)), before,
                      f"{what} step {i + 1}", i + 1)
    assert tstate.step == int(jstate.step) == start + len(batches)
    assert tstate.opt.count == start + len(batches)
    return tstate, jstate


@pytest.mark.parametrize("preset", EFF_PRESETS)
def test_efficientnet_three_steps_match_jax(eff, preset):
    """Losses, every parameter and every running mean and variance after
    each of three steps, each batch with a padded tail row."""
    tstate, jstate = three_steps(eff[preset], _batches(), preset)
    stats = _np_state({"params": {}, "batch_stats": jstate.batch_stats})
    assert len(stats) == 2 * sum(isinstance(m, BatchNorm)
                                 for m in tstate.model.modules()) == 98


def test_padded_tail_enters_the_batch_statistics(eff):
    """A padded batch (seven valid rows and a copy of the last, masked)
    gives JAX's update of the padded batch, statistics included. The
    bare-rows identity of `test_torch_train_step.py::
    test_padded_tail_matches_bare_rows` does not hold here: the mask
    weights only the loss, while every BatchNorm normalizes by, and moves
    its running statistics with, the mean and variance of all eight rows,
    the copy counted twice, so the gradient and the statistics of the
    padded batch differ from those of the seven rows alone."""
    s = eff[EFF_PRESETS[0]]
    padded = _batches()[0]
    bare = {k: v[:-1] for k, v in padded.items()}
    before = _np_state(_variables(s["jstate"]))
    jstate, _ = s["jstep"](s["jstate"], _jbatch(padded))
    step = make_train_step(objective_for(s["tcfg"]))
    got = {}
    for name, batch in (("padded", padded), ("bare", bare)):
        st = _port_state(s["tcfg"], s["jstate"])
        step(st, _tbatch(batch))
        got[name] = dict(st.model.state_dict())
    _assert_close(got["padded"], _np_state(_variables(jstate)), before,
                  "padded", 1)
    for k in ("backbone.stem.bn.running_mean",
              "backbone.head.bn.running_var"):
        assert not torch.allclose(got["padded"][k], got["bare"][k],
                                  rtol=1e-4), k


CONVNEXT = dict(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256))
CONVNEXT_SIZE = 64
# the training runs: 32 px, B = 4, 8 images (2 steps an epoch)
RUN_SIZE, RUN_B, N_RUN = 32, 4, 8


def test_convnext_three_steps_match_jax(monkeypatch):
    """A narrow ConvNeXt (depths (1, 1, 2, 1), dims (32, 64, 128, 256),
    64 px), three `convnext_direct_maae` steps (B = 8, no padded row)
    after JAX's two, with `has_batch_stats=False` in JAX, compared on
    every parameter at the EfficientNet steps' tolerances."""
    monkeypatch.setitem(jconvnext.CONVNEXT_VARIANTS, "tiny-test", CONVNEXT)
    monkeypatch.setitem(tconvnext.CONVNEXT_VARIANTS, "tiny-test", CONVNEXT)
    s = _jax_setup("convnext_direct_maae", "tiny-test", CONVNEXT_SIZE)
    assert not s["jstate"].batch_stats
    tstate, _ = three_steps(
        s, _batches(CONVNEXT_SIZE, seed=3, pad=False), "convnext")
    assert not batch_stat_buffers(tstate.model)
    # the training build holds f32 parameters in channels-last memory
    dw = tstate.model.backbone.stage0_block0.dwconv.weight
    assert dw.dtype == torch.float32 and dw.is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("hw", [1, 3])
def test_batchnorm_matches_flax_in_training_mode(hw):
    """`layers.BatchNorm` in training mode against flax's `nn.BatchNorm(
    use_running_average=False, momentum=0.9, epsilon=1e-3, dtype=f32)` on
    B = 4 rows (the last a copy of the third, as a padded tail) at a 1 x 1
    and a 3 x 3 map: the output, the gradients of the input, scale and
    bias, and the moved running mean and variance, within rtol 1e-5 and
    atol 1e-6 (f32). At 1 x 1 the statistics are over n = 4 values, where
    torch's own `F.batch_norm` update (the unbiased variance) is a third
    off flax's."""
    rng = np.random.default_rng(11 + hw)
    c = 16
    x = rng.normal(size=(4, hw, hw, c)).astype(np.float32) * 2 + 0.5
    x[3] = x[2]
    w = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    ra_mean = rng.normal(size=c).astype(np.float32) * 0.1
    ra_var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=jeff.BN_MOMENTUM,
                        epsilon=jeff.BN_EPS, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}

    def jf(xx, p):
        y, upd = jbn.apply({"params": p,
                            "batch_stats": variables["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return (y * w).sum(), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jgx, jgp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                          variables["params"])
    bn = BatchNorm(c, jeff.BN_EPS)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
        bn.running_var.copy_(torch.from_numpy(ra_var))
    bn.train()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    ty = bn(tx)
    (ty * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), **tol)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jgx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(jgp["scale"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(jgp["bias"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(jstats["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(jstats["var"]), **tol)
    if hw == 1:
        torch_var = torch.from_numpy(ra_var).clone()
        F = torch.nn.functional
        F.batch_norm(tx.detach(), torch.from_numpy(ra_mean).clone(),
                     torch_var, None, None, True, 0.1, jeff.BN_EPS)
        assert not np.allclose(torch_var.numpy(), np.asarray(jstats["var"]),
                               **tol)


DROP_KEEP = (True, False, True, True, False, True, True, True)
GRAD_ATOL = 5e-5


class _JaxFixedDropPath(fnn.Module):
    """JAX's DropPath with its draw replaced by the fixed per-image mask
    DROP_KEEP."""
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        if self.rate == 0.0 or deterministic:
            return x
        keep = 1.0 - self.rate
        mask = jnp.asarray(DROP_KEEP).reshape((-1,) + (1,) * (x.ndim - 1))
        return jnp.where(mask, x / keep, jnp.zeros_like(x))


def _torch_fixed_drop_path(self, x):
    if self.rate == 0.0 or not self.training:
        return x
    keep = 1.0 - self.rate
    mask = torch.tensor(DROP_KEEP).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / keep, torch.zeros_like(x))


def test_mbconv_drop_path_route_matches_jax(monkeypatch):
    """EfficientNet-B0 at 64 px in training mode at JAX's stochastic depth
    0.2 (the rate 0.2 i / 16 on residual blocks only), its BatchNorms
    perturbed as for the EfficientNet steps: the port's output, the
    gradient of every parameter and the moved running statistics equal
    JAX's (`train=True, deterministic=False`) on the same per-image mask,
    f32: rtol 1e-4, atol GRAD_ATOL times the tensor's largest element
    (but `project.bn.bias`, whose gradient is roundoff). GRAD_ATOL is
    this network's f32 floor in training mode: two memory layouts of the
    port's own gradients differ by up to 2.8e-5 of a tensor's largest
    element at 64 px (a DropPath at the wrong block or rate moves whole
    tensors by tens of percent). The rates sit where JAX's do, and the
    serving forward (eval mode) draws nothing."""
    from geovpr_torch.models.efficientnet import EfficientNetB0

    monkeypatch.setattr(jeff, "DropPath", _JaxFixedDropPath)
    monkeypatch.setattr(DropPath, "forward", _torch_fixed_drop_path)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (len(DROP_KEEP), SIZE, SIZE, 3)).astype(
        np.float32)
    w = rng.normal(size=(len(DROP_KEEP), 1, 1280)).astype(np.float32)
    jm = jeff.EfficientNetB0(dtype=jnp.float32)
    # jitted: one compile in place of an op-by-op trace, the same values
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = dict(variables, params=_perturb_bn(variables["params"]))

    def jloss(p):
        out, upd = jm.apply({"params": p,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, deterministic=False,
                            mutable=["batch_stats"])
        return (out.tokens * w).sum(), (out.tokens, upd["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"])

    tm = EfficientNetB0(dtype=torch.float32, param_dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, variables)))
    rates = {n: m.rate for n, m in tm.named_modules()
             if isinstance(m, DropPath)}
    # residual blocks only: the last is block 14 of 16 (stage 5's fourth)
    assert len(rates) == 9 and rates["stage5_block3.drop_path"] == \
        pytest.approx(0.2 * 14 / 16) == max(rates.values())
    tm.train()
    tout = tm(torch.from_numpy(x)).tokens
    (tout * torch.from_numpy(w)).sum().backward()
    jout = np.asarray(jout)
    np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=1e-4,
                               atol=1e-5 * np.abs(jout).max())
    want = _np_state(jgrads)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith(ROUNDOFF_GRAD):    # zero in exact arithmetic
            continue
        np.testing.assert_allclose(got[k].grad.numpy(), v, rtol=1e-4,
                                   atol=GRAD_ATOL * np.abs(v).max(),
                                   err_msg=k)
    for k, v in _np_state({"params": {}, "batch_stats": jstats}).items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)
    tm.eval()
    with torch.no_grad():
        a, b = (tm(torch.from_numpy(x)).tokens for _ in range(2))
    assert torch.equal(a, b)


def test_convnext_drop_path_route_matches_jax(monkeypatch):
    """A narrow ConvNeXt in training mode at a DropPath rate rising to 0.3
    over its blocks (JAX's `linspace(0, drop_path_rate, total)`; the
    presets pass none, so there it is the identity): the port's output
    and the gradient of every parameter equal JAX's (`deterministic=
    False`) on the same per-image mask, f32: rtol 1e-4, atol 1e-5 times
    the tensor's largest element."""
    from geovpr_torch.models.convnext import ConvNeXt

    monkeypatch.setattr(jconvnext, "DropPath", _JaxFixedDropPath)
    monkeypatch.setattr(DropPath, "forward", _torch_fixed_drop_path)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (len(DROP_KEEP), 32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(len(DROP_KEEP), 1, CONVNEXT["dims"][-1])).astype(
        np.float32)
    jm = jconvnext.ConvNeXt(**CONVNEXT, drop_path_rate=0.3,
                            dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    # LayerScale gammas start at 1e-6: give the branches a weight
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 if str(getattr(p[-1], "key", "")) == "gamma"
        else v, params)

    def jloss(p):
        t = jm.apply({"params": p}, jnp.asarray(x), deterministic=False
                     ).tokens
        return (t * w).sum(), t

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tm = ConvNeXt(**CONVNEXT, drop_path_rate=0.3, param_dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    rates = [m.rate for m in tm.modules() if isinstance(m, DropPath)]
    assert rates == pytest.approx(list(np.linspace(0, 0.3, 5)))
    tm.train()
    tout = tm(torch.from_numpy(x)).tokens
    (tout * torch.from_numpy(w)).sum().backward()
    jout = np.asarray(jout)
    np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=1e-4,
                               atol=1e-5 * np.abs(jout).max())
    want = _np_state(jgrads)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].grad
        if g is None:                   # the pooler's LN: tokens skip it
            assert k.startswith("pool_norm.") and not v.any(), k
            continue
        np.testing.assert_allclose(g.numpy(), v, rtol=1e-4,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)


def _train_model(seed=0):
    """The efficientnet_sincos_gemini training model at 64 px, f32, from a
    seeded init with its running statistics moved off 0 and 1."""
    from geovpr_torch.train.state import create_train_state

    _, tcfg = _cfgs(EFF_PRESETS[0])
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    st = create_train_state(model, tcfg.optim, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for b in batch_stat_buffers(model):
            b.add_(torch.rand(b.shape, generator=gen) * 0.5)
    return tcfg, st


def test_nan_step_keeps_parameters_moments_and_statistics():
    """A batch with NaN targets after a good step: `skipped` 1, the loss
    reported 0, and the parameters, Adam's moments and every running mean
    and variance bit-equal to their values before it (JAX's `jnp.where`
    covers the batch_stats leaves too); the step count still advances."""
    tcfg, st = _train_model()
    step = make_train_step(objective_for(tcfg))
    batches = _batches()
    m = step(st, _tbatch(batches[0]))
    assert float(m["skipped"]) == 0.0
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    mu = {k: v.clone() for k, v in st.opt.mu.items()}
    nu = {k: v.clone() for k, v in st.opt.nu.items()}
    bad = dict(batches[1], target=np.full(B, np.nan, np.float32))
    m = step(st, _tbatch(bad))
    assert float(m["skipped"]) == 1.0 and float(m["loss"]) == 0.0
    assert st.step == 2 and st.opt.count == 2
    after = st.model.state_dict()
    assert sum(k.endswith(STAT) for k in after) == 98
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    for k in mu:
        assert torch.equal(mu[k], st.opt.mu[k]), k
        assert torch.equal(nu[k], st.opt.nu[k]), k
    # a good batch after it moves them again
    step(st, _tbatch(batches[2]))
    assert not torch.equal(before["backbone.stem.bn.running_mean"],
                           st.model.state_dict()[
                               "backbone.stem.bn.running_mean"])


# ------------------------------------------------ the trainer and the CLIs

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """efficientnet_sincos_gemini at 32 px, B = 4, on 8 images with
    the preset's own augmentation, head dropout and stochastic depth: an
    unbroken run of 3 epochs, and a run of 2 epochs resumed for the
    third; label CSV and PNGs of the validation images."""
    from PIL import Image

    from geovpr_torch.cli.train import run_train
    from geovpr_torch.data.pipeline import ArraySource

    tmp = tmp_path_factory.mktemp("cnn_runs")
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (N_RUN, RUN_SIZE, RUN_SIZE, 3)).astype(
        np.uint8)
    angles = rng.uniform(0, 360, N_RUN).astype(np.float32)
    names = [f"a{i}.png" for i in range(N_RUN)]
    os.makedirs(tmp / "img")
    with open(tmp / "labels.csv", "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for name, img, a in zip(names, images, angles):
            Image.fromarray(img).save(tmp / "img" / name)
            f.write(f"{name},0,0,0,{float(a)!r},1\n")
    angles = np.loadtxt(tmp / "labels.csv", delimiter=",", skiprows=1,
                        usecols=(4,), dtype=np.float32)
    preset = EFF_PRESETS[0]
    cfg = tpresets.ANGLE_PRESETS[preset]
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_size=RUN_SIZE,
                                      batch_size=RUN_B, eval_resize_to=0),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, epochs=3))
    src = ArraySource(images, angles, names)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tpresets.ANGLE_PRESETS, preset, cfg)
        unbroken = run_train(cfg, src, src, save_dir=str(tmp / "a"),
                             device="cpu")
        first = run_train(cfg, src, src, save_dir=str(tmp / "b"),
                          device="cpu", epochs=2)
        resumed = run_train(cfg, src, src, save_dir=str(tmp / "b"),
                            device="cpu", resume=first.run_dir)
        yield dict(tmp=tmp, cfg=cfg, preset=preset, src=src,
                   unbroken=unbroken, first=first, resumed=resumed)
    torch.set_num_threads(n)


def test_resume_keeps_the_statistics_bit_equal(runs):
    """2 epochs, then a resume for the third, against 3 unbroken epochs:
    the third epoch's losses, and every parameter and running statistic
    at the end, bit for bit; the statistics moved off their init."""
    a, r = runs["unbroken"], runs["resumed"]
    assert sorted(r.step_losses) == [2]
    assert r.step_losses[2] == a.step_losses[2]
    sa, sr = a.state.model.state_dict(), r.state.model.state_dict()
    for k, v in sa.items():
        assert torch.equal(v, sr[k]), k
    assert not torch.equal(sa["backbone.head.bn.running_var"],
                           torch.ones_like(sa["backbone.head.bn.running_var"]))


def _ckpt_stats(run_dir) -> dict:
    ck = torch.load(os.path.join(run_dir, "best", "state.pt"),
                    weights_only=True)
    return {k: v for k, v in ck["params"].items() if k.endswith(STAT)}


def test_evaluate_run_dir_reads_the_runs_statistics(runs, capsys, tmp_path):
    """`cli.evaluate --run-dir` on the CNN run: the model it builds holds
    the checkpoint's running statistics (not the init's 0 and 1), in eval
    mode, and its metrics equal the trainer's own evaluation of that
    checkpoint's state."""
    from geovpr_torch.cli.evaluate import build_model, main
    from geovpr_torch.train.checkpoint import restore_checkpoint

    run_dir = runs["unbroken"].run_dir
    want = _ckpt_stats(run_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tpresets.ANGLE_PRESETS, runs["preset"], runs["cfg"])
        model, _ = build_model(runs["cfg"], "cpu", run_dir=run_dir)
        assert not model.training
        sd = model.state_dict()
        assert len(want) == 98
        for k, v in want.items():
            assert torch.equal(sd[k], v), k
        assert not torch.equal(want["backbone.stem.bn.running_mean"],
                               torch.zeros_like(
                                   want["backbone.stem.bn.running_mean"]))
        main(["--preset", runs["preset"], "--run-dir", run_dir,
              "--val-csv", str(runs["tmp"] / "labels.csv"),
              "--image-root", str(runs["tmp"] / "img"), "--device", "cpu",
              "--out-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tr = runs["unbroken"]
    restore_checkpoint(os.path.join(run_dir, "best"), tr.state)
    metrics, _ = tr.evaluate_and_predict(runs["src"])
    for k, v in metrics.items():
        assert out["metrics"][k] == pytest.approx(v, rel=1e-6), k
    rows = open(out["validation_csv"]).read().splitlines()
    assert len(rows) == N_RUN + 1


def test_fuse_angle_run_reads_the_runs_statistics(runs, tmp_path):
    """`cli.fuse --angle-preset efficientnet_sincos_gemini --angle-run RUN`
    (`cli.common.load_trained`) serves the run's checkpoint with its
    running statistics, in eval mode."""
    from PIL import Image

    from geovpr_torch.cli.fuse import build_pipeline, parse_args

    test_dir = tmp_path / "test"
    os.makedirs(test_dir)
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 36, 3)).astype(
            np.uint8)).save(test_dir / f"t{i}.jpg")
    run_dir = runs["unbroken"].run_dir
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tpresets.ANGLE_PRESETS, runs["preset"], runs["cfg"])
        pipe, source, _ = build_pipeline(parse_args([
            "--angle-preset", runs["preset"], "--angle-run", run_dir,
            "--test-dir", str(test_dir), "--out-dir", str(tmp_path / "out"),
            "--device", "cpu"]))
    model = pipe.angle_model
    assert not model.training and len(source) == 3
    sd = model.state_dict()
    for k, v in _ckpt_stats(run_dir).items():
        assert torch.equal(sd[k], v), k


def test_pretrained_backbone_carries_batch_statistics(tmp_path):
    """`--pretrained` on EfficientNet-B0: a flax msgpack of backbone
    variables with `batch_stats` (as `geovpr/train/state.py:56-58` merges
    them) lays its running statistics over the init's reset ones, and its
    parameters over the init's; the head keeps its init."""
    from flax.serialization import msgpack_serialize

    from geovpr_torch.cli.train import load_pretrained_backbone
    from geovpr_torch.train.state import create_train_state

    variables = jax.jit(jeff.EfficientNetB0(dtype=jnp.float32).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, SIZE, SIZE, 3)))
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.25, variables["batch_stats"])
    path = tmp_path / "backbone.msgpack"
    path.write_bytes(msgpack_serialize({
        "params": jax.tree_util.tree_map(np.asarray, variables["params"]),
        "batch_stats": stats}))
    _, tcfg = _cfgs(EFF_PRESETS[0])
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    pre = load_pretrained_backbone(str(path))
    assert sum(k.endswith(STAT) for k in pre) == 98
    create_train_state(model, tcfg.optim, 0, pretrained=pre)
    sd = model.state_dict()
    for k, v in pre.items():
        assert torch.equal(sd[k], v), k
    assert torch.equal(sd["backbone.head.bn.running_var"],
                       torch.full((1280,), 1.25))


def test_frozen_cache_refuses_batch_statistics(tmp_path):
    """A frozen EfficientNet with `cache_frozen_features` and no
    augmentation is not cached: it keeps batch statistics (JAX's `not
    self.has_batch_stats`); a frozen ConvNeXt is."""
    from geovpr_torch.data.pipeline import ArraySource
    from geovpr_torch.train.loop import Trainer

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconvnext.CONVNEXT_VARIANTS, "tiny-test", CONVNEXT)
        for preset, variant, cached in (
                (EFF_PRESETS[0], None, False),
                ("convnext_direct_maae", "tiny-test", True)):
            _, cfg = _cfgs(preset, variant=variant)
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model,
                                               freeze_backbone=True),
                train=dataclasses.replace(cfg.train,
                                          cache_frozen_features=True))
            model = RegressionModel(cfg.model, dtype=torch.float32,
                                    train=True)
            tr = Trainer(model=model, objective=objective_for(cfg),
                         optim_cfg=cfg.optim, train_cfg=cfg.train,
                         data_cfg=cfg.data, device="cpu",
                         run_dir=str(tmp_path / preset))
            tr.init_state()
            assert tr.has_batch_stats == (not cached)
            src = ArraySource(np.zeros((B, SIZE, SIZE, 3), np.uint8),
                              np.zeros(B, np.float32))
            got = tr._maybe_cache_frozen_features(src, None)
            assert (got is not None) == cached, preset
