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

`tests/test_torch_cnn_train_paths.py` holds BatchNorm alone against
flax's at n = 4 (a 1 x 1 map, where the biased and unbiased variances part
by a third), ConvNeXt's steps, the DropPath route, the NaN step, resume
and the CLIs.
"""

import dataclasses
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.efficientnet as jeff
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.data.transforms import normalize as j_normalize
from geovpr.train.model import RegressionModel as JModel
from geovpr.train.optimizer import build_optimizer as j_build_optimizer
from geovpr.train.state import create_train_state as j_create_state
from geovpr.train.steps import make_train_step as j_make_train_step
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.models.convert_jax import (optimizer_state_from_flax,
                                             state_dict_from_flax)
from geovpr_torch.models.layers import BatchNorm, DropPath
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


def _jax_setup(preset, variant=None, size=SIZE, warmup=WARMUP):
    """JAX's state for `preset` (BatchNorms perturbed where there are
    any) after `warmup` steps on batches of their own, and its jitted
    step."""
    jcfg, tcfg = _cfgs(preset, size, variant)
    has_stats = jcfg.model.family == "efficientnet"
    jstate = j_create_state(
        JModel(config=jcfg.model, dtype=jnp.float32),
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
