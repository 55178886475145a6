"""The port's window-7 Swin training step against the JAX package's
`make_train_step`, parameter for parameter, for three Swin-T-224 presets.

A tiny window-7 Swin (`embed_dim=64, depths=(2, 2), num_heads=(2, 4)`,
56 px: stage 0 is 2 x 2 windows with a shifted block, stage 1 one window;
head dim 32) with each preset's own head, loss, schedule and clip:
`swin_t224_v1` (linear head, MSE, constant lr, no weight decay),
`swin_t224_sincos_acos` (unit sin/cos head, the acos loss, cosine decay,
clip 5) and `swin_t224_sincos_gemini` (sin/cos MLP head, MSE, cosine with
warm restarts every 2 steps, clip 1). Dropout and DropPath rates 0, no
augmentation, f32 on both sides. JAX trains window 7 on its XLA route
(`pallas_ok` needs `deterministic`, `geovpr/models/swin.py:389-391`), and
so does the port (`swin_attn_block_unfused` with `window_attention`, the
residual outside). The same initial parameters go to both through the
weight bridge; after each of three steps the loss must agree within rtol
1e-5, and every parameter element within the tolerances of
`tests/test_torch_train_step.py`: rtol 1e-5 and atol 1e-7 plus 2 % of its
tensor's largest update, but for at most 1e-5 of all elements, which must
stay within the size of the updates taken (2 lr each); the key bias, whose
gradient is roundoff in both packages, only within its bounded update.

The acos loss is ill-conditioned where a prediction points away from its
target: d acos(d) / dd = -1 / sin(theta) grows as theta nears 180 degrees,
and its own slope faster, so the last f32 bit of a prediction moves that
row's gradient weight by ~1e-5 of itself at theta = 177 degrees (measured:
the port's and JAX's gradients then differ by 3e-6 of each tensor's
largest element, and Adam's first step, which divides each gradient by its
own size, turns that into 11 of 535,214 elements outside the tolerance).
The acos preset therefore takes the batches of seed 1, and the test first
asserts that every initial prediction lies within 160 degrees of its
target, so that the comparison stays well conditioned. The batches of
seed 0 stay under a check of their own: the gradients of the acos loss
there (before Adam divides them), at the step comparison's tolerance with
the gradient in the place of the update.

Also: the DropPath route of a window-7 training block against JAX's on
the same per-image mask, and the projections' autograd Function of the
card (its forward, cuBLAS's f32-output bf16 product, has no derivative of
its own).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.swin as jswin
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.data.transforms import normalize as j_normalize
from geovpr.objectives.scaler import fit_scaler as j_fit_scaler
from geovpr.train.model import RegressionModel as JModel
from geovpr.train.optimizer import build_optimizer as j_build_optimizer
from geovpr.train.state import create_train_state as j_create_state
from geovpr.train.steps import make_train_step as j_make_train_step
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.models import swin as tswin
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.objectives.scaler import identity_scaler, scaler_from_arrays
from geovpr_torch.train.state import TrainState, build_optimizer
from geovpr_torch.train.steps import make_train_step

VARIANT = dict(embed_dim=64, depths=(2, 2), num_heads=(2, 4), window_size=7,
               image_size=56)
B, SIZE, STEPS = 4, 56, 3
RTOL, ATOL, UPDATE_SHARE, OUTLIER_SHARE = 1e-5, 1e-7, 0.02, 1e-5
LR = 1e-3
# the schedule's horizon: 3 epochs of 2 steps; gemini's restart period of
# one epoch (2 steps) puts a restart inside the three steps compared
TOTAL_STEPS, STEPS_PER_EPOCH = 6, 2


@pytest.fixture(autouse=True)
def _tiny_variant(monkeypatch):
    """The tiny variant in both packages (DropPath 0 for the step
    comparison), and one torch thread for these small shapes."""
    monkeypatch.setitem(jswin.SWIN_VARIANTS, "tiny-test",
                        dict(VARIANT, drop_path_rate=0.0))
    monkeypatch.setitem(tswin.SWIN_VARIANTS, "tiny-test",
                        dict(VARIANT, drop_path_rate=0.0))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(preset):
    """The preset on the tiny variant, head dropout 0, no augmentation, lr
    1e-3, a restart period of one epoch."""
    out = []
    for build in (j_build_preset, build_preset):
        cfg = build(preset)
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, variant="tiny-test",
                                           head_dropout=0.0,
                                           compute_dtype="float32",
                                           image_size=SIZE),
            data=dataclasses.replace(cfg.data, image_size=SIZE, batch_size=B,
                                     augment="none"),
            optim=dataclasses.replace(cfg.optim, lr=LR, restart_period=1)))
    return out


def _batches(geo: bool, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        target = ((rng.normal(size=(B, 2)) * [300, 100] + [219000, 143000])
                  if geo else rng.uniform(0, 360, size=B))
        out.append(dict(image=rng.integers(0, 256, (B, SIZE, SIZE, 3))
                        .astype(np.uint8), target=target.astype(np.float32),
                        mask=np.ones(B, bool)))
    return out


def _np_params(jparams):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)).items()}


def _assert_params_close(got: dict, want: dict, before: dict, what: str,
                         steps: int):
    outliers, total = 0, 0
    for k, w in want.items():
        g = got[k].detach().numpy()
        b = before[k]
        if k.endswith("attn.qkv_bias"):
            c = w.shape[0] // 3
            assert np.abs(g[c:2 * c] - b[c:2 * c]).max() <= steps * LR * 1.01
            g, w, b = (np.concatenate([a[:c], a[2 * c:]]) for a in (g, w, b))
        err = np.abs(g - w)
        tol = RTOL * np.abs(w) + ATOL + UPDATE_SHARE * np.abs(w - b).max()
        assert err.max() <= 2 * LR * steps, f"{what}: {k} off by {err.max()}"
        outliers += int((err > tol).sum())
        total += err.size
    assert outliers <= OUTLIER_SHARE * total, \
        f"{what}: {outliers} of {total} elements outside the tolerance"


@pytest.mark.parametrize("preset", ["swin_t224_v1", "swin_t224_sincos_acos",
                                    "swin_t224_sincos_gemini"])
def test_three_steps_match_jax(preset, monkeypatch):
    from geovpr_torch.models import swin as swin_mod

    calls = []
    unfused = swin_mod.swin_attn_block_unfused
    monkeypatch.setattr(swin_mod, "swin_attn_block_unfused",
                        lambda *a, **k: calls.append(k.get("residual"))
                        or unfused(*a, **k))
    monkeypatch.setattr(swin_mod, "fused_swin_attn_train", None)
    jcfg, tcfg = _cfgs(preset)
    geo = preset == "swin_t224_v1"
    acos = preset == "swin_t224_sincos_acos"
    batches = _batches(geo, seed=1 if acos else 0)
    targets = np.concatenate([b["target"] for b in batches])
    jscaler = j_fit_scaler(jnp.asarray(targets)) if geo else None
    jstate = j_create_state(
        JModel(config=jcfg.model, dtype=jnp.float32),
        j_build_optimizer(jcfg.optim, total_steps=TOTAL_STEPS,
                          steps_per_epoch=STEPS_PER_EPOCH),
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        scaler=jscaler, out_dim=jcfg.model.out_dim)
    jstep = jax.jit(j_make_train_step(j_objective_for(jcfg),
                                      normalize_fn=j_normalize))
    if acos:
        jobj = j_objective_for(jcfg)
        for b in batches:
            pred = jstate.apply_fn({"params": jstate.params},
                                   j_normalize(jnp.asarray(b["image"])))
            dot = np.sum(np.asarray(pred) * np.asarray(jobj.encode_targets(
                jnp.asarray(b["target"]), None)), axis=-1)
            assert dot.min() > np.cos(np.radians(160.0)), dot

    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.params)))
    tstate = TrainState(
        step=0, model=model,
        opt=build_optimizer(model, tcfg.optim, TOTAL_STEPS, STEPS_PER_EPOCH),
        scaler=(scaler_from_arrays(*jstate.scaler) if geo
                else identity_scaler(2)), seed=0)
    tstep = make_train_step(objective_for(tcfg))
    for i, batch in enumerate(batches):
        before = _np_params(jstate.params)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=RTOL, abs=1e-6)
        assert float(tm["skipped"]) == float(jm["skipped"]) == 0.0
        _assert_params_close(dict(tstate.model.state_dict()),
                             _np_params(jstate.params), before,
                             f"{preset} step {i + 1}", i + 1)
    assert tstate.step == int(jstate.step) == STEPS
    # every block of every step took the unfused half, returning the branch
    assert calls == [False] * (sum(VARIANT["depths"]) * STEPS)


def test_acos_seed0_gradients_match_jax():
    """`swin_t224_sincos_acos` on the batches of seed 0, the ones the step
    comparison above leaves for seed 1 (a prediction there comes to lie
    near 177 degrees from its target, where the acos slope makes Adam's
    step ill-conditioned): at each of the three states of JAX's own
    trajectory over them, the loss and the gradient of every parameter of
    the port against `jax.grad` of JAX's loss on the same parameters, f32,
    at the step comparison's tolerance with the gradient in the place of
    the update: the loss within rtol 1e-5; every element within rtol 1e-5
    and atol 1e-7 plus 2 % of its tensor's largest gradient element, but
    for at most 1e-5 of all elements, which stay within 10 % of it. The
    key bias, whose gradient is roundoff in both packages, is not
    compared."""
    from geovpr_torch.data.transforms import normalize

    preset = "swin_t224_sincos_acos"
    jcfg, tcfg = _cfgs(preset)
    jstate = j_create_state(
        JModel(config=jcfg.model, dtype=jnp.float32),
        j_build_optimizer(jcfg.optim, total_steps=TOTAL_STEPS,
                          steps_per_epoch=STEPS_PER_EPOCH),
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), out_dim=2)
    jstep = jax.jit(j_make_train_step(j_objective_for(jcfg),
                                      normalize_fn=j_normalize))
    jobj, tobj = j_objective_for(jcfg), objective_for(tcfg)
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    names = [n for n, _ in model.named_parameters()]
    worst = 0.0
    for batch in _batches(False, seed=0):
        x = j_normalize(jnp.asarray(batch["image"]))
        enc = jobj.encode_targets(jnp.asarray(batch["target"]), None)

        def jloss(p):
            preds = jstate.apply_fn({"params": p}, x, train=True,
                                    deterministic=False)
            return jobj.loss(preds, enc, jnp.asarray(batch["mask"])), preds

        (jl, jpred), jg = jax.value_and_grad(jloss, has_aux=True)(
            jstate.params)
        dot = np.sum(np.asarray(jobj.codec.normalize(jpred))
                     * np.asarray(enc), axis=-1)
        worst = max(worst, float(np.degrees(np.arccos(np.clip(
            dot, -1.0, 1.0))).max()))
        model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, jstate.params)))
        model.train()
        tl = tobj.loss(model(normalize(torch.from_numpy(batch["image"]))),
                       tobj.encode_targets(torch.from_numpy(
                           batch["target"]), None),
                       torch.from_numpy(batch["mask"]))
        tg = dict(zip(names, torch.autograd.grad(tl, list(
            model.parameters()))))
        assert float(tl.detach()) == pytest.approx(float(jl), rel=RTOL)
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg))
        assert set(want) == set(tg)
        outliers, total = 0, 0
        for k, v in want.items():
            if k.endswith("attn.qkv_bias"):
                continue
            v = v.numpy()
            scale = np.abs(v).max()
            err = np.abs(tg[k].numpy() - v)
            assert err.max() <= 0.1 * scale + ATOL, f"{k} off by {err.max()}"
            outliers += int((err > RTOL * np.abs(v) + ATOL
                             + UPDATE_SHARE * scale).sum())
            total += err.size
        assert outliers <= OUTLIER_SHARE * total, (outliers, total)
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    # the trajectory reaches the ill-conditioned case the re-seed avoids
    assert worst > 160.0, worst


DROP_RATE, DROP_KEEP = 0.25, (True, False, True, True)


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
    """The port's `DropPath.forward` with the same fixed mask."""
    if self.rate == 0.0 or not self.training:
        return x
    keep = 1.0 - self.rate
    mask = torch.tensor(DROP_KEEP).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / keep, torch.zeros_like(x))


def test_drop_path_route_matches_jax(monkeypatch):
    """A tiny window-7 Swin in training mode with DropPath rates rising to
    0.25: the port's output and the gradient of every parameter equal
    `jax.grad` of JAX's SwinTransformer in training mode (its XLA route)
    on the same per-image DropPath mask, f32 on both sides: rtol 1e-4,
    atol 1e-5 times the tensor's largest element. Each block's branch
    comes out of `swin_attn_block_unfused` without its residual, and K7
    is never reached."""
    from geovpr_torch.models import layers as tlayers
    from geovpr_torch.models import swin as swin_mod

    monkeypatch.setattr(jswin, "DropPath", _JaxFixedDropPath)
    monkeypatch.setattr(tlayers.DropPath, "forward", _torch_fixed_drop_path)
    calls = []
    unfused = swin_mod.swin_attn_block_unfused
    monkeypatch.setattr(swin_mod, "swin_attn_block_unfused",
                        lambda *a, **k: calls.append(k.get("residual"))
                        or unfused(*a, **k))
    monkeypatch.setattr(swin_mod, "window_attention_raster", None)
    monkeypatch.setattr(swin_mod, "window_attention_raster_reference", None)

    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (len(DROP_KEEP), SIZE, SIZE, 3)).astype(np.float32)
    res = SIZE // 4 // 2
    w = rng.normal(size=(len(DROP_KEEP), res * res, 128)).astype(np.float32)
    jm = jswin.SwinTransformer(**VARIANT, drop_path_rate=DROP_RATE,
                               dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # the relative-position tables start at zero: give them values
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (v + 0.05 * jax.random.normal(
            jax.random.PRNGKey(len(p)), v.shape)
            if "relative_position_bias_table" in str(p[-1]) else v), params)

    def jloss(p):
        t = jm.apply({"params": p}, jnp.asarray(x),
                     deterministic=False).tokens
        return (t * w).sum(), t

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    tm = tswin.SwinTransformer(**VARIANT, drop_path_rate=DROP_RATE,
                               dtype=torch.float32,
                               param_dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    tm.train()
    tout = tm(torch.from_numpy(x)).tokens
    (tout * torch.from_numpy(w)).sum().backward()
    assert calls == [False] * sum(VARIANT["depths"])

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        v = v.numpy()
        np.testing.assert_allclose(got[k].grad.numpy(), v, rtol=1e-4,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)


def test_proj_f32_vjp_is_autograds(monkeypatch):
    """`_ProjF32` (the f32-output product replaced by the f32 matmul it
    stands for, which is what runs off the card) gives the gradients
    autograd gives through the f32 matmul of the bf16 operands, bit for
    bit: the f32 cotangent times the other operand, rounded to bf16."""
    from geovpr_torch.ops import swin_block as sb

    monkeypatch.setattr(sb, "_mm_f32_out", sb._mm)
    rng = np.random.default_rng(3)
    a0 = torch.from_numpy(rng.normal(size=(2, 7, 16)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(16, 12)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 7, 12)).astype(np.float32))
    grads = []
    for fn in (sb._ProjF32.apply, sb._mm):
        a = a0.bfloat16().requires_grad_(True)
        w = w0.bfloat16().requires_grad_(True)
        out = fn(a, w)
        assert out.dtype == torch.float32
        out.backward(g)
        grads.append((out.detach(), a.grad, w.grad))
    for x, y in zip(*grads):
        assert x.dtype == y.dtype and torch.equal(x, y)
