"""The port's optimizer against the optax chain of `geovpr.train.optimizer`
(five steps on a small tree: AdamW with and without the bias/norm decay
mask, gradient clipping, a host-set lr_scale, backbone_lr_scale 0.1 and
0, each schedule), NaN-skip (parameters and moments kept, the count
advancing as JAX's), and the losses, `fit_scaler`, the objectives'
training half and `iterate_batches`' order against the JAX package.

Tolerances: parameters rtol 1e-6, atol 2e-7 (f32 elementwise arithmetic
in another order; two f32 spacings of a unit parameter); losses rtol 1e-6;
the scaler 1e-6 (mean) and 1e-5 (std) relative; the batch order exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from geovpr.core.config import OptimConfig as JOptimConfig
from geovpr.data.pipeline import ArraySource as JArraySource
from geovpr.data.pipeline import iterate_batches as j_iterate_batches
from geovpr.objectives import losses as jl
from geovpr.objectives import workloads as jw
from geovpr.objectives.scaler import fit_scaler as j_fit_scaler
from geovpr.train.optimizer import build_optimizer, set_lr_scale
from geovpr_torch.core.config import OptimConfig
from geovpr_torch.data.pipeline import ArraySource, iterate_batches
from geovpr_torch.models.layers import LayerNorm
from geovpr_torch.objectives import losses as tl
from geovpr_torch.objectives import workloads as tw
from geovpr_torch.objectives.scaler import fit_scaler
from geovpr_torch.train.optimizer import Optimizer, decay_mask, param_labels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small shapes: the test workers share
    the cores, and torch's thread pool oversubscribed by them runs the
    tiny ops tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 5


class _Tiny(nn.Module):
    """backbone {blk (Linear), norm (LayerNorm), table}, head {out}: the
    flax tree {backbone: {blk: {kernel, bias}, norm: {scale, bias},
    relative_position_bias_table}, head: {out: {kernel, bias}}}."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.blk = nn.Linear(4, 3)
        self.backbone.norm = LayerNorm(3)
        self.backbone.relative_position_bias_table = nn.Parameter(
            torch.zeros(5, 2))
        self.head = nn.Module()
        self.head.out = nn.Linear(3, 2)


# port name -> (flax path, transpose)
_PATHS = {"backbone.blk.weight": (("backbone", "blk", "kernel"), True),
          "backbone.blk.bias": (("backbone", "blk", "bias"), False),
          "backbone.norm.weight": (("backbone", "norm", "scale"), False),
          "backbone.norm.bias": (("backbone", "norm", "bias"), False),
          "backbone.relative_position_bias_table": (
              ("backbone", "relative_position_bias_table"), False),
          "head.out.weight": (("head", "out", "kernel"), True),
          "head.out.bias": (("head", "out", "bias"), False)}


def _to_tree(flat: dict) -> dict:
    tree = {}
    for name, arr in flat.items():
        path, tr = _PATHS[name]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        # a copy: jnp.asarray may alias the torch parameter's memory
        node[path[-1]] = jnp.array(np.array(arr.T if tr else arr))
    return tree


def _from_tree(tree) -> dict:
    out = {}
    for name, (path, tr) in _PATHS.items():
        node = tree
        for k in path:
            node = node[k]
        a = np.asarray(node)
        out[name] = a.T if tr else a
    return out


def _setup(seed=0):
    model = _Tiny()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)))
    grads = [{n: rng.normal(size=p.shape).astype(np.float32)
              for n, p in model.named_parameters()} for _ in range(STEPS)]
    return model, grads


CASES = {
    "adamw": dict(lr=1e-2, weight_decay=0.01),
    "adamw_decay_mask": dict(lr=1e-2, weight_decay=0.1,
                             no_decay_on_bias_norm=True),
    "clip": dict(lr=1e-2, grad_clip_norm=1.0),
    "plateau_lr_scale": dict(lr=1e-2, schedule="plateau"),
    "backbone_0.1": dict(lr=1e-2, backbone_lr_scale=0.1),
    "frozen_backbone": dict(lr=1e-2, backbone_lr_scale=0.0,
                            grad_clip_norm=1.0),
    "cosine": dict(lr=1e-2, schedule="cosine"),
    "cosine_restarts": dict(lr=1e-2, schedule="cosine_restarts",
                            restart_period=1),
    "adam": dict(optimizer="adam", lr=1e-2),
}


def test_decay_mask_and_labels():
    model, _ = _setup()
    assert decay_mask(model) == {
        "backbone.blk.weight": True, "backbone.blk.bias": False,
        "backbone.norm.weight": False, "backbone.norm.bias": False,
        "backbone.relative_position_bias_table": False,
        "head.out.weight": True, "head.out.bias": False}
    assert param_labels(model)["head.out.bias"] == "head"
    assert param_labels(model)["backbone.norm.weight"] == "backbone"


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    model, grads = _setup()
    kw = CASES[case]
    jtx = build_optimizer(JOptimConfig(**kw), total_steps=4,
                          steps_per_epoch=2)
    params = dict(model.named_parameters())
    jparams = _to_tree({n: p.detach().numpy() for n, p in params.items()})
    jstate = jtx.init(jparams)
    opt = Optimizer(OptimConfig(**kw), params, param_labels(model),
                    decay_mask(model), total_steps=4, steps_per_epoch=2)
    for i, g in enumerate(grads):
        if case == "plateau_lr_scale" and i == 2:
            jstate = set_lr_scale(jstate, 0.2)
            opt.lr_scale = 0.2
        upd, jstate = jtx.update(_to_tree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update(params, {n: torch.from_numpy(v) for n, v in g.items()})
        want = _from_tree(jparams)
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                       atol=2e-7, err_msg=f"{case} {i} {n}")
    assert opt.count == STEPS


def test_nan_skip_keeps_floats_and_advances_count():
    """Step 2's gradient holds a NaN: the port keeps the parameters and
    Adam's moments and advances the count; JAX's `jnp.where` on floating
    leaves does the same (`geovpr/train/steps.py:95-99`), so step 3 agrees
    with optax run the same way."""
    model, grads = _setup(1)
    grads[1]["head.out.bias"][0] = np.nan
    cfg = dict(lr=1e-2, weight_decay=0.01)
    jtx = build_optimizer(JOptimConfig(**cfg))
    params = dict(model.named_parameters())
    jparams = _to_tree({n: p.detach().numpy() for n, p in params.items()})
    jstate = jtx.init(jparams)
    opt = Optimizer(OptimConfig(**cfg), params, param_labels(model),
                    decay_mask(model))
    for i, g in enumerate(grads[:3]):
        tg = {n: torch.from_numpy(v) for n, v in g.items()}
        ok = torch.stack([torch.isfinite(t).all() for t in tg.values()]).all()
        before = {n: p.detach().clone() for n, p in params.items()}
        mu_before = {n: t.clone() for n, t in opt.mu.items()}
        opt.update(params, tg, ok)
        upd, new_state = jtx.update(_to_tree(g), jstate, jparams)
        new_params = optax.apply_updates(jparams, upd)
        finite = bool(ok)
        keep = lambda new, old: (jnp.where(finite, new, old)  # noqa: E731
                                 if jnp.issubdtype(new.dtype, jnp.floating)
                                 else new)
        jparams = jax.tree_util.tree_map(keep, new_params, jparams)
        jstate = jax.tree_util.tree_map(keep, new_state, jstate)
        if i == 1:
            assert not finite
            for n, p in params.items():
                assert torch.equal(p.detach(), before[n])
                assert torch.equal(opt.mu[n], mu_before[n])
        want = _from_tree(jparams)
        for n, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                       atol=2e-7, err_msg=f"step {i} {n}")
    assert opt.count == 3


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(6, 2)).astype(np.float32) * 2
    target = rng.normal(size=(6, 2)).astype(np.float32) * 2
    mask = np.array([1, 1, 0, 1, 0, 1], bool)
    return pred, target, mask


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    pred, target, mask = _loss_inputs()
    m = mask if masked else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    pairs = [
        (tl.mse_loss(t(pred), t(target), t(m)),
         jl.mse_loss(j(pred), j(target), j(m))),
        (tl.huber_loss(t(pred), t(target), 1.0, t(m)),
         jl.huber_loss(j(pred), j(target), 1.0, j(m))),
        (tl.maae_deg(t(pred[:, 0] * 200), t(target[:, 0] * 200), t(m)),
         jl.maae_deg(j(pred[:, 0] * 200), j(target[:, 0] * 200), j(m)))]
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa
    pairs.append((tl.acos_angular_loss_deg(t(unit(pred)), t(unit(target)),
                                           t(m)),
                  jl.acos_angular_loss_deg(j(unit(pred)), j(unit(target)),
                                           j(m))))
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_objectives_training_half_match_jax():
    """encode_targets, loss and remap_flip of the geopose and angle
    objectives against JAX's."""
    pred, target, mask = _loss_inputs(1)
    deg = np.array([10.0, 350.0, 90.0, 720.0, 181.0, 0.0], np.float32)
    flip = np.array([1, 0, 1, 1, 0, 0], bool)
    scaler = j_fit_scaler(jnp.asarray(target * 100 + 5000))
    tscaler = fit_scaler(target * 100 + 5000)
    for tobj, jobj in ((tw.GeoposeObjective("huber", 1.0),
                        jw.GeoposeObjective("huber", 1.0)),
                       (tw.GeoposeObjective("mse"),
                        jw.GeoposeObjective("mse"))):
        raw = target * 100 + 5000
        enc = tobj.encode_targets(torch.from_numpy(raw), tscaler)
        np.testing.assert_allclose(
            enc.numpy(), np.asarray(jobj.encode_targets(jnp.asarray(raw),
                                                        scaler)),
            rtol=1e-5, atol=1e-5)
        assert float(tobj.loss(torch.from_numpy(pred), enc,
                               torch.from_numpy(mask))) == pytest.approx(
            float(jobj.loss(jnp.asarray(pred), jnp.asarray(enc.numpy()),
                            jnp.asarray(mask))), rel=1e-6)
    for tobj, jobj, p in (
            (tw.AngleDirectObjective(), jw.AngleDirectObjective(),
             pred[:, :1] * 300),
            (tw.AngleSinCosObjective("acos"),
             jw.AngleSinCosObjective("acos"), pred),
            (tw.AngleSinCosObjective("mse"), jw.AngleSinCosObjective("mse"),
             pred)):
        enc = tobj.encode_targets(torch.from_numpy(deg))
        jenc = jobj.encode_targets(jnp.asarray(deg))
        np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=1e-6,
                                   atol=1e-6)
        assert float(tobj.loss(torch.from_numpy(p), enc,
                               torch.from_numpy(mask))) == pytest.approx(
            float(jobj.loss(jnp.asarray(p), jenc, jnp.asarray(mask))),
            rel=1e-5)
        np.testing.assert_allclose(
            tobj.remap_flip(torch.from_numpy(deg),
                            torch.from_numpy(flip)).numpy(),
            np.asarray(jobj.remap_flip(jnp.asarray(deg), jnp.asarray(flip))))


def test_fit_scaler_matches_jax():
    rng = np.random.default_rng(2)
    x = np.stack([rng.normal(219000, 300, 500), rng.normal(143000, 100, 500),
                  np.zeros(500)], 1).astype(np.float32)
    got, want = fit_scaler(x), j_fit_scaler(jnp.asarray(x))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-6)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-5)
    assert got.scale[2] == 1.0 and got.mean.dtype == torch.float32


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_iterate_batches_order_matches_jax(shuffle, drop):
    n, bs = 11, 4
    imgs = np.arange(n, dtype=np.uint8).reshape(n, 1, 1, 1).repeat(3, -1)
    tg = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
    kw = dict(shuffle=shuffle, seed=5, epoch=3, drop_remainder=drop)
    got = list(iterate_batches(ArraySource(imgs, tg), bs, **kw))
    want = list(j_iterate_batches(JArraySource(imgs, tg), bs, **kw))
    assert len(got) == len(want) == (2 if drop else 3)
    for a, b in zip(got, want):
        for k in ("image", "target", "mask", "_indices"):
            np.testing.assert_array_equal(a[k], b[k])


def test_cosine_restarts_period_counts_epochs():
    """The restart period is in epochs: with 2 steps an epoch and period 1
    the rate returns to lr every 2 steps."""
    from geovpr_torch.train.optimizer import make_schedule
    from geovpr.train.optimizer import make_schedule as j_make_schedule
    cfg = OptimConfig(lr=1.0, schedule="cosine_restarts", restart_period=1)
    jcfg = JOptimConfig(lr=1.0, schedule="cosine_restarts", restart_period=1)
    f, jf = make_schedule(cfg, 1.0, 8, 2), j_make_schedule(jcfg, 1.0, 8, 2)
    for s in range(10):
        assert f(s) == pytest.approx(float(jf(s)), abs=1e-6)
    assert f(2) == f(0) == 1.0
