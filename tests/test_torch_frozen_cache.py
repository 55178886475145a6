"""The frozen-backbone preset `dinov2salad_frozen_mlp` in the port: its
training step against the JAX package's `make_train_step`, and the
frozen-feature cache of the training loop (`geovpr/train/loop.py:339-397`).

A tiny DINOv2 (2 layers, D = 64, 2 heads, 28 px) under SALAD (64 clusters
of 128, a 256-wide global token: the 8,448-d descriptor) with the preset's
MLP head (8448 -> 512 -> 2, dropout 0), MSE on the scaled (lat, lon),
AdamW with the backbone's learning rate 0; f32 on both sides, lr 1e-3.
JAX stops the gradient at the descriptor and zeroes the backbone's update
before the clip; the port runs the backbone under no grad (the serving
forward) and its optimizer keeps no backbone moments. After each of three
steps the loss agrees within rtol 1e-5 and every parameter element within
the tolerances of `tests/test_torch_train_step.py` (rtol 1e-5 and atol
1e-7 plus 2 % of its tensor's largest update, at most 1e-5 of the
elements outside); the backbone and SALAD stay bit for bit as they were.

The cache: a run with `cache_frozen_features` (the pooled features once
per source, then head-only steps and a head-only validation) gives the
same step losses, validation metrics and parameters, bit for bit, as the
same run without it, as JAX's `tests/test_train.py::TestFrozenFeatureCache`
holds its own; and it applies only where its rule allows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.dinov2 as jdino
import geovpr.models.salad as jsalad
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.data.transforms import normalize as j_normalize
from geovpr.objectives.scaler import fit_scaler as j_fit_scaler
from geovpr.train.model import RegressionModel as JModel
from geovpr.train.optimizer import build_optimizer as j_build_optimizer
from geovpr.train.state import create_train_state as j_create_state
from geovpr.train.steps import make_train_step as j_make_train_step
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.cli.train import run_train
from geovpr_torch.data.pipeline import ArraySource
from geovpr_torch.models import dinov2 as tdino
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.objectives.scaler import scaler_from_arrays
from geovpr_torch.train import loop as tloop
from geovpr_torch.train.state import TrainState, build_optimizer
from geovpr_torch.train.steps import make_train_step

VARIANT = dict(hidden_size=64, num_layers=2, num_heads=2)
PRESET = "dinov2salad_frozen_mlp"
B, SIZE, STEPS, N = 4, 28, 3, 10
RTOL, ATOL, UPDATE_SHARE, OUTLIER_SHARE = 1e-5, 1e-7, 0.02, 1e-5
LR = 1e-3


@pytest.fixture(autouse=True)
def _tiny_variant(monkeypatch):
    for mod in (jdino, jsalad, tdino):
        monkeypatch.setitem(mod.DINOV2_VARIANTS, "tiny-test", VARIANT)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**data):
    out = []
    for build in (j_build_preset, build_preset):
        cfg = build(PRESET)
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, variant="tiny-test",
                                           compute_dtype="float32",
                                           image_size=SIZE),
            data=dataclasses.replace(cfg.data, image_size=SIZE, batch_size=B,
                                     **data),
            optim=dataclasses.replace(cfg.optim, lr=LR),
            train=dataclasses.replace(cfg.train, epochs=2)))
    return out


def _targets(rng, n):
    return (rng.normal(size=(n, 2)) * [300, 100]
            + [219000, 143000]).astype(np.float32)


def _np(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def test_three_steps_match_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    batches = [dict(image=rng.integers(0, 256, (B, SIZE, SIZE, 3))
                    .astype(np.uint8), target=_targets(rng, B),
                    mask=np.ones(B, bool)) for _ in range(STEPS)]
    targets = np.concatenate([b["target"] for b in batches])
    jstate = j_create_state(JModel(config=jcfg.model, dtype=jnp.float32),
                            j_build_optimizer(jcfg.optim),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)),
                            scaler=j_fit_scaler(jnp.asarray(targets)))
    jstep = jax.jit(j_make_train_step(j_objective_for(jcfg),
                                      normalize_fn=j_normalize))
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.params)))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tstate = TrainState(step=0, model=model,
                        opt=build_optimizer(model, tcfg.optim),
                        scaler=scaler_from_arrays(*jstate.scaler), seed=0)
    assert set(tstate.opt.mu) == {n for n, _ in model.named_parameters()
                                  if n.startswith("head.")}
    tstep = make_train_step(objective_for(tcfg))
    init = _np(model.state_dict())
    for i, batch in enumerate(batches):
        before = _np(state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, jstate.params)))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=RTOL, abs=1e-6)
        want = _np(state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, jstate.params)))
        got = _np(model.state_dict())
        outliers, total = 0, 0
        for k, w in want.items():
            if not k.startswith("head."):
                assert np.array_equal(got[k], init[k]), k
                assert np.array_equal(w, init[k]), k
                continue
            err = np.abs(got[k] - w)
            tol = (RTOL * np.abs(w) + ATOL
                   + UPDATE_SHARE * np.abs(w - before[k]).max())
            assert err.max() <= 2 * LR * (i + 1), k
            outliers += int((err > tol).sum())
            total += err.size
        assert outliers <= OUTLIER_SHARE * total, (i, outliers, total)


def _source(seed=0):
    rng = np.random.default_rng(seed)
    return ArraySource(rng.integers(0, 256, (N, SIZE, SIZE, 3))
                       .astype(np.uint8), _targets(rng, N))


def test_cached_run_equals_uncached_run(tmp_path, monkeypatch):
    """Two epochs of 3 steps (the last one padded) with a validation pass
    each: with the cache, the pooled features are extracted once per
    source and no step or validation runs the backbone; without it, every
    step runs it under no grad. Losses, metrics and parameters agree bit
    for bit, and the backbone and SALAD are untouched."""
    _, cfg = _cfgs()
    train_src, val_src = _source(0), _source(1)
    calls = []
    pooled = RegressionModel.pooled_features
    monkeypatch.setattr(RegressionModel, "pooled_features",
                        lambda self, x: calls.append(x.shape[0])
                        or pooled(self, x))
    runs = {}
    for cache in (True, False):
        calls.clear()
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, cache_frozen_features=cache))
        runs[cache] = run_train(c, train_src, val_src,
                                save_dir=str(tmp_path / str(cache)),
                                device="cpu")
        batches = 2 * -(-N // B)
        # cached: one extraction pass over each source; uncached: every
        # step of both epochs and every validation batch
        assert len(calls) == (batches if cache else 2 * batches), calls
    cached, plain = runs[True], runs[False]
    assert cached.step_losses == plain.step_losses
    strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                       if k != "seconds"}
    assert [strip(r) for r in cached.history] == \
        [strip(r) for r in plain.history]
    init = RegressionModel(cfg.model, dtype=torch.float32, train=True)
    tloop.create_train_state(init, cfg.optim, cfg.train.seed)
    for (n, a), (_, b) in zip(cached.state.model.state_dict().items(),
                              plain.state.model.state_dict().items()):
        assert torch.equal(a, b), n
        if not n.startswith("head."):
            assert torch.equal(a, init.state_dict()[n]), n


@pytest.mark.parametrize("change, cached", [
    ({}, True),
    ({"data": {"augment": "geo_light"}}, False),
    ({"train": {"cache_frozen_features": False}}, False),
    ({"model": {"freeze_backbone": False, "family": "dinov2"}}, False)])
def test_cache_eligibility(tmp_path, change, cached):
    """The cache applies only with `cache_frozen_features`, a frozen
    backbone and no augmentation, as JAX's rule."""
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v)
        for k, v in change.items()})
    model = RegressionModel(cfg.model, dtype=torch.float32, train=True)
    tr = tloop.Trainer(model=model, objective=objective_for(cfg),
                       optim_cfg=cfg.optim, train_cfg=cfg.train,
                       data_cfg=cfg.data, device="cpu",
                       run_dir=str(tmp_path))
    tr.init_state()
    src = _source()
    got = tr._maybe_cache_frozen_features(src, src)
    assert (got is not None) == cached
    if cached:
        feats = got[0]
        assert feats.images.shape == (N, model.backbone.descriptor_dim)
        assert feats.images.dtype == np.float32
        np.testing.assert_array_equal(feats.targets, src.targets)
        # the rows at their own indices: the last batch holds rows 8, 9
        # and two pad copies of row 9, which are dropped
        tail = np.array([N - 2, N - 1, N - 1, N - 1])
        with torch.inference_mode():
            model.eval()
            want = model.pooled_features(tr._normalize(
                torch.from_numpy(src.images[tail])))
        np.testing.assert_array_equal(feats.images[N - 2:], want[:2].numpy())
