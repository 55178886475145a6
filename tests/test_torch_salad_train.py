"""Unfrozen DINOv2 + SALAD training in the port (`dinov2salad_frozen_mlp`
with `model.freeze_backbone=False` and `optim.backbone_lr_scale=0.1`; no
preset asks for it), against the JAX package.

A tiny DINOv2 (2 layers, D = 64, 2 heads) at 126 px (81 patch tokens, more
than SALAD's 64 clusters, so the dustbin takes surplus mass) under SALAD
(the 8,448-d descriptor) with the preset's MLP head; f32 on both sides, lr
1e-3. Three steps of the port's training step against JAX's
`make_train_step`: the loss within rtol 1e-5 and every parameter within
the tolerances of `tests/test_torch_dinov2_train.py` (rtol 1e-5 and atol
1e-7 plus 2 % of its tensor's largest update, at most 1e-5 of the elements
outside); the backbone moves and the optimizer keeps its moments. The
transport plan does not change when a constant is added to a whole row of
the scores (the first row update absorbs it), so the dustbin and
`score_fc2`'s bias have a zero gradient in exact arithmetic and a roundoff
one in both packages, which Adam turns into steps of either sign: their
updates are only bounded (at most the backbone's lr a step on each side).
The log-domain Sinkhorn's gradient against `jax.grad` within rtol 1e-5,
atol 1e-7 (the dustbin's: roundoff, below 1e-6 of the largest score
gradient, on both sides). The frozen-feature cache does not engage on an
unfrozen backbone, and `run_train` trains it end to end.
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
from geovpr.ops.sinkhorn import salad_assignment as j_salad_assignment
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
from geovpr_torch.ops.sinkhorn import salad_assignment
from geovpr_torch.train.state import TrainState, build_optimizer
from geovpr_torch.train.steps import make_train_step
from test_torch_dinov2_train import _assert_params_close, _np_params

VARIANT = dict(hidden_size=64, num_layers=2, num_heads=2)
PRESET = "dinov2salad_frozen_mlp"
B, SIZE, STEPS = 2, 126, 3
LR = 1e-3
BACKBONE_LR = 0.1 * LR
# parameters whose gradient is roundoff in exact arithmetic
ROUNDOFF = ("backbone.salad.dustbin", "backbone.salad.score_fc2.bias")


@pytest.fixture(autouse=True)
def _tiny_variant(monkeypatch):
    for mod in (jdino, jsalad, tdino):
        monkeypatch.setitem(mod.DINOV2_VARIANTS, "tiny-test", VARIANT)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(size=SIZE, batch=B, **train):
    out = []
    for build in (j_build_preset, build_preset):
        cfg = build(PRESET)
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, variant="tiny-test", compute_dtype="float32",
                image_size=size, freeze_backbone=False),
            data=dataclasses.replace(cfg.data, image_size=size,
                                     batch_size=batch),
            optim=dataclasses.replace(cfg.optim, lr=LR,
                                      backbone_lr_scale=0.1),
            train=dataclasses.replace(cfg.train, epochs=2, **train)))
    return out


def _targets(rng, n):
    return (rng.normal(size=(n, 2)) * [300, 100]
            + [219000, 143000]).astype(np.float32)


def test_unfrozen_steps_match_jax():
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
    tstate = TrainState(step=0, model=model,
                        opt=build_optimizer(model, tcfg.optim),
                        scaler=scaler_from_arrays(*jstate.scaler), seed=0)
    assert set(tstate.opt.mu) == {n for n, _ in model.named_parameters()}
    tstep = make_train_step(objective_for(tcfg))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    for i, batch in enumerate(batches):
        before = _np_params(jstate.params)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5, abs=1e-6)
        want = _np_params(jstate.params)
        got = model.state_dict()
        for k in ROUNDOFF:
            err = np.abs(got[k].numpy() - want.pop(k)).max()
            assert err <= 2 * BACKBONE_LR * (i + 1), (k, err)
        _assert_params_close(got, want, before, f"step {i}", i + 1)
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, init[k])}
    for part in ("backbone.backbone.blocks.0.attn.qkv_weight",
                 "backbone.backbone.patch_embed.weight",
                 "backbone.salad.score_fc2.weight",
                 "head.hidden0.weight"):
        assert any(k.startswith(part) for k in moved), part


def test_sinkhorn_gradient_matches_jax():
    """`salad_assignment` (3 log-domain iterations, a learnable dustbin)
    under autograd: the gradient of sum(P * W) with respect to the scores
    against `jax.grad`, more tokens than clusters (the dustbin's surplus
    mass) and fewer; the dustbin's roundoff on both sides."""
    rng = np.random.default_rng(1)
    for m, n in ((8, 12), (8, 5)):
        s = rng.normal(size=(2, m, n)).astype(np.float32) * 3
        w = rng.normal(size=(2, m, n)).astype(np.float32)
        dust = np.float32(0.7)

        def jloss(s, d):
            return jnp.sum(j_salad_assignment(s, d) * w)

        js, jd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(s),
                                                 jnp.asarray(dust))
        ts = torch.from_numpy(s).requires_grad_()
        td = torch.tensor(dust).requires_grad_()
        loss = torch.sum(salad_assignment(ts, td) * torch.from_numpy(w))
        gs, gd = torch.autograd.grad(loss, (ts, td))
        assert float(loss) == pytest.approx(float(jloss(s, dust)), rel=1e-5)
        np.testing.assert_allclose(gs.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-7)
        bound = 1e-6 * np.abs(np.asarray(js)).max()
        assert abs(float(gd)) <= bound and abs(float(jd)) <= bound


def _source(seed, n, size):
    rng = np.random.default_rng(seed)
    return ArraySource(rng.integers(0, 256, (n, size, size, 3))
                       .astype(np.uint8), _targets(rng, n))


def test_run_train_unfrozen_salad(tmp_path):
    """Two epochs of 2 steps through `run_train` at 56 px with the
    preset's `cache_frozen_features` on: the cache does not engage (the
    backbone is not frozen), so every step runs the whole model, the
    losses are finite and the backbone moves."""
    _, cfg = _cfgs(size=56, batch=2, cache_frozen_features=True)
    calls = []
    trainer = None

    def spy(self, *a):
        calls.append(1)
        return None

    with pytest.MonkeyPatch.context() as mp:
        orig = tdino.DinoV2.forward
        mp.setattr(tdino.DinoV2, "forward",
                   lambda self, x: spy(self) or orig(self, x))
        trainer = run_train(cfg, _source(0, 4, 56), _source(1, 2, 56),
                            save_dir=str(tmp_path), device="cpu")
    # 2 epochs x (2 steps + 1 validation batch), no extraction pass
    assert len(calls) == 6
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_mse"])
               for r in trainer.history)
    assert trainer._maybe_cache_frozen_features(_source(0, 4, 56),
                                                None) is None
    init = RegressionModel(cfg.model, dtype=torch.float32, train=True)
    from geovpr_torch.train.state import create_train_state
    create_train_state(init, cfg.optim, cfg.train.seed)
    w = "backbone.backbone.blocks.1.mlp.fc1.weight"
    assert not torch.equal(trainer.state.model.state_dict()[w],
                           init.state_dict()[w])
