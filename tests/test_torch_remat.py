"""`model.remat` in the port: each transformer block's activations
recomputed in the backward (`layers.remat_call`, JAX's `nn.remat` per
block), on the plain path on the CPU.

With DropPath above 0 in training mode, remat on and remat off give bit
for bit the same loss, gradients and updated parameters, for a tiny DINOv2
(2 layers, D = 64), a tiny window-12 Swin (two stages at 96 px: a shifted
block, the training route's window) and a tiny DINOv2 + SALAD with its
backbone unfrozen. This is the case that catches a recompute drawing other
DropPath masks than the forward did (`torch.utils.checkpoint` restores
only torch's default generators, not the explicit ones the training step
sets): another draw gives another gradient, which is checked too. Then
three remat steps of the DINOv2 preset against JAX's `remat=True` step, at
the tolerances of `tests/test_torch_dinov2_train.py`, and the CNN families
ignoring `remat`, as JAX's registry does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.dinov2 as jdino
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.data.transforms import normalize as j_normalize
from geovpr.objectives.scaler import fit_scaler as j_fit_scaler
from geovpr.train.model import RegressionModel as JModel
from geovpr.train.optimizer import build_optimizer as j_build_optimizer
from geovpr.train.state import create_train_state as j_create_state
from geovpr.train.steps import make_train_step as j_make_train_step
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.data.transforms import normalize
from geovpr_torch.models import dinov2 as tdino
from geovpr_torch.models import swin as tswin
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.layers import DropPath, init_weights_, set_rng
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.models.registry import build_backbone
from geovpr_torch.objectives.scaler import fit_scaler, scaler_from_arrays
from geovpr_torch.train.state import TrainState, build_optimizer
from geovpr_torch.train.steps import make_train_step
from test_torch_dinov2_train import _assert_params_close, _np_params

DINO = dict(hidden_size=64, num_layers=2, num_heads=2)
SWIN12 = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=12,
              image_size=96)
# (preset, model changes, image size, batch)
MODELS = {
    "dinov2": ("dinov2_meanpool_huber", dict(variant="tiny-test"), 28, 4),
    "swin_w12": ("swin_b384_gemini2", dict(variant="tiny-w12"), 96, 2),
    "dinov2_salad": ("dinov2salad_frozen_mlp",
                     dict(variant="tiny-test", freeze_backbone=False), 56, 4),
}
DROP = 0.3
LR = 1e-3


@pytest.fixture(autouse=True)
def _tiny_variants(monkeypatch):
    monkeypatch.setitem(jdino.DINOV2_VARIANTS, "tiny-test", DINO)
    monkeypatch.setitem(tdino.DINOV2_VARIANTS, "tiny-test", DINO)
    monkeypatch.setitem(tswin.SWIN_VARIANTS, "tiny-w12", SWIN12)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    preset, change, size, batch = MODELS[name]
    cfg = build_preset(preset)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, image_size=size, **change),
        data=dataclasses.replace(cfg.data, image_size=size, batch_size=batch,
                                 augment="none"),
        optim=dataclasses.replace(cfg.optim, lr=LR, backbone_lr_scale=0.1))


def _model(cfg, remat: bool):
    model = RegressionModel(dataclasses.replace(cfg.model, remat=remat),
                            dtype=getattr(torch, cfg.model.compute_dtype),
                            train=True)
    init_weights_(model, torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = DROP
    return model


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, s = cfg.data.batch_size, cfg.data.image_size
    return {"image": torch.from_numpy(rng.integers(0, 256, (b, s, s, 3))
                                      .astype(np.uint8)),
            "target": torch.from_numpy((rng.normal(size=(b, 2)) * [300, 100]
                                        + [219000, 143000])
                                       .astype(np.float32)),
            "mask": torch.ones(b, dtype=torch.bool)}


def _loss_and_grads(model, cfg, batch, scaler, seed: int):
    objective = objective_for(cfg)
    model.train()
    set_rng(model, torch.Generator().manual_seed(seed))
    try:
        preds = model(normalize(batch["image"].float() / 255.0,
                                cfg.data.mean, cfg.data.std))
        loss = objective.loss(preds, objective.encode_targets(
            batch["target"], scaler), batch["mask"])
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
    finally:
        set_rng(model, None)
    return loss.detach(), grads


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_is_bit_equal_with_droppath(name):
    cfg = _cfg(name)
    batch = _batch(cfg)
    scaler = fit_scaler(batch["target"].numpy())
    plain, remat = _model(cfg, False), _model(cfg, True)
    assert any(getattr(m, "remat", False) for m in remat.modules())
    assert not any(getattr(m, "remat", False) for m in plain.modules())
    names = [n for n, _ in plain.named_parameters()]
    loss0, g0 = _loss_and_grads(plain, cfg, batch, scaler, seed=5)
    loss1, g1 = _loss_and_grads(remat, cfg, batch, scaler, seed=5)
    assert torch.equal(loss0, loss1)
    for n, a, b in zip(names, g0, g1):
        assert (a is None) == (b is None), n
        if a is not None:
            assert torch.equal(a, b), n
    if name == "dinov2_salad":      # the unfrozen backbone has a gradient
        assert all(g is not None and g.any() for n, g in zip(names, g1)
                   if n.startswith("backbone.backbone.blocks"))
    # the DropPath draws matter: another seed, another gradient
    _, g2 = _loss_and_grads(remat, cfg, batch, scaler, seed=6)
    assert any(a is not None and not torch.equal(a, b)
               for a, b in zip(g1, g2))
    # and a whole training step (the step's own generators) stays equal
    states = [TrainState(step=0, model=m, opt=build_optimizer(m, cfg.optim),
                         scaler=scaler, seed=0) for m in (plain, remat)]
    step = make_train_step(objective_for(cfg))
    m0, m1 = (step(st, batch) for st in states)
    assert torch.equal(m0["loss"], m1["loss"])
    for (n, a), b in zip(plain.state_dict().items(),
                         remat.state_dict().values()):
        assert torch.equal(a, b), n


def test_cnn_families_ignore_remat():
    """JAX's registry passes `remat` only to the transformer families; the
    port's CNN backbones take none, and a config asking for it trains as
    without it."""
    from geovpr_torch.core.config import ModelConfig
    for family, variant in (("efficientnet", "b0"), ("convnext", "base-224")):
        model = build_backbone(ModelConfig(family=family, variant=variant,
                                           remat=True), device="meta",
                               train=True)
        assert not hasattr(model, "remat")


def test_remat_steps_match_jax():
    """Three steps of `dinov2_meanpool_huber` on the tiny DINOv2 with
    `model.remat` on both sides (f32, DropPath 0, as JAX's preset): the
    port's remat step against JAX's, at the tolerances of
    `tests/test_torch_dinov2_train.py`."""
    preset = "dinov2_meanpool_huber"
    size, b, steps = 28, 4, 3
    cfgs = []
    for build in (j_build_preset, build_preset):
        cfg = build(preset)
        cfgs.append(dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, variant="tiny-test", compute_dtype="float32",
                image_size=size, remat=True, head_dropout=0.0),
            data=dataclasses.replace(cfg.data, image_size=size, batch_size=b,
                                     augment="none"),
            optim=dataclasses.replace(cfg.optim, lr=LR)))
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(0)
    batches = [dict(image=rng.integers(0, 256, (b, size, size, 3))
                    .astype(np.uint8),
                    target=(rng.normal(size=(b, 2)) * [300, 100]
                            + [219000, 143000]).astype(np.float32),
                    mask=np.ones(b, bool)) for _ in range(steps)]
    targets = np.concatenate([x["target"] for x in batches])
    jstate = j_create_state(JModel(config=jcfg.model, dtype=jnp.float32),
                            j_build_optimizer(jcfg.optim),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)),
                            scaler=j_fit_scaler(jnp.asarray(targets)))
    jstep = jax.jit(j_make_train_step(j_objective_for(jcfg),
                                      normalize_fn=j_normalize))
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    assert model.backbone.remat
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.params)))
    tstate = TrainState(step=0, model=model,
                        opt=build_optimizer(model, tcfg.optim),
                        scaler=scaler_from_arrays(*jstate.scaler), seed=0)
    tstep = make_train_step(objective_for(tcfg))
    for i, batch in enumerate(batches):
        before = _np_params(jstate.params)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5, abs=1e-6)
        _assert_params_close(model.state_dict(), _np_params(jstate.params),
                             before, f"step {i}", i + 1)
