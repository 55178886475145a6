"""Freeze -> unfreeze training (`dinov2_sincos_gemini`) in the port's
`Trainer` against the JAX package's `Trainer.fit`, and the loop around it.

A tiny DINOv2 (2 layers, D = 64, 2 heads, 28 px) with the preset's CLS
sin/cos MLP head, MSE on the encoded pair, AdamW with the bias / norm
no-decay split, backbone learning rate x 0.1, cosine decay and
`freeze_backbone_epochs` (here 1 of 2 epochs); head dropout 0, no
augmentation, f32 on both sides, lr 1e-3 and `unfreeze_lr` 2e-4 so that
every step moves the parameters well past f32 roundoff. Both trainers
start from JAX's initial parameters and run epoch 0 (head only), then
epoch 1 (a fresh optimizer over the whole model). After each epoch the
mean loss agrees within rtol 1e-5, and every parameter element within the
tolerances of `tests/test_torch_train_step.py`: rtol 1e-5 and atol 1e-7
plus 2 % of its tensor's largest update, at most 1e-5 of the elements
outside (within the size of the updates taken, 2 lr each); the key bias
only within its bounded update. The backbone stays bit for bit unchanged
through epoch 0. Also: the first unfrozen step's learning rate against
optax's schedule, the decay mask and the three learning-rate groups
against optax's `multi_transform` trees, a run resumed across the
boundary against the unbroken run, `restore_latest`'s retry with the
unfrozen optimizer, and `cli.evaluate --run-dir` on a checkpoint written
after the unfreeze.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geovpr.models.dinov2 as jdino
import geovpr.train.loop as jloop
from geovpr.cli.presets import build_preset as j_build_preset
from geovpr.cli.presets import objective_for as j_objective_for
from geovpr.data.pipeline import ArraySource as JArraySource
from geovpr.train import optimizer as joptim
from geovpr.train.model import RegressionModel as JModel
import geovpr_torch.cli.presets as tpresets
from geovpr_torch.cli.presets import build_preset, objective_for
from geovpr_torch.cli.train import run_train
from geovpr_torch.data.pipeline import ArraySource
from geovpr_torch.models import dinov2 as tdino
from geovpr_torch.models.convert_jax import state_dict_from_flax
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.train.loop import Trainer
from geovpr_torch.train.optimizer import decay_mask, param_labels

VARIANT = dict(hidden_size=64, num_layers=2, num_heads=2)
PRESET = "dinov2_sincos_gemini"
B, SIZE, N = 4, 28, 8
RTOL, ATOL, UPDATE_SHARE, OUTLIER_SHARE = 1e-5, 1e-7, 0.02, 1e-5
LR, UNFREEZE_LR = 1e-3, 2e-4
EPOCHS, SPE = 2, N // B


@pytest.fixture(autouse=True)
def _tiny_variant(monkeypatch):
    monkeypatch.setitem(jdino.DINOV2_VARIANTS, "tiny-test", VARIANT)
    monkeypatch.setitem(tdino.DINOV2_VARIANTS, "tiny-test", VARIANT)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**train):
    out = []
    for build in (j_build_preset, build_preset):
        cfg = build(PRESET)
        out.append(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, variant="tiny-test",
                                           head_dropout=0.0,
                                           compute_dtype="float32",
                                           image_size=SIZE),
            data=dataclasses.replace(cfg.data, image_size=SIZE, batch_size=B,
                                     augment="none"),
            optim=dataclasses.replace(cfg.optim, lr=LR,
                                      unfreeze_lr=UNFREEZE_LR,
                                      freeze_backbone_epochs=1),
            train=dataclasses.replace(cfg.train, epochs=EPOCHS, **train)))
    return out


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (N, SIZE, SIZE, 3)).astype(np.uint8),
            rng.uniform(0, 360, size=N).astype(np.float32))


def _np(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _np_params(jparams):
    return _np(state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           jparams)))


def _assert_params_close(got: dict, want: dict, before: dict, what: str,
                         lr: float, steps: int):
    outliers, total = 0, 0
    for k, w in want.items():
        g, b = got[k], before[k]
        if k.endswith("attn.qkv_bias"):
            c = w.shape[0] // 3
            assert np.abs(g[c:2 * c] - b[c:2 * c]).max() <= steps * lr * 1.01
            g, w, b = (np.concatenate([a[:c], a[2 * c:]]) for a in (g, w, b))
        err = np.abs(g - w)
        tol = RTOL * np.abs(w) + ATOL + UPDATE_SHARE * np.abs(w - b).max()
        assert err.max() <= 2 * lr * steps, f"{what}: {k} off by {err.max()}"
        outliers += int((err > tol).sum())
        total += err.size
    assert outliers <= OUTLIER_SHARE * total, \
        f"{what}: {outliers} of {total} elements outside the tolerance"


def test_fit_through_the_unfreeze_matches_jax(tmp_path):
    jcfg, tcfg = _cfgs(checkpoint_every=0)
    images, angles = _data()
    jtr = jloop.Trainer(model=JModel(config=jcfg.model, dtype=jnp.float32),
                        objective=j_objective_for(jcfg),
                        optim_cfg=jcfg.optim,
                        train_cfg=dataclasses.replace(
                            jcfg.train, save_dir=str(tmp_path / "j")),
                        data_cfg=jcfg.data)
    jtr.init_state((SIZE, SIZE, 3), total_steps=SPE * EPOCHS,
                   steps_per_epoch=SPE)
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    ttr = Trainer(model=model, objective=objective_for(tcfg),
                  optim_cfg=tcfg.optim,
                  train_cfg=dataclasses.replace(tcfg.train,
                                                save_dir=str(tmp_path / "t")),
                  data_cfg=tcfg.data, device="cpu")
    ttr.init_state(total_steps=SPE * EPOCHS, steps_per_epoch=SPE)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jtr.state.params)))
    assert ttr._frozen_phase and ttr.state.opt.frozen
    assert not any(n.startswith("backbone.") for n in ttr.state.opt.mu)

    jsrc, tsrc = JArraySource(images, angles), ArraySource(images, angles)
    init = _np(model.state_dict())
    for epoch in range(EPOCHS):
        before = _np_params(jtr.state.params)
        jh = jtr.fit(jsrc, epochs=epoch + 1, start_epoch=epoch)
        th = ttr.fit(tsrc, epochs=epoch + 1, start_epoch=epoch)
        assert th[-1]["train_loss"] == pytest.approx(jh[-1]["train_loss"],
                                                     rel=RTOL)
        assert th[-1]["lr_scale"] == jh[-1]["lr_scale"] == 1.0
        got = _np(model.state_dict())
        lr = LR if epoch == 0 else UNFREEZE_LR
        _assert_params_close(got, _np_params(jtr.state.params), before,
                             f"epoch {epoch}", lr, SPE)
        if epoch == 0:
            for k, v in got.items():
                if k.startswith("backbone."):
                    assert np.array_equal(v, init[k]), k
                else:
                    assert not np.array_equal(v, init[k]), k
            assert ttr._frozen_phase
    assert not ttr._frozen_phase and not jtr._frozen_phase
    # the fresh optimizer: count from 0 at the unfreeze, moments for all
    assert ttr.state.opt.count == int(jax.tree_util.tree_leaves(
        jtr.state.opt_state["inner"][-1])[0]) == SPE
    assert set(ttr.state.opt.mu) == set(dict(model.named_parameters()))
    assert ttr.state.step == int(jtr.state.step) == SPE * EPOCHS


def test_first_unfrozen_lr_matches_optax():
    """The unfrozen optimizer's schedule at count 0 and after it, on the
    whole run's horizon, against optax's for the same config: the base lr
    is `unfreeze_lr`, not the steps left's cosine."""
    jcfg, tcfg = _cfgs()
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    tr = Trainer(model=model, objective=objective_for(tcfg),
                 optim_cfg=tcfg.optim, train_cfg=tcfg.train,
                 data_cfg=tcfg.data, device="cpu",
                 run_dir=os.devnull + "_unused")
    tr.init_state(total_steps=SPE * EPOCHS, steps_per_epoch=SPE)
    tr._unfreeze()
    ucfg = dataclasses.replace(jcfg.optim, lr=UNFREEZE_LR)
    sched = joptim.make_schedule(ucfg, ucfg.lr, SPE * EPOCHS, SPE)
    opt = tr.state.opt
    assert opt.count == 0 and opt.lr_scale == 1.0
    assert opt.factor == {"head": 1.0, "backbone": 0.1}
    for step in range(SPE * EPOCHS + 1):
        assert opt.schedule(step) == pytest.approx(float(sched(step)),
                                                   rel=1e-6)
    assert opt.schedule(0) == pytest.approx(UNFREEZE_LR, rel=1e-7)


def test_decay_mask_and_lr_groups_match_optax():
    """On the preset's tree: optax's decay mask and backbone / head labels
    (`geovpr/train/optimizer.py`) mapped through the weight bridge equal
    the port's per parameter, and so the three groups: backbone x 0.1,
    head x 1, and no weight decay on biases, norms, LayerScale, tokens
    and position embeddings."""
    jcfg, tcfg = _cfgs()
    params = jax.tree_util.tree_map(np.asarray, JModel(
        config=jcfg.model, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    as_tree = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda flag, p: np.full(p.shape, float(flag), np.float32),
        tree, params)
    jdecay = state_dict_from_flax(as_tree(joptim.decay_mask(params)))
    jlabel = state_dict_from_flax(as_tree(jax.tree_util.tree_map(
        lambda lab: lab == "backbone", joptim.param_labels(params))))
    model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
    tdecay, tlabel = decay_mask(model), param_labels(model)
    assert set(jdecay) == set(tdecay) == set(tlabel)
    for n in tdecay:
        assert torch.all(jdecay[n] == float(tdecay[n])), n
        assert torch.all(jlabel[n] == float(tlabel[n] == "backbone")), n
    tr = Trainer(model=model, objective=objective_for(tcfg),
                 optim_cfg=tcfg.optim, train_cfg=tcfg.train,
                 data_cfg=tcfg.data, device="cpu",
                 run_dir=os.devnull + "_unused")
    tr.init_state()
    tr._unfreeze()
    opt = tr.state.opt
    groups = {(opt.factor[opt.labels[n]], opt.wd[n]) for n in tdecay}
    assert groups == {(0.1, 0.01), (0.1, 0.0), (1.0, 0.01), (1.0, 0.0)}
    assert not tdecay["backbone.pos_embed"]
    assert not tdecay["backbone.blocks.0.ls1.gamma"]
    assert tdecay["backbone.blocks.0.attn.qkv_weight"]


def _run(tmp, **kw):
    _, tcfg = _cfgs()
    images, angles = _data()
    src = ArraySource(images, angles, [f"p{i}.png" for i in range(N)])
    return run_train(tcfg, src, src, save_dir=str(tmp), device="cpu", **kw)


@pytest.fixture
def runs(tmp_path):
    """Two epochs across the unfreeze in one run; and a run resumed at
    epoch 1 from a copy of its checkpoint_0, written in the frozen phase
    (the same schedule horizon)."""
    whole = _run(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    shutil.copytree(os.path.join(whole.run_dir, "checkpoint_0"),
                    tmp_path / "b" / "checkpoint_0")
    resumed = _run(tmp_path / "b", resume=str(tmp_path / "b"))
    return whole, resumed


def test_resume_across_the_unfreeze_equals_the_unbroken_run(runs):
    whole, resumed = runs
    assert resumed.step_losses == {1: whole.step_losses[1]}
    for (n, a), (_, b) in zip(whole.state.model.state_dict().items(),
                              resumed.state.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n, t in whole.state.opt.mu.items():
        assert torch.equal(t, resumed.state.opt.mu[n]), n
    assert resumed.state.opt.count == whole.state.opt.count == SPE
    with open(os.path.join(whole.run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["lr_scale"] for r in recs] == [1.0, 1.0]


def test_restore_latest_retries_with_the_unfrozen_optimizer(runs, tmp_path):
    """A checkpoint written after the unfreeze holds backbone moments: the
    frozen phase's optimizer refuses it, the retry restores it in full.
    A checkpoint whose moments match neither optimizer raises
    RuntimeError from the first refusal; one whose parameter has a wrong
    name raises at once."""
    whole, _ = runs
    _, tcfg = _cfgs()

    def fresh(run_dir):
        model = RegressionModel(tcfg.model, dtype=torch.float32, train=True)
        tr = Trainer(model=model, objective=objective_for(tcfg),
                     optim_cfg=tcfg.optim, train_cfg=tcfg.train,
                     data_cfg=tcfg.data, device="cpu", run_dir=run_dir)
        tr.init_state(total_steps=SPE * EPOCHS, steps_per_epoch=SPE)
        return tr

    tr = fresh(str(tmp_path / "r"))
    assert tr._frozen_phase
    assert tr.restore_latest(whole.run_dir) == 2
    assert not tr._frozen_phase
    assert set(tr.state.opt.mu) == set(whole.state.opt.mu)
    for n, t in whole.state.opt.nu.items():
        assert torch.equal(t, tr.state.opt.nu[n]), n
    for (n, a), (_, b) in zip(whole.state.model.state_dict().items(),
                              tr.state.model.state_dict().items()):
        assert torch.equal(a, b), n

    def corrupt(edit):
        run = tmp_path / f"bad{len(os.listdir(tmp_path))}"
        shutil.copytree(os.path.join(whole.run_dir, "checkpoint_1"),
                        run / "checkpoint_1")
        path = run / "checkpoint_1" / "state.pt"
        ck = torch.load(path, weights_only=True)
        edit(ck)
        torch.save(ck, path)
        return str(run)

    def rename_moment(ck):
        for key in ("mu", "nu"):
            ck["opt"][key]["head.nope"] = ck["opt"][key].pop("head.out.bias")

    with pytest.raises(RuntimeError, match="either") as e:
        fresh(str(tmp_path / "r2")).restore_latest(corrupt(rename_moment))
    assert isinstance(e.value.__cause__, ValueError)

    def rename_param(ck):
        ck["params"]["head.nope"] = ck["params"].pop("head.out.bias")

    tr = fresh(str(tmp_path / "r3"))
    with pytest.raises(RuntimeError, match="head.nope") as e:
        tr.restore_latest(corrupt(rename_param))
    assert e.value.__cause__ is None and tr._frozen_phase


def test_evaluate_run_dir_reads_the_unfrozen_checkpoint(runs, tmp_path,
                                                        monkeypatch, capsys):
    """`cli.evaluate --run-dir` on `checkpoint_1`, written after the
    unfreeze: it reads the parameters alone, so nothing needs a retry, and
    its metrics equal the trainer's own evaluation of that state."""
    from PIL import Image

    from geovpr_torch.cli.evaluate import main

    whole, _ = runs
    _, tcfg = _cfgs()
    monkeypatch.setitem(tpresets.ANGLE_PRESETS, "dinov2_freeze_test", tcfg)
    images, angles = _data()
    os.makedirs(tmp_path / "img")
    with open(tmp_path / "labels.csv", "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i, (img, a) in enumerate(zip(images, angles)):
            Image.fromarray(img).save(tmp_path / "img" / f"p{i}.png")
            f.write(f"p{i}.png,0,0,0,{float(a)!r},1\n")
    main(["--preset", "dinov2_freeze_test", "--run-dir", whole.run_dir,
          "--checkpoint", "checkpoint_1", "--val-csv",
          str(tmp_path / "labels.csv"), "--image-root",
          str(tmp_path / "img"), "--out-dir", str(tmp_path / "out"),
          "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    angles = np.loadtxt(tmp_path / "labels.csv", delimiter=",", skiprows=1,
                        usecols=(4,), dtype=np.float32)
    want, _ = whole.evaluate_and_predict(ArraySource(images, angles))
    assert set(out["metrics"]) == set(want)
    for k, v in want.items():
        assert out["metrics"][k] == pytest.approx(v, rel=1e-6), k
