"""The port's training loop (`geovpr_torch.train.loop.Trainer`,
`geovpr_torch.cli.train`): a fit of a small registered Swin preset on the
CPU writes `metrics.jsonl`, `checkpoint_{epoch}/` and `best/`; the plateau
and early-stop counters follow the JAX `Trainer`'s rule on a scripted
validation sequence (both loops driven with their steps and evaluations
replaced); a run resumed from `checkpoint_0` ends where the unbroken run
ends, bit for bit; the window-7 Swin and frozen-backbone DINOv2 presets
train; remat and the decoded-image cache repeat the plain run; and the CLI
refuses what is not ported.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import geovpr.train.loop as jloop
from geovpr.core.config import DataConfig as JDataConfig
from geovpr.core.config import OptimConfig as JOptimConfig
from geovpr.core.config import TrainConfig as JTrainConfig
from geovpr.data.pipeline import ArraySource as JArraySource
from geovpr.objectives.workloads import GeoposeObjective as JGeopose
from geovpr_torch.cli import presets
from geovpr_torch.cli.train import main, run_train
from geovpr_torch.core.config import DataConfig, OptimConfig, TrainConfig
from geovpr_torch.data.pipeline import ArraySource
from geovpr_torch.models.swin import SWIN_VARIANTS
from geovpr_torch.objectives.workloads import GeoposeObjective
from geovpr_torch.train.loop import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small shapes: the test workers share
    the cores, and torch's thread pool oversubscribed by them runs the
    tiny ops tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(embed_dim=64, depths=(2, 2), num_heads=(2, 4), window_size=4,
            image_size=32)


def _tiny_preset():
    cfg = presets.GEOPOSE_PRESETS["swin_b384_gemini2"]
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, variant="tiny-test",
                                       compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, image_size=32, batch_size=4),
        train=dataclasses.replace(cfg.train, epochs=2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tiny preset trained for two epochs in one run, and for one epoch
    and then resumed from its checkpoint_0 for the second."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(SWIN_VARIANTS, "tiny-test", TINY)
        cfg, src = _tiny_preset(), _source()
        tmp = tmp_path_factory.mktemp("runs")
        whole = run_train(cfg, src, src, save_dir=str(tmp / "a"),
                          device="cpu")
        part = run_train(cfg, src, src, save_dir=str(tmp / "b"),
                         device="cpu", epochs=1)
        resumed = run_train(cfg, src, src, save_dir=str(tmp / "b"),
                            device="cpu", resume=part.run_dir)
        yield whole, resumed


def _source(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return ArraySource(
        rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8),
        (rng.normal(size=(n, 2)) * [300, 100] + [219000, 143000]).astype(
            np.float32), [f"{i}.jpg" for i in range(n)])


def test_fit_writes_run_directory(runs):
    tr = runs[0]
    files = sorted(os.listdir(tr.run_dir))
    assert {"best", "checkpoint_0", "checkpoint_1",
            "metrics.jsonl"} <= set(files)
    with open(os.path.join(tr.run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs] == [0, 1]
    assert {"train_loss", "skipped_updates", "lr_scale", "seconds",
            "val_mse", "val_rmse", "val_mae_lat"} <= set(recs[0])
    with open(os.path.join(tr.run_dir, "checkpoint_1",
                           "run_metrics.json")) as f:
        side = json.load(f)
    assert {"epoch", "bad_epochs", "plateau_bad", "best",
            "best_epoch"} <= set(side)
    assert tr.state.step == 2 * 3 and tr.state.opt.count == 6
    assert len(tr.step_losses[1]) == 3


def test_resume_equals_unbroken_run(runs):
    """Two epochs in one run against one epoch and a resume from its
    checkpoint_0: the same parameters, optimizer state and history (the
    CPU run is deterministic; every draw derives from (seed, step))."""
    whole, resumed = runs
    assert sorted(resumed.step_losses) == [1]
    assert resumed.step_losses[1] == whole.step_losses[1]
    for (n, a), (_, b) in zip(whole.state.model.state_dict().items(),
                              resumed.state.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n, t in whole.state.opt.mu.items():
        assert torch.equal(t, resumed.state.opt.mu[n]), n
    assert resumed.state.opt.count == whole.state.opt.count == 6
    strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                       if k != "seconds"}
    assert [strip(r) for r in resumed.history] == \
        [strip(r) for r in whole.history[1:]]


# validation MSE per epoch: improvements, ties (not < best - 1e-12), a
# tiny gain, then a plateau long enough to stop early
SCRIPT = [5.0, 4.0, 4.0, 4.5, 4.0 - 1e-13, 3.9, 3.9, 4.2, 4.1, 4.0, 3.95,
          3.9, 3.9, 3.9, 3.9]


class _JHead(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False, deterministic=True):
        return fnn.Dense(2)(x.reshape(x.shape[0], -1)[:, :4])


def _jax_run(tmp_path, monkeypatch, optim, train_cfg):
    it = iter(SCRIPT)
    monkeypatch.setattr(jloop, "save_checkpoint", lambda *a, **k: None)
    tr = jloop.Trainer(model=_JHead(), objective=JGeopose(),
                       optim_cfg=JOptimConfig(**optim),
                       train_cfg=JTrainConfig(**train_cfg,
                                              save_dir=str(tmp_path / "j")),
                       data_cfg=JDataConfig(image_size=2, batch_size=2))
    tr._train_step = lambda state, batch: (state, {
        "loss": jnp.float32(1.0), "skipped": jnp.float32(0.0)})
    tr.evaluate = lambda source, _step=None: {"mse": next(it)}
    src = JArraySource(np.zeros((4, 2, 2, 3), np.uint8),
                       np.zeros((4, 2), np.float32))
    return tr.fit(src, src)


def _port_run(tmp_path, optim, train_cfg):
    it = iter(SCRIPT)
    tr = Trainer(model=torch.nn.Linear(4, 2), objective=GeoposeObjective(),
                 optim_cfg=OptimConfig(**optim),
                 train_cfg=TrainConfig(**train_cfg,
                                       save_dir=str(tmp_path / "t")),
                 data_cfg=DataConfig(image_size=2, batch_size=2),
                 device="cpu")
    tr._train_step = lambda state, batch: {
        "loss": torch.tensor(1.0), "skipped": torch.tensor(0.0)}
    tr.evaluate = lambda source: {"mse": next(it)}
    src = ArraySource(np.zeros((4, 2, 2, 3), np.uint8),
                      np.zeros((4, 2), np.float32))
    return tr.fit(src, src)


def test_plateau_and_early_stop_follow_jax(tmp_path, monkeypatch):
    optim = dict(schedule="plateau", plateau_factor=0.2, plateau_patience=2)
    train_cfg = dict(epochs=len(SCRIPT), early_stop_patience=6,
                     checkpoint_every=0)
    want = _jax_run(tmp_path, monkeypatch, optim, train_cfg)
    got = _port_run(tmp_path, optim, train_cfg)
    assert len(got) == len(want) < len(SCRIPT)
    np.testing.assert_allclose([r["lr_scale"] for r in got],
                               [r["lr_scale"] for r in want], rtol=1e-6)
    assert [r["val_mse"] for r in got] == [r["val_mse"] for r in want]
    assert min(r["lr_scale"] for r in got) < 1.0


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    args = ["--preset", "swin_b384_gemini2", "--train-csv", "x.csv",
            "--image-root", ".", "--device", "cpu"]
    # --async-checkpoint is ported (tests/test_torch_async_checkpoint.py):
    # the flag no longer stops the CLI, which goes on to read the CSV
    with pytest.raises(FileNotFoundError, match="x.csv"):
        main(args + ["--async-checkpoint"])
    # --multihost is ported (tests/test_torch_dp_train.py); with neither
    # the flags nor torchrun's environment it names what it lacks
    with pytest.MonkeyPatch.context() as mp:
        for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
            mp.delenv(name, raising=False)
        with pytest.raises(ValueError, match="coordinator"):
            main(args + ["--multihost"])
    # an unfrozen DINOv2 + SALAD (no preset asks for one), remat and the
    # decoded-image cache are ported: each trains an epoch on a tiny
    # registered DINOv2
    from geovpr_torch.models.dinov2 import DINOV2_VARIANTS
    monkeypatch.setitem(DINOV2_VARIANTS, "base-14", TINY_DINO)
    salad = presets.build_preset("dinov2salad_frozen_mlp")
    salad = dataclasses.replace(salad, data=dataclasses.replace(
        salad.data, image_size=28, batch_size=2))
    rng = np.random.default_rng(0)
    src = ArraySource(rng.integers(0, 256, (2, 28, 28, 3)).astype(np.uint8),
                      (rng.normal(size=(2, 2)) * [300, 100]
                       + [219000, 143000]).astype(np.float32))
    for i, cfg in enumerate((
            dataclasses.replace(salad, model=dataclasses.replace(
                salad.model, freeze_backbone=False)),
            dataclasses.replace(salad, model=dataclasses.replace(
                salad.model, freeze_backbone=False, remat=True)),
            dataclasses.replace(salad, data=dataclasses.replace(
                salad.data, cache_decoded="ram")))):
        tr = run_train(cfg, src, src, device="cpu", epochs=1,
                       save_dir=str(tmp_path / str(i)))
        assert np.isfinite(tr.history[0]["train_loss"])


TINY_W7 = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2),
               window_size=7, image_size=56)
TINY_DINO = dict(hidden_size=64, num_layers=2, num_heads=2)


@pytest.mark.parametrize("name", [
    "swin_t224_v1", "swin_t224_v2", "swin_t224_sincos_acos",
    "swin_t224_sincos_gemini", "dinov2_sincos_gemini",
    "dinov2salad_frozen_mlp"])
def test_run_train_trains_the_transformer_presets(name, tmp_path,
                                                  monkeypatch):
    """Each window-7 Swin preset and the two DINOv2 presets with a frozen
    backbone train two epochs on a tiny registered variant with their own
    augmentation, head, loss, schedule and phases (dinov2_sincos_gemini
    with one frozen epoch): finite losses and metrics, a checkpoint per
    epoch."""
    from geovpr_torch.models.dinov2 import DINOV2_VARIANTS

    monkeypatch.setitem(SWIN_VARIANTS, "tiny-224", TINY_W7)
    monkeypatch.setitem(DINOV2_VARIANTS, "base-14", TINY_DINO)
    cfg = presets.build_preset(name)
    size = 56 if name.startswith("swin") else 28
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, image_size=size,
                                      batch_size=2),
        optim=dataclasses.replace(cfg.optim, freeze_backbone_epochs=min(
            cfg.optim.freeze_backbone_epochs, 1)),
        train=dataclasses.replace(cfg.train, epochs=2))
    rng = np.random.default_rng(0)
    geo = name in presets.GEOPOSE_PRESETS
    src = ArraySource(
        rng.integers(0, 256, (4, size, size, 3)).astype(np.uint8),
        (rng.normal(size=(4, 2)) * [300, 100] + [219000, 143000]).astype(
            np.float32) if geo else rng.uniform(0, 360, 4).astype(
                np.float32))
    tr = run_train(cfg, src, src, save_dir=str(tmp_path), device="cpu")
    assert [r["epoch"] for r in tr.history] == [0, 1]
    for r in tr.history:
        assert np.isfinite(r["train_loss"]) and np.isfinite(r["val_mse"])
    assert {"checkpoint_0", "checkpoint_1", "best"} <= set(
        os.listdir(tr.run_dir))
    assert not tr._frozen_phase


@pytest.mark.parametrize("field", ["cache_decoded", "remat"])
def test_run_train_refuses_fields_it_does_not_honour(field, runs, tmp_path,
                                                     monkeypatch):
    """`data.cache_decoded` and `model.remat`, once refused, are honoured:
    the tiny preset's two epochs with remat (DropPath 0.1 in training
    mode, every block recomputed) repeat the plain run bit for bit; with
    `cache_decoded` a path prefix, a source of JPEG files trains through
    `{prefix}.train.npy` and `{prefix}.val.npy` memmaps to the same losses
    and parameters as the uncached run on the same files."""
    from PIL import Image

    from geovpr_torch.data.pipeline import ImageFolderSource

    monkeypatch.setitem(SWIN_VARIANTS, "tiny-test", TINY)
    cfg, src = _tiny_preset(), _source()
    if field == "remat":
        base = runs[0]
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat=True))
    else:
        paths = []
        for i, img in enumerate(src.images):
            paths.append(str(tmp_path / f"{i}.jpg"))
            Image.fromarray(img).save(paths[-1], quality=90)
        src = ImageFolderSource(paths=paths, targets=src.targets,
                                image_size=32, num_threads=2)
        base = run_train(cfg, src, src, save_dir=str(tmp_path / "plain"),
                         device="cpu")
        prefix = str(tmp_path / "cache")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, cache_decoded=prefix))
    tr = run_train(cfg, src, src, save_dir=str(tmp_path / "run"),
                   device="cpu")
    if field == "cache_decoded":
        for role in ("train", "val"):
            cache = np.load(f"{prefix}.{role}.npy")
            np.testing.assert_array_equal(
                cache, src.get_batch(np.arange(len(src)))["image"])
    assert tr.step_losses == base.step_losses
    for (n, a), b in zip(tr.state.model.state_dict().items(),
                         base.state.model.state_dict().values()):
        assert torch.equal(a, b), n
