"""Asynchronous checkpoints in the port (`save_checkpoint(async_save=True)`,
`wait_for_saves`, `TrainConfig.async_checkpoint`, `cli.train
--async-checkpoint`), as the JAX package's (`geovpr/train/checkpoint.py:
44-96`, `geovpr/train/loop.py:310-334`).

On a tiny window-4 Swin on the CPU: an asynchronous save restores to the
state it was taken from, every tensor bit for bit, even though the
optimizer steps after it updated the parameters and moments in place
(a CPU tensor's `.cpu()` is the tensor itself, so the save must copy);
while a write is held in flight, its temporary directory is neither found
by `latest_checkpoint` nor deleted by pruning, which runs once the
directory is in place; a run with `async_checkpoint` writes the run
directory of the synchronous run, tensor for tensor; and the CLI flag
trains.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from geovpr_torch.cli import presets
from geovpr_torch.cli.train import main, run_train
from geovpr_torch.data.pipeline import ArraySource
from geovpr_torch.models.regression import RegressionModel
from geovpr_torch.models.swin import SWIN_VARIANTS
from geovpr_torch.train import checkpoint as ck
from geovpr_torch.train.state import create_train_state
from geovpr_torch.train.steps import make_train_step

TINY = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=4,
            image_size=32)


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setitem(SWIN_VARIANTS, "tiny-test", TINY)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    ck.wait_for_saves()


def _cfg(**train):
    cfg = presets.GEOPOSE_PRESETS["swin_b384_gemini2"]
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, variant="tiny-test",
                                       compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, image_size=32, batch_size=4),
        train=dataclasses.replace(cfg.train, epochs=2, **train))


def _source(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return ArraySource(
        rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8),
        (rng.normal(size=(n, 2)) * [300, 100] + [219000, 143000]).astype(
            np.float32))


def _state(cfg):
    model = RegressionModel(cfg.model, dtype=torch.float32, train=True)
    return create_train_state(model, cfg.optim, seed=0)


def _step(cfg, state, seed):
    from geovpr_torch.cli.presets import objective_for
    src = _source(4, seed)
    make_train_step(objective_for(cfg))(state, {
        "image": torch.from_numpy(src.images),
        "target": torch.from_numpy(src.targets),
        "mask": torch.ones(4, dtype=torch.bool)})


def _flat(state) -> dict:
    out = {f"params.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for k, v in state.opt.state_dict().items():
        if isinstance(v, dict):
            out.update({f"opt.{k}.{n}": t.clone() for n, t in v.items()})
        elif isinstance(v, torch.Tensor):
            out[f"opt.{k}"] = v.clone()
        else:
            out[f"opt.{k}"] = v
    return {**out, "step": state.step}


def _assert_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_async_save_keeps_the_state_at_save_time(tmp_path, monkeypatch):
    """Save asynchronously after one step, the write held until two more
    steps have run (in-place updates of the very tensors being written),
    then restore: every tensor is the one at save time, not the later
    one."""
    cfg = _cfg()
    st = _state(cfg)
    _step(cfg, st, 1)
    at_save = _flat(st)
    path = str(tmp_path / "checkpoint_0")
    gate, save = threading.Event(), torch.save

    def held(obj, f):
        assert gate.wait(30)
        save(obj, f)

    monkeypatch.setattr(ck.torch, "save", held)
    ck.save_checkpoint(path, st, epoch=0, metrics={"best": 1.5},
                       async_save=True)
    _step(cfg, st, 2)
    _step(cfg, st, 3)
    later = _flat(st)
    assert not torch.equal(later["params.head.hidden0.weight"],
                           at_save["params.head.hidden0.weight"])
    gate.set()
    ck.wait_for_saves()
    fresh = _state(cfg)
    restored, epoch = ck.restore_checkpoint(path, fresh)
    assert epoch == 0
    _assert_equal(_flat(restored), at_save)
    with open(os.path.join(path, "run_metrics.json")) as f:
        assert json.load(f) == {"epoch": 0, "best": 1.5}


def test_in_flight_write_is_never_found_or_pruned(tmp_path, monkeypatch):
    """checkpoint_0 written; the write of checkpoint_1 held mid-way:
    `latest_checkpoint` returns checkpoint_0, the temporary directory is no
    checkpoint, and a prune keeping one checkpoint deletes nothing in
    flight. Once released, the prune that follows the landing keeps
    checkpoint_1 alone; a new save waits for the one in flight."""
    from geovpr_torch.train.loop import Trainer

    cfg = _cfg(keep_checkpoints=1)
    st = _state(cfg)
    run = tmp_path / "run"
    run.mkdir()
    ck.save_checkpoint(str(run / "checkpoint_0"), st, epoch=0)
    gate, entered = threading.Event(), threading.Event()
    save = torch.save

    def held(obj, f):
        entered.set()
        assert gate.wait(30)
        save(obj, f)

    monkeypatch.setattr(ck.torch, "save", held)
    trainer = Trainer.__new__(Trainer)
    trainer.run_dir, trainer.train_cfg = str(run), cfg.train
    ck.save_checkpoint(str(run / "checkpoint_1"), st, epoch=1,
                       async_save=True, on_saved=trainer._prune_checkpoints)
    assert entered.wait(30)
    names = sorted(os.listdir(run))
    assert names[0] == "checkpoint_0" and names[1].startswith(
        "checkpoint_1.tmp-")
    assert ck.checkpoint_epoch(names[1]) is None
    assert ck.latest_checkpoint(str(run)) == str(run / "checkpoint_0")
    trainer._prune_checkpoints()
    assert sorted(os.listdir(run)) == names
    gate.set()
    ck.wait_for_saves()
    assert sorted(os.listdir(run)) == ["checkpoint_1"]
    assert ck.latest_checkpoint(str(run)) == str(run / "checkpoint_1")
    # a failed background write surfaces at the next wait
    monkeypatch.setattr(ck.torch, "save", lambda obj, f: 1 / 0)
    ck.save_checkpoint(str(run / "checkpoint_2"), st, epoch=2,
                       async_save=True)
    with pytest.raises(ZeroDivisionError):
        ck.wait_for_saves()
    ck.wait_for_saves()                       # nothing in flight any more


def _run_dir_tensors(run_dir: str) -> dict:
    out = {}
    for d in sorted(os.listdir(run_dir)):
        p = os.path.join(run_dir, d, "state.pt")
        if os.path.isfile(p):
            out[d] = torch.load(p, weights_only=True)
            with open(os.path.join(run_dir, d, "run_metrics.json")) as f:
                out[d]["sidecar"] = json.load(f)
    return out


def _assert_tree_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_async_run_writes_the_sync_run_directory(tmp_path):
    """Two epochs with a validation pass each, `keep_checkpoints` 1: the
    asynchronous run's directory (best/ and the kept checkpoint_1, their
    sidecars) equals the synchronous run's, tensor for tensor, with no
    temporary directory left when `fit` returns."""
    src, val = _source(8, 0), _source(4, 1)
    runs = {}
    for mode in (False, True):
        cfg = _cfg(keep_checkpoints=1, async_checkpoint=mode)
        runs[mode] = run_train(cfg, src, val, device="cpu",
                               save_dir=str(tmp_path / str(mode)))
    sync, asyn = runs[False], runs[True]
    assert sorted(os.listdir(asyn.run_dir)) == sorted(
        os.listdir(sync.run_dir))
    assert {"best", "checkpoint_1", "metrics.jsonl"} <= set(
        os.listdir(asyn.run_dir))
    assert "checkpoint_0" not in os.listdir(asyn.run_dir)
    assert asyn.step_losses == sync.step_losses
    _assert_tree_equal(_run_dir_tensors(asyn.run_dir),
                       _run_dir_tensors(sync.run_dir))


def test_cli_async_checkpoint_trains(tmp_path, monkeypatch):
    """`cli.train --async-checkpoint` for two epochs over a folder of
    JPEGs: both checkpoints and best/ in place when it returns, resumable
    by `--auto-resume`."""
    from PIL import Image

    cfg = _cfg()
    monkeypatch.setitem(presets.GEOPOSE_PRESETS, "swin_b384_gemini2", cfg)
    img = tmp_path / "img"
    img.mkdir()
    rng = np.random.default_rng(0)
    with open(tmp_path / "labels.csv", "w") as f:
        f.write("filename,timestamp,latitude,longitude,angle,Region_ID\n")
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (40, 48, 3)).astype(
                np.uint8)).save(img / f"p{i}.jpg")
            f.write(f"p{i}.jpg,0,{219000 + i * 50.0},{143000 - i},0,1\n")
    args = ["--preset", "swin_b384_gemini2", "--train-csv",
            str(tmp_path / "labels.csv"), "--val-csv",
            str(tmp_path / "labels.csv"), "--image-root", str(img),
            "--device", "cpu", "--async-checkpoint"]
    main(args + ["--save-dir", str(tmp_path / "runs")])
    (run,) = os.listdir(tmp_path / "runs")
    run = tmp_path / "runs" / run
    assert {"best", "checkpoint_0", "checkpoint_1"} <= set(os.listdir(run))
    assert not [d for d in os.listdir(run) if ".tmp-" in d]
    main(args + ["--auto-resume", str(run), "--epochs", "3"])
    assert "checkpoint_2" in os.listdir(run)
