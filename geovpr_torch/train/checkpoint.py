"""Checkpoints of the port (the counterpart of `geovpr.train.checkpoint`):
the port's own format, `torch.save` of plain tensors, with the JAX
package's directory contract.

- `checkpoint_{epoch}/` per epoch and `best/` for the best model, each a
  directory holding `state.pt` (step, the model's state_dict: parameters
  and BatchNorm running statistics, as JAX's checkpoint holds params and
  batch_stats; optimizer moments, count and lr_scale, the target scaler,
  the seed, the epoch) and the
  `run_metrics.json` sidecar (the epoch and the loop's counters:
  `bad_epochs`, `plateau_bad`, `best`, `best_epoch`, or the val metrics);
- writes are atomic: the directory is written under a temporary name and
  renamed into place;
- `latest_checkpoint` finds the newest `checkpoint_{epoch}`;
- `load_run_checkpoint` reads the parameters (with the running
  statistics) and the scaler of a run
  directory's `best`, `latest` or named checkpoint, as
  `geovpr.cli.common.load_trained` resolves them, for
  `geovpr_torch.cli.evaluate --run-dir`.

Under a mesh (`geovpr/train/checkpoint.py:99-132`) whole tensors go on
disk: every rank calls `save_checkpoint`, the tensor-parallel moments are
gathered whole, rank 0 writes and the others wait at a barrier. Every rank
restores, and the optimizer keeps its part of each split moment, so a run
saved on one mesh resumes on another (`(4,)` on `(2, 2)` or on one
process), as JAX restores into the template's shardings.

Reading the JAX package's orbax run directories is not ported (ROADMAP).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from geovpr_torch.objectives.scaler import ScalerState
from geovpr_torch.parallel.mesh import barrier, is_writer
from geovpr_torch.train.state import TrainState


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    metrics: Optional[dict] = None, mesh=None) -> None:
    """Write `state` atomically to the directory `path` (with a mesh: on
    every rank, rank 0 writing)."""
    opt = _cpu(state.opt.state_dict())       # gathers split moments
    if is_writer(mesh):
        _write(path, state, epoch, metrics, opt)
    barrier(mesh)


def _write(path: str, state: TrainState, epoch: int,
           metrics: Optional[dict], opt: dict) -> None:
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"step": state.step, "epoch": epoch, "seed": state.seed,
                "params": _cpu(state.model.state_dict()),
                "opt": opt,
                "scaler": {"mean": state.scaler.mean.cpu(),
                           "scale": state.scaler.scale.cpu()}},
               os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "run_metrics.json"), "w") as f:
        json.dump({"epoch": epoch, **{k: float(v) for k, v in
                                      (metrics or {}).items()}}, f)
    old = f"{path}.old-{os.getpid()}"
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def restore_checkpoint(path: str, state: TrainState) -> tuple:
    """Load `path` into `state` (its model and optimizer, on their device).
    Returns (state, epoch)."""
    device = next(state.model.parameters()).device
    ck = torch.load(os.path.join(path, "state.pt"), map_location=device,
                    weights_only=True)
    state.model.load_state_dict(ck["params"])
    state.opt.load_state_dict(ck["opt"])
    state.scaler = ScalerState(ck["scaler"]["mean"], ck["scaler"]["scale"])
    state.step = int(ck["step"])
    state.seed = int(ck["seed"])
    return state, int(ck["epoch"])


def checkpoint_epoch(dirname: str) -> Optional[int]:
    """`checkpoint_{epoch}` -> epoch; None for anything else (temporary
    directories of an unfinished write included)."""
    if not dirname.startswith("checkpoint_"):
        return None
    try:
        return int(dirname.split("_", 1)[1])
    except ValueError:
        return None


def latest_checkpoint(run_dir: str) -> Optional[str]:
    if not os.path.isdir(run_dir):
        return None
    cands = [d for d in os.listdir(run_dir) if checkpoint_epoch(d) is not None]
    if not cands:
        return None
    return os.path.join(run_dir, max(cands, key=checkpoint_epoch))


def load_run_checkpoint(run_dir: str, checkpoint: str = "best") -> tuple:
    """(params state_dict, ScalerState) of `checkpoint` under `run_dir`:
    'best', 'latest' (the newest `checkpoint_{epoch}`) or a checkpoint
    directory's name. Exits with JAX's message where there is none."""
    if checkpoint == "latest":
        ckpt = latest_checkpoint(run_dir)
    else:
        ckpt = os.path.join(run_dir, checkpoint)
    if ckpt is None or not os.path.isfile(os.path.join(ckpt, "state.pt")):
        raise SystemExit(f"no checkpoint {checkpoint!r} under {run_dir}")
    ck = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu",
                    weights_only=True)
    return ck["params"], ScalerState(ck["scaler"]["mean"],
                                     ck["scaler"]["scale"])
