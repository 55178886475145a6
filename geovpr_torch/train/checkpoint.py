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
- `latest_checkpoint` finds the newest `checkpoint_{epoch}` (a directory
  still being written has its temporary name, so it is never found);
- asynchronous saves (`async_save`, `geovpr/train/checkpoint.py:44-96`):
  the state is copied to the host at once (a copy of every tensor, so that
  the in-place optimizer steps that follow cannot reach what is written)
  and written on one background thread while training goes on; a new save
  first waits for the one in flight, and `wait_for_saves` waits for the
  last (and raises what a write raised);
- `load_run_checkpoint` reads the parameters (with the running
  statistics) and the scaler of a run
  directory's `best`, `latest` or named checkpoint, as
  `geovpr.cli.common.load_trained` resolves them, for
  `geovpr_torch.cli.evaluate --run-dir`.

Under a mesh (`geovpr/train/checkpoint.py:99-132`) whole tensors go on
disk: every rank calls `save_checkpoint`, the tensor-parallel moments are
gathered whole, rank 0 writes (or, asynchronously, hands the write to its
thread) and the others wait at a barrier. Every rank
restores, and the optimizer keeps its part of each split moment, so a run
saved on one mesh resumes on another (`(4,)` on `(2, 2)` or on one
process), as JAX restores into the template's shardings.

Reading the JAX package's orbax run directories is not ported (ROADMAP).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
from typing import Callable, Optional

import torch

from geovpr_torch.objectives.scaler import ScalerState
from geovpr_torch.parallel.mesh import barrier, is_writer
from geovpr_torch.train.state import TrainState


def _cpu(tree, copy: bool = False):
    """The tensors of `tree` on the host; `copy` copies a host tensor too
    (a CUDA tensor's `.cpu()` is a copy already)."""
    if isinstance(tree, dict):
        return {k: _cpu(v, copy) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=copy)
    return tree


_WRITER: Optional[concurrent.futures.ThreadPoolExecutor] = None
_IN_FLIGHT: Optional[concurrent.futures.Future] = None


def wait_for_saves() -> None:
    """Block until the asynchronous write in flight, if any, has landed;
    re-raise what it raised."""
    global _IN_FLIGHT
    pending, _IN_FLIGHT = _IN_FLIGHT, None
    if pending is not None:
        pending.result()


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    metrics: Optional[dict] = None, mesh=None,
                    async_save: bool = False,
                    on_saved: Optional[Callable[[], None]] = None) -> None:
    """Write `state` atomically to the directory `path` (with a mesh: on
    every rank, rank 0 writing). With `async_save` the host copy is taken
    here and the write runs on the background thread. `on_saved` runs
    once the directory is in place (on that thread for an asynchronous
    save), where rank 0 writes."""
    global _IN_FLIGHT, _WRITER
    opt = _cpu(state.opt.state_dict(), async_save)   # gathers split moments
    if is_writer(mesh):
        payload = {"step": state.step, "epoch": epoch, "seed": state.seed,
                   "params": _cpu(state.model.state_dict(), async_save),
                   "opt": opt,
                   "scaler": {"mean": _cpu(state.scaler.mean, async_save),
                              "scale": _cpu(state.scaler.scale, async_save)}}
        if async_save:
            wait_for_saves()
            if _WRITER is None:
                _WRITER = concurrent.futures.ThreadPoolExecutor(
                    1, thread_name_prefix="checkpoint")
            _IN_FLIGHT = _WRITER.submit(_write, path, payload, epoch,
                                        metrics, on_saved)
        else:
            _write(path, payload, epoch, metrics, on_saved)
    barrier(mesh)


def _write(path: str, payload: dict, epoch: int, metrics: Optional[dict],
           on_saved: Optional[Callable[[], None]]) -> None:
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "run_metrics.json"), "w") as f:
        json.dump({"epoch": epoch, **{k: float(v) for k, v in
                                      (metrics or {}).items()}}, f)
    old = f"{path}.old-{os.getpid()}"
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    if on_saved is not None:
        on_saved()


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
