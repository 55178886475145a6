"""The host-side training loop (the port of `geovpr.train.loop.Trainer`):
epochs, shuffling, the plateau LR rule, early stopping, best-model
tracking, checkpoints and their pruning, `metrics.jsonl`, resume, and a
`torch.profiler` trace of a few steps.

Each step is `train.steps.make_train_step`'s: on the card, per block, K9a
and K9c / K9b for Swin, K8a and K8c / K8b for DINOv2. Validation runs the
serving forward (K4 and K6 for Swin, K1 for DINOv2) under
`torch.inference_mode()` on the same f32 parameters, cast per call, and
reduces the eval sums of `serve.eval` into the metric suite. Not ported:
the frozen-feature cache and the freeze -> unfreeze phases (ROADMAP Queue
1, the rest of DINOv2 training), asynchronous checkpoints and `remat` (its
leftovers), meshes (parallel).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from geovpr_torch.core.config import DataConfig, OptimConfig, TrainConfig
from geovpr_torch.data.pipeline import iterate_batches, prefetch_to_device
from geovpr_torch.data.transforms import build_augment, normalize
from geovpr_torch.objectives.scaler import ScalerState
from geovpr_torch.serve.eval import add_sums, eval_sums, summarize_eval
from geovpr_torch.train.checkpoint import (checkpoint_epoch,
                                           latest_checkpoint,
                                           restore_checkpoint,
                                           save_checkpoint)
from geovpr_torch.train.state import TrainState, create_train_state
from geovpr_torch.train.steps import make_train_step


@dataclasses.dataclass
class Trainer:
    model: Any
    objective: Any
    optim_cfg: OptimConfig
    train_cfg: TrainConfig
    data_cfg: DataConfig
    device: Any = "cuda"
    scaler: Optional[ScalerState] = None
    pretrained: Optional[dict] = None

    state: Optional[TrainState] = None
    run_dir: str = ""
    history: list = dataclasses.field(default_factory=list)
    # epoch -> the reported loss of each of its steps
    step_losses: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.optim_cfg.freeze_backbone_epochs > 0:
            raise NotImplementedError(
                "freeze -> unfreeze training is not ported yet (ROADMAP "
                "Queue 1, the rest of DINOv2 training)")
        if self.train_cfg.async_checkpoint:
            raise NotImplementedError(
                "asynchronous checkpoints are not ported (ROADMAP Queue 1, "
                "leftovers: asynchronous checkpoints); checkpoints are "
                "written synchronously")
        if not self.run_dir:
            stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
            name = self.train_cfg.run_name or "run"
            self.run_dir = os.path.join(self.train_cfg.save_dir,
                                        f"training_{name}_{stamp}")
        os.makedirs(self.run_dir, exist_ok=True)
        self.device = torch.device(self.device)
        mean, std = self.data_cfg.mean, self.data_cfg.std
        self._normalize = lambda x: normalize(x, mean, std)
        aug = (build_augment(self.data_cfg.augment)
               if self.data_cfg.augment != "none" else None)
        self._train_step = make_train_step(
            self.objective, normalize_fn=self._normalize, augment_fn=aug,
            skip_nonfinite=self.train_cfg.skip_nonfinite_updates)

    def init_state(self, total_steps: int = 0,
                   steps_per_epoch: int = 0) -> TrainState:
        self.model.to(self.device)
        self.state = create_train_state(
            self.model, self.optim_cfg, self.train_cfg.seed,
            scaler=self.scaler, out_dim=self.objective.out_dim,
            pretrained=self.pretrained, total_steps=total_steps,
            steps_per_epoch=steps_per_epoch)
        return self.state

    def restore_latest(self, run_dir: str, require: bool = False) -> int:
        """Restore the newest `checkpoint_{epoch}` under `run_dir` and
        return the epoch to continue at; 0 when there is none, unless
        `require` (then FileNotFoundError). `init_state` comes first, with
        the original run's schedule horizon."""
        if self.state is None:
            raise RuntimeError("call init_state() before restore_latest()")
        ckpt = latest_checkpoint(run_dir)
        if ckpt is None:
            if require:
                raise FileNotFoundError(f"no checkpoint under {run_dir}")
            return 0
        self.state, epoch = restore_checkpoint(ckpt, self.state)
        return epoch + 1

    @staticmethod
    def steps_per_epoch(n: int, data_cfg: DataConfig) -> int:
        bs = data_cfg.batch_size
        return max(n // bs if data_cfg.drop_remainder_train else -(-n // bs),
                   1)

    def _resume_counters(self, start_epoch: int) -> tuple:
        best, best_epoch, bad_epochs, plateau_bad = float("inf"), -1, 0, 0
        meta = os.path.join(self.run_dir, "best", "run_metrics.json")
        if os.path.exists(meta):
            with open(meta) as f:
                prior = json.load(f)
            best = float(prior.get(self.objective.monitor, best))
            best_epoch = int(prior.get("epoch", -1))
        side = os.path.join(self.run_dir, f"checkpoint_{start_epoch - 1}",
                            "run_metrics.json")
        if os.path.exists(side):
            with open(side) as f:
                c = json.load(f)
            bad_epochs = int(c.get("bad_epochs", bad_epochs))
            plateau_bad = int(c.get("plateau_bad", plateau_bad))
            best = float(c.get("best", best))
            best_epoch = int(c.get("best_epoch", best_epoch))
        return best, best_epoch, bad_epochs, plateau_bad

    def fit(self, train_source, val_source=None, epochs: Optional[int] = None,
            start_epoch: int = 0) -> list:
        """Train for epochs [start_epoch, epochs); a resumed run continues
        the checkpoint numbering, shuffles, best metric and the
        early-stop / plateau counters (from the sidecar of the checkpoint
        it resumed at)."""
        cfg = self.train_cfg
        epochs = epochs or cfg.epochs
        bs = self.data_cfg.batch_size
        n = len(train_source)
        if self.data_cfg.drop_remainder_train and n < bs:
            raise ValueError(
                f"dataset ({n} rows) smaller than batch_size ({bs}) with "
                f"drop_remainder_train=True: every epoch would train zero "
                f"steps. Lower the batch size or disable drop_remainder.")
        spe = self.steps_per_epoch(n, self.data_cfg)
        if self.state is None:
            self.init_state(total_steps=spe * epochs, steps_per_epoch=spe)
        best, best_epoch, bad_epochs, plateau_bad = (
            self._resume_counters(start_epoch) if start_epoch > 0
            else (float("inf"), -1, 0, 0))

        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            losses, skips = [], []
            batches = iterate_batches(
                train_source, bs, shuffle=True, seed=cfg.seed, epoch=epoch,
                drop_remainder=self.data_cfg.drop_remainder_train)
            prof = None
            for i, batch in enumerate(prefetch_to_device(
                    batches, self.device, self.data_cfg.prefetch_depth)):
                if cfg.profile and epoch == start_epoch and i == 1:
                    prof = self._start_profile()
                m = self._train_step(self.state, batch)
                losses.append(m["loss"])
                skips.append(m["skipped"])
                if prof is not None and i >= cfg.profile_steps:
                    self._stop_profile(prof)
                    prof = None
            if prof is not None:
                self._stop_profile(prof)
            losses = torch.stack(losses).cpu().numpy()
            skips = torch.stack(skips).cpu().numpy()
            self.step_losses[epoch] = losses.tolist()
            applied = skips < 0.5
            record = {"epoch": epoch,
                      "train_loss": float(losses[applied].mean())
                      if applied.any() else float("nan"),
                      "skipped_updates": int(skips.sum()),
                      "lr_scale": self.state.opt.lr_scale,
                      "seconds": round(time.time() - t0, 2)}

            if val_source is not None:
                val = self.evaluate(val_source)
                record.update({f"val_{k}": v for k, v in val.items()})
                monitored = val[self.objective.monitor]
                if self.optim_cfg.schedule == "plateau":
                    plateau_bad, scale = plateau_rule(
                        monitored, best, plateau_bad,
                        self.optim_cfg.plateau_patience,
                        self.optim_cfg.plateau_factor,
                        self.state.opt.lr_scale)
                    self.state.opt.lr_scale = scale
                    record["lr_scale"] = scale
                if monitored < best:
                    best, best_epoch, bad_epochs = monitored, epoch, 0
                    save_checkpoint(os.path.join(self.run_dir, "best"),
                                    self.state, epoch, val)
                else:
                    bad_epochs += 1

            every = cfg.checkpoint_every
            if every and (epoch + 1) % every == 0:
                save_checkpoint(
                    os.path.join(self.run_dir, f"checkpoint_{epoch}"),
                    self.state, epoch,
                    metrics={"bad_epochs": bad_epochs,
                             "plateau_bad": plateau_bad,
                             "best": best, "best_epoch": best_epoch})
                self._prune_checkpoints()

            self.history.append(record)
            with open(os.path.join(self.run_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
            if (cfg.early_stop_patience
                    and bad_epochs >= cfg.early_stop_patience):
                break
        self.history_summary = {"best": best, "best_epoch": best_epoch}
        return self.history

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = os.path.join(self.run_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))

    def _prune_checkpoints(self) -> None:
        keep = self.train_cfg.keep_checkpoints
        if not keep:
            return
        cands = sorted((d for d in os.listdir(self.run_dir)
                        if checkpoint_epoch(d) is not None),
                       key=checkpoint_epoch)
        for d in cands[:-keep]:
            shutil.rmtree(os.path.join(self.run_dir, d), ignore_errors=True)

    def evaluate(self, source) -> dict:
        """The metric suite over `source` with the serving forward."""
        metrics, _ = self.evaluate_and_predict(source)
        return metrics

    def evaluate_and_predict(self, source) -> tuple:
        if len(source) == 0:
            raise ValueError("evaluate() on an empty source — check the val "
                             "CSV / --image-root")
        model = self.state.model
        model.eval()
        sums, out = None, None
        with torch.inference_mode():
            for batch in prefetch_to_device(
                    iterate_batches(source, self.data_cfg.batch_size),
                    self.device, self.data_cfg.prefetch_depth):
                idx = batch["_indices"]
                preds = model(self._normalize(batch["image"]))
                decoded = self.objective.decode_predictions(
                    preds, self.state.scaler)
                sums = add_sums(sums, eval_sums(decoded, batch["target"],
                                                batch["mask"]))
                if out is None:
                    out = np.zeros((len(source),) + tuple(decoded.shape[1:]),
                                   np.float32)
                out[idx] = decoded[:len(idx)].cpu().numpy()
        return summarize_eval(sums), out


def plateau_rule(monitored: float, best: float, bad: int, patience: int,
                 factor: float, scale: float) -> tuple:
    """The plateau LR rule of `geovpr/train/loop.py:289-301`: an epoch that
    improves on the best by more than 1e-12 resets the counter; one that
    does not counts, and past `patience` such epochs the scale is
    multiplied by `factor` and the counter resets. Returns (bad, scale)."""
    if monitored < best - 1e-12:
        return 0, scale
    bad += 1
    if bad > patience:
        return 0, scale * factor
    return bad, scale
