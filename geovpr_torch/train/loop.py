"""The host-side training loop (the port of `geovpr.train.loop.Trainer`):
epochs, shuffling, the plateau LR rule, early stopping, best-model
tracking, checkpoints and their pruning, `metrics.jsonl`, resume, the
freeze -> unfreeze phases, the frozen-feature cache, and a
`torch.profiler` trace of a few steps.

Each step is `train.steps.make_train_step`'s: on the card, per block, K9a
and K9c / K9b for window-12 Swin, K8a and K8c / K8b for DINOv2, torch ops
for window-7 Swin (JAX's XLA route), cuDNN and cuBLAS under autograd for
the CNNs (EfficientNet-B0's BatchNorms on the batch's statistics, moving
their running ones). Validation runs the serving forward (K4 or K7, and
K6, for Swin, K1 for DINOv2) in eval mode, BatchNorm on its running
statistics, under `torch.inference_mode()` on the same f32 parameters,
cast per call, and reduces the eval sums of `serve.eval` into the metric
suite.

Phases (`geovpr/train/loop.py:85-101`): with `freeze_backbone_epochs` the
first epochs train the head alone (the optimizer's backbone scale 0: its
gradient zeroed before the clip, no moments); at the first epoch past
them, or on a resume that starts past them, a fresh optimizer takes over
with `unfreeze_lr`, the preset's backbone scale, new moments, count 0 and
the whole run's schedule horizon. The frozen-feature cache
(`geovpr/train/loop.py:339-397`): where the model's backbone is frozen
(`ModelConfig.freeze_backbone`), nothing is augmented and nothing keeps
batch statistics, `pooled_features` runs once per run over each source,
and the epochs train and validate the head alone on those features.

With a `mesh` (`geovpr/train/loop.py:40`, `:249`, `:373`, `:449`, `:475`)
the Trainer runs on every rank: each batch is padded to the data shards
and each rank takes its rows (`prefetch_to_device(mesh=...)`), the step is
data parallel (`train.steps`), a `model` axis splits the optimizer state
(`parallel.sharding_rules.shard_state`), the eval sums are all-reduced and
the predictions gathered, and the frozen-feature cache is extracted over
the sharded source and gathered. Plateau and early stop read the reduced
numbers, so every rank decides alike; rank 0 writes `metrics.jsonl`, the
checkpoints and the profile, and every rank restores.

With `async_checkpoint` (`geovpr/train/loop.py:310-334`) each checkpoint
is copied to the host at the save and written on a background thread
while the next epoch trains; pruning runs once the new checkpoint is in
place, and `fit` waits for every write before it returns.
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
from geovpr_torch.data.pipeline import (ArraySource, iterate_batches,
                                        prefetch_to_device)
from geovpr_torch.data.transforms import build_augment, normalize
from geovpr_torch.models.layers import batch_stat_buffers
from geovpr_torch.objectives.scaler import ScalerState
from geovpr_torch.parallel.mesh import (barrier, broadcast_object,
                                        gather_rows, is_writer)
from geovpr_torch.parallel.sharding_rules import shard_state
from geovpr_torch.serve.eval import (add_sums, eval_sums, reduce_sums,
                                     summarize_eval)
from geovpr_torch.train.checkpoint import (checkpoint_epoch,
                                           latest_checkpoint,
                                           restore_checkpoint,
                                           save_checkpoint, wait_for_saves)
from geovpr_torch.train.state import (TrainState, build_optimizer,
                                      create_train_state)
from geovpr_torch.train.steps import make_eval_step, make_train_step


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
    mesh: Any = None

    state: Optional[TrainState] = None
    run_dir: str = ""
    history: list = dataclasses.field(default_factory=list)
    # epoch -> the reported loss of each of its steps
    step_losses: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.run_dir:
            stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
            name = self.train_cfg.run_name or "run"
            self.run_dir = broadcast_object(
                os.path.join(self.train_cfg.save_dir,
                             f"training_{name}_{stamp}"), self.mesh)
        if is_writer(self.mesh):
            os.makedirs(self.run_dir, exist_ok=True)
        barrier(self.mesh)
        self.device = torch.device(self.device)
        mean, std = self.data_cfg.mean, self.data_cfg.std
        self._normalize = lambda x: normalize(x, mean, std)
        aug = (build_augment(self.data_cfg.augment)
               if self.data_cfg.augment != "none" else None)
        self._train_step = make_train_step(
            self.objective, normalize_fn=self._normalize, augment_fn=aug,
            skip_nonfinite=self.train_cfg.skip_nonfinite_updates,
            mesh=self.mesh)
        # the head-only warmup phase (`dino_v2_gemini.py:187-222`)
        self._frozen_phase = self.optim_cfg.freeze_backbone_epochs > 0
        self._total_steps = 0
        self._steps_per_epoch = 0

    def _phase_optim_cfg(self) -> OptimConfig:
        if self._frozen_phase:
            return dataclasses.replace(self.optim_cfg, backbone_lr_scale=0.0)
        return self.optim_cfg

    def _unfreeze(self) -> None:
        """Phase 2: a fresh optimizer over the whole model (new moments,
        count 0, lr_scale 1), `unfreeze_lr` where it is set, on the whole
        run's schedule horizon."""
        self._frozen_phase = False
        cfg = self.optim_cfg
        if cfg.unfreeze_lr > 0:
            cfg = dataclasses.replace(cfg, lr=cfg.unfreeze_lr)
        self.state.opt = build_optimizer(self.state.model, cfg,
                                         self._total_steps,
                                         self._steps_per_epoch)
        self._shard_state()

    def _shard_state(self) -> None:
        """Split the optimizer state over a `model` axis."""
        if self.mesh is not None and "model" in self.mesh.shape:
            shard_state(self.mesh, self.state)

    def init_state(self, total_steps: int = 0,
                   steps_per_epoch: int = 0) -> TrainState:
        self._total_steps = total_steps
        self._steps_per_epoch = steps_per_epoch
        self.model.to(self.device)
        self.state = create_train_state(
            self.model, self._phase_optim_cfg(), self.train_cfg.seed,
            scaler=self.scaler, out_dim=self.objective.out_dim,
            pretrained=self.pretrained, total_steps=total_steps,
            steps_per_epoch=steps_per_epoch)
        self._shard_state()
        return self.state

    def restore_latest(self, run_dir: str, require: bool = False) -> int:
        """Restore the newest `checkpoint_{epoch}` under `run_dir` and
        return the epoch to continue at; 0 when there is none, unless
        `require` (then FileNotFoundError). `init_state` comes first, with
        the original run's schedule horizon. A checkpoint written after the
        unfreeze holds moments for the backbone too, so the frozen phase's
        optimizer refuses it (ValueError): the unfrozen optimizer is built
        and the restore tried once more, a second failure raising
        RuntimeError from the first. A parameter of the wrong name or shape
        raises at once."""
        if self.state is None:
            raise RuntimeError("call init_state() before restore_latest()")
        ckpt = latest_checkpoint(run_dir)
        if ckpt is None:
            if require:
                raise FileNotFoundError(f"no checkpoint under {run_dir}")
            return 0
        try:
            self.state, epoch = restore_checkpoint(ckpt, self.state)
        except ValueError as e:
            if not self._frozen_phase:
                raise
            self._unfreeze()
            try:
                self.state, epoch = restore_checkpoint(ckpt, self.state)
            except Exception:
                raise RuntimeError(
                    f"could not restore {ckpt} with either the frozen-phase "
                    f"or the unfrozen optimizer") from e
        return epoch + 1

    @property
    def has_batch_stats(self) -> bool:
        """Whether the model keeps batch statistics (EfficientNet's
        BatchNorms), as JAX's `Trainer.has_batch_stats`."""
        return bool(batch_stat_buffers(self.model))

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
        freeze_epochs = self.optim_cfg.freeze_backbone_epochs
        if self._frozen_phase and start_epoch >= freeze_epochs:
            self._unfreeze()
        train_step, cached_eval = self._train_step, None
        cached = self._maybe_cache_frozen_features(train_source, val_source)
        if cached is not None:
            train_source, val_source, train_step, cached_eval = cached
        best, best_epoch, bad_epochs, plateau_bad = (
            self._resume_counters(start_epoch) if start_epoch > 0
            else (float("inf"), -1, 0, 0))

        for epoch in range(start_epoch, epochs):
            if self._frozen_phase and epoch >= freeze_epochs:
                self._unfreeze()
            t0 = time.time()
            losses, skips = [], []
            batches = iterate_batches(
                train_source, bs, shuffle=True, seed=cfg.seed, epoch=epoch,
                drop_remainder=self.data_cfg.drop_remainder_train)
            prof = None
            for i, batch in enumerate(prefetch_to_device(
                    batches, self.device, self.data_cfg.prefetch_depth,
                    self.mesh)):
                if (cfg.profile and epoch == start_epoch and i == 1
                        and is_writer(self.mesh)):
                    prof = self._start_profile()
                m = train_step(self.state, batch)
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
                val = (self.evaluate(val_source) if cached_eval is None
                       else self.evaluate(val_source, _step=cached_eval))
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
                                    self.state, epoch, val, self.mesh,
                                    async_save=cfg.async_checkpoint)
                else:
                    bad_epochs += 1

            every = cfg.checkpoint_every
            if every and (epoch + 1) % every == 0:
                save_checkpoint(
                    os.path.join(self.run_dir, f"checkpoint_{epoch}"),
                    self.state, epoch,
                    metrics={"bad_epochs": bad_epochs,
                             "plateau_bad": plateau_bad,
                             "best": best, "best_epoch": best_epoch},
                    mesh=self.mesh, async_save=cfg.async_checkpoint,
                    on_saved=self._prune_checkpoints)

            self.history.append(record)
            if is_writer(self.mesh):
                with open(os.path.join(self.run_dir, "metrics.jsonl"),
                          "a") as f:
                    f.write(json.dumps(record) + "\n")
            if (cfg.early_stop_patience
                    and bad_epochs >= cfg.early_stop_patience):
                break
        wait_for_saves()
        barrier(self.mesh)
        self.history_summary = {"best": best, "best_epoch": best_epoch}
        return self.history

    def _maybe_cache_frozen_features(self, train_source, val_source):
        """(train source, val source, train step, eval forward) over the
        cached `pooled_features`, or None where the cache does not apply:
        it needs `cache_frozen_features`, a frozen backbone
        (`ModelConfig.freeze_backbone`), no augmentation (the features
        must not change between epochs) and no batch statistics
        (`geovpr/train/loop.py:357`: a frozen BatchNorm in training mode
        would still normalize each batch by its own statistics and move
        them). The features are the serving forward's, the one the
        uncached step runs under no grad, so the trajectory is
        unchanged."""
        model_cfg = getattr(self.model, "config", None)
        if not (self.train_cfg.cache_frozen_features
                and model_cfg is not None and model_cfg.freeze_backbone
                and self.data_cfg.augment == "none"
                and not self.has_batch_stats):
            return None
        model = self.state.model

        def cache(source):
            model.eval()
            feats = targets = None
            with torch.inference_mode():
                for batch in prefetch_to_device(
                        iterate_batches(source, self.data_cfg.batch_size),
                        self.device, self.data_cfg.prefetch_depth,
                        self.mesh):
                    idx = batch["_indices"]
                    f = self._global(model.pooled_features(
                        self._normalize(batch["image"])).float()).cpu()
                    t = self._global(batch["target"].float()).cpu()
                    if feats is None:
                        feats = np.zeros((len(source), f.shape[-1]),
                                         np.float32)
                        targets = np.zeros((len(source),) + tuple(
                            t.shape[1:]), np.float32)
                    feats[idx] = f[:len(idx)].numpy()
                    targets[idx] = t[:len(idx)].numpy()
            return ArraySource(images=feats, targets=targets)

        step = make_train_step(
            self.objective, normalize_fn=None,
            skip_nonfinite=self.train_cfg.skip_nonfinite_updates,
            apply_fn=model.head_only, mesh=self.mesh)
        return (cache(train_source),
                cache(val_source) if val_source is not None else None,
                step, make_eval_step(model, None, model.head_only))

    def _global(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of a per-rank output (gathered over `data`)."""
        return t if self.mesh is None else gather_rows(t, self.mesh)

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

    def evaluate(self, source, _step=None) -> dict:
        """The metric suite over `source` with the serving forward, or with
        the eval step `_step` (the frozen-feature cache evaluates the head
        on cached features)."""
        metrics, _ = self.evaluate_and_predict(source, _step)
        return metrics

    def evaluate_and_predict(self, source, _step=None) -> tuple:
        if len(source) == 0:
            raise ValueError("evaluate() on an empty source — check the val "
                             "CSV / --image-root")
        model = self.state.model
        model.eval()
        forward = _step or make_eval_step(model, self._normalize)
        sums, out = None, None
        with torch.inference_mode():
            for batch in prefetch_to_device(
                    iterate_batches(source, self.data_cfg.batch_size),
                    self.device, self.data_cfg.prefetch_depth, self.mesh):
                idx = batch["_indices"]
                preds = forward(batch["image"])
                decoded = self.objective.decode_predictions(
                    preds, self.state.scaler)
                sums = add_sums(sums, eval_sums(decoded, batch["target"],
                                                batch["mask"]))
                decoded = self._global(decoded)
                if out is None:
                    out = np.zeros((len(source),) + tuple(decoded.shape[1:]),
                                   np.float32)
                out[idx] = decoded[:len(idx)].cpu().numpy()
        return summarize_eval(reduce_sums(sums, self.mesh)), out


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
