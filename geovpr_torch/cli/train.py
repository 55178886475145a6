"""Training entry point of the port (the counterpart of `geovpr.cli.train`,
flag for flag).

    python -m geovpr_torch.cli.train --preset swin_b384_gemini2 \
        --train-csv labels_train.csv --val-csv labels_val.csv \
        --image-root images --save-dir runs \
        [--epochs N] [--batch-size B] [--seed S] \
        [--pretrained backbone.msgpack] [--resume DIR | --auto-resume DIR] \
        [--profile] [--async-checkpoint] [--device cuda|cpu] \
        [--multihost [--coordinator HOST:PORT --num-processes N \
                      --process-id R]]

Trains the presets whose every kernel and module is ported:
- Swin at window 12 (`swin_b384_gemini2`, `swin_b384_v4_diff_lr`,
  `swin_b384_direct_maae`): each attention half through K9a forward and
  K9c (or K9b, at C = 1024) backward a step, validation through K4 and K6;
- Swin at window 7 (`swin_t224_v1`, `swin_t224_v2`,
  `swin_t224_sincos_acos`, `swin_t224_sincos_gemini`): each attention
  half as torch ops under autograd, as JAX trains window 7 on XLA,
  validation through K7 and K6;
- DINOv2 (`dinov2_meanpool_huber`, `dinov2_cls_direct_maae`,
  `dinov2_sincos_gemini` with `angle_rot` and its freeze -> unfreeze
  phases, any variant): each attention half through K8a forward and K8c
  backward a step in either phase (K8b and torch products where D fails
  JAX's size gate `bwd_all_ok`, as at large-14, D = 1024), validation
  through K1;
- DINOv2 + SALAD with its backbone frozen (`dinov2salad_frozen_mlp`): the
  descriptors extracted once through K1 (the frozen-feature cache), then
  the head alone a step; with `model.freeze_backbone` unset (no preset
  asks for it) the backbone trains through K8a and K8c and the SALAD head,
  Sinkhorn included, under autograd;
- EfficientNet-B0 (`efficientnet_direct_maae`, `efficientnet_sincos_gemini`)
  and ConvNeXt-B (`convnext_direct_maae`): cuDNN convolutions and cuBLAS
  products under autograd, as JAX trains them on XLA, no kernel of the
  port a step. EfficientNet's BatchNorms normalize with the batch's
  statistics (every row, a padded tail row included) and move their
  running ones as flax does (momentum 0.9, the biased variance); a
  NaN-skipped step keeps the old ones, checkpoints carry them, and
  validation and `cli.evaluate --run-dir` / `cli.fuse --angle-run` read
  them. ConvNeXt's validation runs its bf16 serving forward (K3 only in
  the w8a8 scoring of `cli.evaluate --int8`).
`model.remat` recomputes each transformer block in the backward (the CNN
families ignore it, as in JAX); `data.cache_decoded` ("ram" or a path
prefix: `{prefix}.train.npy` and `{prefix}.val.npy` memmaps) caches the
decoded images of each source (`CachedImageSource`); `data.decoder =
"native"` decodes with the port's libjpeg decoder, built at first use
(`geovpr_torch.data.decoder`; it raises where it cannot be built).
Checkpoints are the port's own (`train.checkpoint`), in the JAX CLI's
run-directory layout; `--async-checkpoint` writes them on a background
thread. `--pretrained` reads a flax msgpack of backbone variables (as
`python -m geovpr_torch.cli.convert` writes it from a torch, HF or hub
checkpoint). `--device` defaults to cuda and fails when no card is
present; pass `--device cpu` to run on the CPU.

`--multihost` runs one process per card, data parallel
(`geovpr_torch.parallel`): each process initializes the process group
from `--coordinator`, `--num-processes` and `--process-id` (or from
torchrun's environment: `torchrun --nproc-per-node N -m
geovpr_torch.cli.train --multihost ...`), trains on `cuda:{local rank}`
(or the CPU over gloo with `--device cpu`) with its rows of every batch,
the gradients all-reduced, and rank 0 writes the run directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from geovpr_torch.cli.common import (add_distributed_args, start_mesh,
                                     stop_mesh)
from geovpr_torch.parallel.mesh import is_writer


def load_pretrained_backbone(path: str) -> dict:
    """A flax msgpack of backbone variables -> the training model's
    state_dict entries under `backbone.`."""
    from geovpr_torch.models.convert_jax import (load_flax_msgpack,
                                                 state_dict_from_flax)
    sd = state_dict_from_flax(load_flax_msgpack(path))
    return {f"backbone.{k}": v for k, v in sd.items()}


def run_train(cfg, train_source, val_source=None, *, save_dir: str = "runs",
              device="cuda", epochs: int = 0, batch_size: int = 0,
              seed: int = -1, pretrained: dict | None = None,
              resume: str = "", auto_resume: str = "",
              profile: bool = False, async_checkpoint: bool = False,
              mesh=None):
    """Train preset `cfg` on in-memory or disk sources (targets as
    `targets`): the scaler fitted on the train targets (geopose), a
    seeded random init with `pretrained` laid over it, or the latest
    checkpoint of `resume` / `auto_resume`, data parallel over `mesh`
    where one is given (every rank calls this), checkpoints written on a
    background thread with `async_checkpoint`, the decoded images of a
    decoding source cached as `data.cache_decoded` asks (`cached_source`,
    as JAX's CLI wraps its sources, `geovpr/cli/train.py:118-124`).
    Returns the Trainer (its `history`, `step_losses`, `run_dir`,
    `state`)."""
    from geovpr_torch.cli.presets import objective_for
    from geovpr_torch.core.config import GeoposeConfig
    from geovpr_torch.data.pipeline import cached_source
    from geovpr_torch.models.regression import RegressionModel
    from geovpr_torch.objectives.scaler import fit_scaler
    from geovpr_torch.train.loop import Trainer

    data = dataclasses.replace(
        cfg.data, **({"batch_size": batch_size} if batch_size else {}))
    rank = "" if mesh is None else f".rank{mesh.rank}"
    train_source = cached_source(train_source, data.cache_decoded,
                                 f"train{rank}")
    val_source = cached_source(val_source, data.cache_decoded, f"val{rank}")
    train_cfg = dataclasses.replace(
        cfg.train, save_dir=save_dir, profile=profile,
        async_checkpoint=async_checkpoint or cfg.train.async_checkpoint,
        **({"epochs": epochs} if epochs else {}),
        **({"seed": seed} if seed >= 0 else {}))
    geo = isinstance(cfg, GeoposeConfig)
    scaler = (fit_scaler(np.asarray(train_source.targets, np.float32))
              if geo and cfg.scale_targets else None)
    mcfg = dataclasses.replace(cfg.model, image_size=data.image_size)
    model = RegressionModel(mcfg, dtype=getattr(torch, mcfg.compute_dtype),
                            train=True)
    trainer = Trainer(model=model, objective=objective_for(cfg),
                      optim_cfg=cfg.optim, train_cfg=train_cfg,
                      data_cfg=data, device=device, scaler=scaler,
                      pretrained=pretrained, mesh=mesh,
                      run_dir=resume or auto_resume or "")
    start_epoch = 0
    resume_dir = resume or auto_resume
    if resume_dir:
        spe = Trainer.steps_per_epoch(len(train_source), data)
        trainer.init_state(total_steps=spe * train_cfg.epochs,
                           steps_per_epoch=spe)
        start_epoch = trainer.restore_latest(resume_dir,
                                             require=bool(resume))
        if is_writer(mesh):
            print(f"resumed {resume_dir}; continuing at epoch "
                  f"{start_epoch}" if start_epoch else
                  f"no checkpoint under {resume_dir}; starting fresh there",
                  file=sys.stderr)
    trainer.fit(train_source, val_source, start_epoch=start_epoch)
    return trainer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", required=True)
    p.add_argument("--train-csv", required=True)
    p.add_argument("--val-csv", default="")
    p.add_argument("--image-root", required=True)
    p.add_argument("--save-dir", default="runs")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--pretrained", default="",
                   help="flax msgpack of BACKBONE variables to initialise "
                        "from (the head stays fresh), as python -m "
                        "geovpr_torch.cli.convert writes it")
    p.add_argument("--resume", default="",
                   help="run dir to resume from (errors if it holds no "
                        "checkpoint)")
    p.add_argument("--auto-resume", default="",
                   help="run dir: resume from its latest checkpoint if one "
                        "exists, else start a fresh run in it")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of a few steps into "
                        "<run_dir>/profile")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write checkpoints on a background thread while "
                        "training goes on")
    add_distributed_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (default) fails without a card")
    args = p.parse_args(argv)
    if args.resume and args.auto_resume:
        p.error("--resume and --auto-resume are mutually exclusive")
    mesh, device = start_mesh(args, args.device)
    _train(args, mesh, device)
    stop_mesh(mesh)


def _train(args, mesh, device) -> None:
    from geovpr_torch.cli.presets import build_preset
    from geovpr_torch.core.config import GeoposeConfig
    from geovpr_torch.data.manifest import load_manifest
    from geovpr_torch.data.pipeline import ImageFolderSource

    cfg = build_preset(args.preset)
    data = cfg.data
    geo = isinstance(cfg, GeoposeConfig)

    def make_source(manifest, resize_to=0):
        return ImageFolderSource(
            paths=manifest.paths(),
            targets=np.asarray(manifest.latlon if geo else manifest.angle),
            image_size=data.image_size, num_threads=data.num_decode_threads,
            filenames=manifest.filenames, decoder=data.decoder,
            resize_to=resize_to)

    train_manifest = load_manifest(args.train_csv, args.image_root,
                                   data.screen_missing_files,
                                   data.screen_corrupt_images)
    val_source = (make_source(load_manifest(args.val_csv, args.image_root),
                              data.eval_resize_to) if args.val_csv else None)
    trainer = run_train(
        cfg, make_source(train_manifest), val_source, save_dir=args.save_dir,
        device=device, epochs=args.epochs, batch_size=args.batch_size,
        seed=args.seed, profile=args.profile,
        async_checkpoint=args.async_checkpoint,
        pretrained=(load_pretrained_backbone(args.pretrained)
                    if args.pretrained else None),
        resume=args.resume, auto_resume=args.auto_resume, mesh=mesh)
    if is_writer(mesh):
        print(json.dumps({"run_dir": trainer.run_dir,
                          "final": trainer.history[-1] if trainer.history
                          else {}}))


if __name__ == "__main__":
    main()
