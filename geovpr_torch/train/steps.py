"""The training step (the port of `geovpr.train.steps.make_train_step`).

Order, as JAX: augment on [0, 1] pixels -> clip -> normalise -> forward ->
loss on the encoded targets over the valid rows -> backward -> update.
The augmentation and the dropout / DropPath draws come from two
generators seeded from (seed, step), so a resumed run draws what an
unbroken one would. NaN-skip as JAX does it: an all-finite flag over the
loss and every gradient, computed on the device with no host sync; where
it is false the optimizer keeps the parameters and moments, its integer
count (and the step) still advance, and the reported loss is 0.

Batch statistics (EfficientNet's BatchNorms, `geovpr/train/steps.py:72-77`):
the forward in training mode moves the running statistics in place. The
NaN skip restores them too, as JAX's `jnp.where` covers every float leaf,
`batch_stats` included (`:91-99`): they are copied before the forward and
put back with `torch.where(ok, new, old)` on the device.

Data parallel (`mesh`, `geovpr/train/steps.py:8-9`: JAX's batch arrives
sharded over `data` and XLA inserts the gradient psum): a rank holds its
rows of the global batch. The loss is the masked mean over the global
batch (`objectives.losses.global_batch`: each rank's masked sum over the
all-reduced valid count) and the reported loss its all-reduced sum;
BatchNorm takes global statistics (`layers.set_batch_mesh`); the random
draws cover the global batch's shape and each rank keeps its rows
(`rows`), so a step at any world size draws what one process would. The
gradients are all-reduced (SUM) over `data` in a few flat f32 buckets,
the all-finite flag by MIN, so every rank skips a NaN step together; the
global-norm clip then reads the same reduced gradient on every rank. At
one data shard every value is the single-process step's, bit for bit.
Under a `model` axis the optimizer updates this rank's slice and gathers
it (`parallel.sharding_rules.shard_state`).

`apply_fn` replaces the model's forward (`geovpr/train/steps.py:31-42`):
the frozen-feature cache trains `RegressionModel.head_only` on cached
features, with no normalisation and no augmentation. `make_eval_step` is
the validation forward, the serving model's or, likewise, the head's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from geovpr_torch.data.transforms import normalize
from geovpr_torch.models.layers import (batch_stat_buffers, set_batch_mesh,
                                        set_rng)
from geovpr_torch.objectives.losses import global_batch
from geovpr_torch.parallel.mesh import all_reduce_
from geovpr_torch.train.state import TrainState

# f32 elements a gradient bucket holds (128 MB)
BUCKET_ELEMENTS = 1 << 25


def step_generators(seed: int, step: int, device) -> tuple:
    """The (augment, dropout) generators of one step."""
    gens = []
    for k in (0, 1):
        g = torch.Generator(device=device)
        g.manual_seed((seed * 1_000_003 + step) * 2 + k)
        gens.append(g)
    return tuple(gens)


def all_reduce_grads_(grads: list, mesh) -> None:
    """Sum every gradient over `data` in place: flattened into buckets of
    up to BUCKET_ELEMENTS f32 values, one all-reduce a bucket."""
    bucket, size = [], 0
    for g in grads + [None]:
        if g is not None and size + g.numel() <= BUCKET_ELEMENTS:
            bucket.append(g)
            size += g.numel()
            continue
        if bucket:
            flat = all_reduce_(torch.cat([t.reshape(-1) for t in bucket]),
                               mesh)
            for t, part in zip(bucket, flat.split([t.numel()
                                                   for t in bucket])):
                t.copy_(part.view_as(t))
        bucket, size = ([g], g.numel()) if g is not None else ([], 0)


def make_train_step(objective, normalize_fn: Optional[Callable] = normalize,
                    augment_fn: Optional[Callable] = None,
                    skip_nonfinite: bool = True,
                    apply_fn: Optional[Callable] = None,
                    mesh=None) -> Callable:
    """train_step(state, batch) -> {"loss", "skipped"} (0-d device
    tensors); `batch` holds "image" (B, H, W, 3) uint8 or float (or, with
    `apply_fn`, whatever it takes), "target" (B, T) raw targets and "mask"
    (B,) bool, on the model's device: with a `mesh`, this rank's rows of
    the global batch."""

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        model.train()
        dev = batch["image"].device
        aug_gen, drop_gen = step_generators(state.seed, state.step, dev)
        images, targets = batch["image"], batch["target"]
        rows = None
        if mesh is not None:
            b = images.shape[0]
            rows = (mesh.index("data") * b, mesh.axis_size("data") * b)
        if augment_fn is not None:
            x01 = images.float() / 255.0 if images.dtype == torch.uint8 \
                else images
            x01, flipped = (augment_fn(aug_gen, x01) if rows is None
                            else augment_fn(aug_gen, x01, rows))
            images = torch.clamp(x01, 0.0, 1.0)
            targets = objective.remap_flip(targets, flipped)
        enc = objective.encode_targets(targets, state.scaler)
        stats = batch_stat_buffers(model) if skip_nonfinite else []
        old_stats = [b.clone() for b in stats]
        set_rng(model, drop_gen, rows)
        set_batch_mesh(model, mesh)
        try:
            preds = (apply_fn or model)(
                images if normalize_fn is None else normalize_fn(images))
            with global_batch(mesh):
                loss = objective.loss(preds, enc, batch.get("mask"))
            params = state.params
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        finally:
            set_rng(model, None)
            set_batch_mesh(model, None)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        ok = None
        if skip_nonfinite:
            ok = torch.stack([torch.isfinite(loss)] + [
                torch.isfinite(g).all() for g in grads.values()]).all()
        if mesh is not None:
            if ok is not None:
                ok = all_reduce_(ok.float(), mesh,
                                 op=torch.distributed.ReduceOp.MIN) > 0.5
            all_reduce_grads_([g for n, g in grads.items()
                               if state.opt.trains(n)], mesh)
            loss = all_reduce_(loss.detach().clone(), mesh)
        state.opt.update(params, grads, ok)
        with torch.no_grad():
            for new, old in zip(stats, old_stats):
                new.copy_(torch.where(ok, new, old))
        state.step += 1
        loss = loss.detach()
        if ok is None:
            return {"loss": loss, "skipped": torch.zeros_like(loss)}
        return {"loss": torch.where(ok, loss, torch.zeros_like(loss)),
                "skipped": (~ok).float()}

    return train_step


def make_eval_step(model, normalize_fn: Optional[Callable] = normalize,
                   apply_fn: Optional[Callable] = None) -> Callable:
    """eval_step(images) -> predictions: `apply_fn` (default the model) on
    the normalised images, or on the batch as it is where `normalize_fn`
    is None. The caller puts the model in eval mode under
    `torch.inference_mode()`."""
    fwd = apply_fn or model
    if normalize_fn is None:
        return fwd
    return lambda images: fwd(normalize_fn(images))
