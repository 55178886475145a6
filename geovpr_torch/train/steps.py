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

`apply_fn` replaces the model's forward (`geovpr/train/steps.py:31-42`):
the frozen-feature cache trains `RegressionModel.head_only` on cached
features, with no normalisation and no augmentation. `make_eval_step` is
the validation forward, the serving model's or, likewise, the head's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from geovpr_torch.data.transforms import normalize
from geovpr_torch.models.layers import batch_stat_buffers, set_rng
from geovpr_torch.train.state import TrainState


def step_generators(seed: int, step: int, device) -> tuple:
    """The (augment, dropout) generators of one step."""
    gens = []
    for k in (0, 1):
        g = torch.Generator(device=device)
        g.manual_seed((seed * 1_000_003 + step) * 2 + k)
        gens.append(g)
    return tuple(gens)


def make_train_step(objective, normalize_fn: Optional[Callable] = normalize,
                    augment_fn: Optional[Callable] = None,
                    skip_nonfinite: bool = True,
                    apply_fn: Optional[Callable] = None) -> Callable:
    """train_step(state, batch) -> {"loss", "skipped"} (0-d device
    tensors); `batch` holds "image" (B, H, W, 3) uint8 or float (or, with
    `apply_fn`, whatever it takes), "target" (B, T) raw targets and "mask"
    (B,) bool, on the model's device."""

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        model.train()
        dev = batch["image"].device
        aug_gen, drop_gen = step_generators(state.seed, state.step, dev)
        images, targets = batch["image"], batch["target"]
        if augment_fn is not None:
            x01 = images.float() / 255.0 if images.dtype == torch.uint8 \
                else images
            x01, flipped = augment_fn(aug_gen, x01)
            images = torch.clamp(x01, 0.0, 1.0)
            targets = objective.remap_flip(targets, flipped)
        enc = objective.encode_targets(targets, state.scaler)
        stats = batch_stat_buffers(model) if skip_nonfinite else []
        old_stats = [b.clone() for b in stats]
        set_rng(model, drop_gen)
        try:
            preds = (apply_fn or model)(
                images if normalize_fn is None else normalize_fn(images))
        finally:
            set_rng(model, None)
        loss = objective.loss(preds, enc, batch.get("mask"))
        params = state.params
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        ok = None
        if skip_nonfinite:
            ok = torch.stack([torch.isfinite(loss)] + [
                torch.isfinite(g).all() for g in grads.values()]).all()
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
