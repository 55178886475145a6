"""The optimizer of every training recipe (the port of
`geovpr.train.optimizer`), written out in torch from the optax chain the
JAX package builds (`geovpr/train/optimizer.py:76-151`):

    [set_to_zero on a frozen backbone] -> [clip_by_global_norm]
    -> per label {backbone, head}: scale_by_adam (b1 0.9, b2 0.999,
       eps 1e-8, bias correction) -> decoupled weight decay (optionally
       masked off biases and norms) -> * -schedule(step) * factor
    -> * lr_scale

`factor` is 1 for the head and `backbone_lr_scale` for the backbone; a
backbone scale of 0 freezes it (its update is zero, it keeps no moments).
The schedule is constant ("constant" and "plateau"), cosine decay, or
cosine with warm restarts whose period counts epochs. "plateau" is the
host-mutable `lr_scale`, set by the training loop's plateau rule (not
torch's `ReduceLROnPlateau`, whose counter and threshold differ; Queue 3).

Tensor parallel (`shard`, from `parallel.sharding_rules.shard_state`): a
split parameter keeps only this rank's part of its moments, its update is
computed on that part of the (whole, all-reduced) gradient and parameter,
and the parts are then all-gathered over the `model` line into the whole
parameter: element for element the unsplit update. `state_dict` gathers
the moments whole (every rank of the line calls it); `load_state_dict`
takes whole moments and keeps this rank's part.

Updates run in f32 on the parameters in place. `update` takes a device
flag `ok`: where it is false (a non-finite loss or gradient) the
parameters and moments keep their values, with no host sync, while the
integer count still advances, as JAX's `jnp.where` restores only floating
leaves (`geovpr/train/steps.py:95-99`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from geovpr_torch.core.config import OptimConfig

B1, B2, EPS = 0.9, 0.999, 1e-8
_NO_DECAY_LEAVES = ("bias", "gamma", "cls_token", "pos_embed",
                    "relative_position_bias_table", "dustbin")


def param_labels(model: nn.Module) -> dict:
    """name -> "backbone" | "head" (the first scope of the name)."""
    return {n: "backbone" if n.split(".")[0] == "backbone" else "head"
            for n, _ in model.named_parameters()}


def decay_mask(model: nn.Module) -> dict:
    """name -> whether weight decay applies: not on biases, norm scales
    (LayerNorm / BatchNorm weights, flax "scale"), LayerScale gammas,
    tokens, position embeddings, the relative-position tables and SALAD's
    dustbin (`geovpr/train/optimizer.py:32-46`)."""
    norm_weights = {f"{m_name}.weight" if m_name else "weight"
                    for m_name, m in model.named_modules()
                    if type(m).__name__ in ("LayerNorm", "BatchNorm")}
    out = {}
    for n, _ in model.named_parameters():
        leaf = n.rsplit(".", 1)[-1]
        out[n] = not (leaf in _NO_DECAY_LEAVES or leaf.endswith("_bias")
                      or n in norm_weights)
    return out


def make_schedule(cfg: OptimConfig, base_lr: float, total_steps: int,
                  steps_per_epoch: int = 0):
    """step -> learning rate, as the JAX package's optax schedules."""
    if cfg.schedule in ("constant", "plateau"):
        return lambda step: base_lr

    def cosine(count, steps):
        count = min(count, steps)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * count / steps))

    if cfg.schedule == "cosine":
        steps = cfg.cosine_steps or max(total_steps, 1)
        return lambda step: cosine(step, steps)
    if cfg.schedule == "cosine_restarts":
        period = max(cfg.restart_period, 1) * max(steps_per_epoch, 1)
        n = max(-(-total_steps // period), 1)
        bounds = [period * (i + 1) for i in range(n - 1)]

        def restarts(step):
            start = max([b for b in bounds if b <= step], default=0)
            return cosine(step - start, period)
        return restarts
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


class Optimizer:
    """AdamW with the JAX package's chain over a dict of named parameters.
    State: `mu`, `nu` (f32, per trainable parameter), the integer `count`
    and the float `lr_scale`."""

    def __init__(self, cfg: OptimConfig, params: dict, labels: dict,
                 decay: Optional[dict] = None, total_steps: int = 0,
                 steps_per_epoch: int = 0):
        if cfg.optimizer not in ("adamw", "adam"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.frozen = cfg.backbone_lr_scale == 0.0
        self.factor = {"head": 1.0, "backbone": (
            0.0 if self.frozen else cfg.backbone_lr_scale)}
        self.labels = labels
        use_mask = cfg.optimizer == "adamw" and cfg.no_decay_on_bias_norm
        self.wd = {n: (cfg.weight_decay if cfg.optimizer == "adamw" else 0.0)
                   * (1.0 if not use_mask or decay[n] else 0.0)
                   for n in params}
        self.schedule = make_schedule(cfg, cfg.lr, total_steps,
                                      steps_per_epoch)
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items() if self.trains(n)}
        self.nu = {n: torch.zeros_like(t) for n, t in self.mu.items()}
        self.count = 0
        self.lr_scale = 1.0
        self.shards: dict = {}
        self._model_group = None

    def trains(self, name: str) -> bool:
        return self.factor[self.labels[name]] != 0.0

    def shard(self, shards: dict, model_group) -> None:
        """Keep this rank's part (`parallel.sharding_rules.Shard`) of the
        moments of each parameter in `shards` and update only that part,
        gathering the parts over `model_group` after each update."""
        self.shards = {n: sh for n, sh in shards.items() if n in self.mu}
        self._model_group = model_group
        for n, sh in self.shards.items():
            self.mu[n] = sh.take(self.mu[n])
            self.nu[n] = sh.take(self.nu[n])

    @torch.no_grad()
    def update(self, params: dict, grads: dict,
               ok: Optional[torch.Tensor] = None) -> None:
        """One step on `params` (name -> tensor, updated in place) from
        `grads` (name -> tensor). With `ok` (a 0-d bool tensor) false, the
        parameters and moments keep their values."""
        cfg = self.cfg
        g = {n: grads[n].float() for n in params}
        if self.frozen:
            g = {n: (t if self.trains(n) else torch.zeros_like(t))
                 for n, t in g.items()}
        if cfg.grad_clip_norm > 0:
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g.values()))
            clip = norm >= cfg.grad_clip_norm
            g = {n: torch.where(clip, t / norm * cfg.grad_clip_norm, t)
                 for n, t in g.items()}
        step = self.count
        self.count += 1
        bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** self.count
        bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** self.count
        lr = self.schedule(step)
        for n, p_whole in params.items():
            if not self.trains(n):
                continue
            sh = self.shards.get(n)
            gn = g[n] if sh is None else sh.take(g[n])
            p = p_whole if sh is None else sh.take(p_whole)
            mu = (1.0 - B1) * gn + B1 * self.mu[n]
            nu = (1.0 - B2) * gn * gn + B2 * self.nu[n]
            u = (mu / bc1.item()) / (torch.sqrt(nu / bc2.item()) + EPS)
            if self.wd[n]:
                u = u + self.wd[n] * p.float()
            step_size = torch.tensor(-lr * self.factor[self.labels[n]],
                                     dtype=torch.float32)
            u = u * step_size.item() * self.lr_scale
            new = (p.float() + u).to(p.dtype)
            if ok is None:
                p.copy_(new)
                self.mu[n].copy_(mu)
                self.nu[n].copy_(nu)
            else:
                p.copy_(torch.where(ok, new, p))
                self.mu[n].copy_(torch.where(ok, mu, self.mu[n]))
                self.nu[n].copy_(torch.where(ok, nu, self.nu[n]))
            if sh is not None:
                sh.gather_(p_whole, p, self._model_group)

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        sh = self.shards.get(name)
        if sh is None:
            return t
        shape = list(t.shape)
        shape[sh.dim] *= sh.parts
        whole = t.new_empty(shape)
        sh.gather_(whole, t, self._model_group)
        return whole

    def state_dict(self) -> dict:
        """The moments whole (gathered over the `model` line where they
        are split), the count and lr_scale."""
        return {"mu": {n: self._whole(n, t) for n, t in self.mu.items()},
                "nu": {n: self._whole(n, t) for n, t in self.nu.items()},
                "count": self.count, "lr_scale": self.lr_scale}

    def load_state_dict(self, state: dict) -> None:
        for key in ("mu", "nu"):
            mine = getattr(self, key)
            if set(state[key]) != set(mine):
                raise ValueError(f"optimizer state {key}: parameters differ "
                                 f"({sorted(set(state[key]) ^ set(mine))})")
            for n, t in state[key].items():
                sh = self.shards.get(n)
                mine[n].copy_(t if sh is None else sh.take(t))
        self.count = int(state["count"])
        self.lr_scale = float(state["lr_scale"])
