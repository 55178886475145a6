"""The training state (the port of `geovpr.train.state`): the step, the
model (its parameters, and the BatchNorm running statistics as its
buffers: JAX's `batch_stats`), the optimizer state, the target scaler and
the seed that every step's random draws derive from."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from geovpr_torch.core.config import OptimConfig
from geovpr_torch.models.layers import init_weights_
from geovpr_torch.objectives.scaler import ScalerState, identity_scaler
from geovpr_torch.train.optimizer import Optimizer, decay_mask, param_labels


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt: Optimizer
    scaler: ScalerState
    seed: int

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())


def build_optimizer(model: nn.Module, cfg: OptimConfig, total_steps: int = 0,
                    steps_per_epoch: int = 0) -> Optimizer:
    return Optimizer(cfg, dict(model.named_parameters()), param_labels(model),
                     decay_mask(model), total_steps, steps_per_epoch)


def create_train_state(model: nn.Module, optim_cfg: OptimConfig, seed: int,
                       scaler: Optional[ScalerState] = None, out_dim: int = 2,
                       pretrained: Optional[dict] = None,
                       total_steps: int = 0,
                       steps_per_epoch: int = 0) -> TrainState:
    """A seeded random init of `model` (on its device; BatchNorm running
    statistics reset to mean 0, variance 1), with `pretrained` (a
    state_dict, e.g. the backbone's from `convert_jax`, running statistics
    included where the flax tree has `batch_stats`) laid over it, as
    `geovpr/train/state.py:56-58` lays params and batch_stats, the
    optimizer at step 0 and the scaler (identity when None)."""
    device = next(model.parameters()).device
    init_weights_(model, torch.Generator().manual_seed(seed))
    if pretrained:
        model.load_state_dict(_merge_pretrained(model.state_dict(),
                                                pretrained))
    scaler = scaler if scaler is not None else identity_scaler(out_dim)
    return TrainState(step=0, model=model,
                      opt=build_optimizer(model, optim_cfg, total_steps,
                                          steps_per_epoch),
                      scaler=scaler.to(device), seed=seed)


def _merge_pretrained(init: dict, pretrained: dict) -> dict:
    """Lay the pretrained tensors over the init state_dict (backbone
    pretrained, head fresh), under the bridge's names for every backbone
    (`backbone.blocks.N.attn.qkv_weight`, `backbone.cls_token`,
    `backbone.pos_embed` for DINOv2; `backbone.stage{s}_block{b}.*` for
    Swin, EfficientNet and ConvNeXt, BatchNorm `running_mean` /
    `running_var` buffers included). Every pretrained key must exist in
    the model with the same shape (`geovpr/train/state.py:82-106`): an
    unknown key would leave the real parameter at its random init."""
    out = dict(init)
    for k, v in pretrained.items():
        if k not in out:
            raise ValueError(
                f"pretrained key {k!r} not in the model's parameters "
                f"(converted with the wrong converter or for a different "
                f"family/variant?)")
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"pretrained shape mismatch at {k!r}: "
                             f"{tuple(v.shape)} vs {tuple(out[k].shape)}")
        out[k] = v
    return out
