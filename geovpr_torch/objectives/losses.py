"""Losses and metrics (the port of `geovpr.objectives.losses`): masked
means over the valid rows of a batch.

- MSE, RMSE, MAE and per-axis MAE (`swin_attempt_2.py:216-220`,
  `validation_swin_2.py:191-195`);
- the "competition loss" 0.5 * (sum(dlat^2) + sum(dlon^2)) / N
  (`swin_validation.py:100`);
- the circular angle error and its mean, MAAE
  (`efficientnet_finetuning.py:66-68`).

Training losses: MSE (`swin_finetuning.py:89`), Huber with torch
`HuberLoss` semantics (`swin_attempt_2.py:158`), MAAE as a loss
(`efficientnet_finetuning.py:66-68`) and the acos angle loss in degrees
(`swin_angle_finetuning_sin_cos.py:65-69`).

`mask` is an optional (B,) bool tensor; padded rows never contribute.

Under `global_batch(mesh)` (the data-parallel training step) a rank holds
its rows of the batch, and a masked mean is over the GLOBAL batch, as JAX's
over a data-sharded array: this rank's masked sum over the valid count
all-reduced over `data` (the count carries no gradient). The ranks' losses
then sum to the global loss and their gradients to its gradient. At one
data shard the arithmetic is the local mean's, op for op.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

_GLOBAL_BATCH = contextvars.ContextVar("geovpr_torch_global_batch",
                                       default=None)


@contextlib.contextmanager
def global_batch(mesh):
    """Masked means inside the block are over `mesh`'s global batch (None:
    the local one)."""
    token = _GLOBAL_BATCH.set(mesh)
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    mesh = _GLOBAL_BATCH.get()
    if mask is None and mesh is None:
        return x.mean()
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).to(x.dtype)
    per_row = x.numel() // mask.numel()
    count = m.sum() * per_row
    if mesh is not None:
        from geovpr_torch.parallel.mesh import all_reduce_
        count = all_reduce_(count.detach().clone(), mesh)
    denom = torch.clamp(count, min=1.0)
    return (x * m).sum() / denom


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean((pred - target) ** 2, mask)


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0.5 d^2 where |d| < delta, else delta (|d| - 0.5 delta), masked mean
    over the valid elements."""
    d = torch.abs(pred - target)
    return _masked_mean(torch.where(d < delta, 0.5 * d * d,
                                    delta * (d - 0.5 * delta)), mask)


def acos_angular_loss_deg(pred_unit: torch.Tensor, target_unit: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          eps: float = 1e-7) -> torch.Tensor:
    """Mean geodesic angle in degrees between unit sin/cos vectors:
    acos of their dot product clamped to [-1 + eps, 1 - eps]."""
    dot = torch.clamp(torch.sum(pred_unit * target_unit, dim=-1),
                      -1.0 + eps, 1.0 - eps)
    return _masked_mean(torch.rad2deg(torch.arccos(dot)), mask)


def competition_loss(pred_latlon: torch.Tensor, true_latlon: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0.5 * (sum(dlat^2) + sum(dlon^2)) / N, the mean over lat and lon of
    the per-axis MSE."""
    sq = (pred_latlon - true_latlon) ** 2
    if mask is not None:
        m = mask.to(sq.dtype)[:, None]
        n = torch.clamp(m.sum(), min=1.0)
        return 0.5 * (sq * m).sum() / n
    return 0.5 * sq.sum() / sq.shape[0]


def geopose_metrics(pred_latlon: torch.Tensor, true_latlon: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> dict:
    """MSE, RMSE, MAE, per-axis MAE and the competition loss, on the
    original target scale."""
    err = pred_latlon - true_latlon
    mse = mse_loss(pred_latlon, true_latlon, mask)
    return {
        "mse": mse,
        "rmse": torch.sqrt(mse),
        "mae": _masked_mean(err.abs(), mask),
        "mae_lat": _masked_mean(err[:, 0:1].abs(), mask),
        "mae_lon": _masked_mean(err[:, 1:2].abs(), mask),
        "competition_loss": competition_loss(pred_latlon, true_latlon, mask),
    }


def angular_error_deg(pred_deg: torch.Tensor,
                      true_deg: torch.Tensor) -> torch.Tensor:
    """Per-sample circular error in degrees: min(|d| mod 360,
    360 - |d| mod 360)."""
    d = torch.remainder(torch.abs(pred_deg - true_deg), 360.0)
    return torch.minimum(d, 360.0 - d)


def maae_deg(pred_deg: torch.Tensor, true_deg: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute angular error in degrees
    (efficientnet_finetuning.py:66-68)."""
    return _masked_mean(angular_error_deg(pred_deg, true_deg), mask)
