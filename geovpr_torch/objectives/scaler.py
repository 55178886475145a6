"""StandardScaler target codec (the port of `geovpr.objectives.scaler`).

The fit statistics are two small f32 tensors stored beside the model's
weights; `inverse_transform` maps the head's outputs back to (lat, lon)
on the device. sklearn semantics: biased std (ddof=0), zero variance
scales by 1.0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ScalerState(NamedTuple):
    mean: torch.Tensor   # (D,) f32
    scale: torch.Tensor  # (D,) f32, std with ddof=0, zeros replaced by 1.0

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.scale

    def inverse_transform(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.mean

    def to(self, device) -> "ScalerState":
        return ScalerState(self.mean.to(device), self.scale.to(device))


def scaler_from_arrays(mean, scale) -> ScalerState:
    """A ScalerState from array-likes (the `scaler` entry of a variables
    file), held as f32 tensors."""
    return ScalerState(torch.from_numpy(np.asarray(mean, np.float32).copy()),
                       torch.from_numpy(np.asarray(scale, np.float32).copy()))


def fit_scaler(x) -> ScalerState:
    """Fit on (N, D) f32 training targets: mean and std with ddof 0, a zero
    std replaced by 1.0 (`geovpr/objectives/scaler.py:33-41`). The sums run
    in f64 and the statistics are returned in f32, so a constant column
    gives exactly 0 and then 1.0, as sklearn's does."""
    x = np.asarray(x, np.float32).astype(np.float64)
    mean, std = x.mean(axis=0), x.std(axis=0)
    return scaler_from_arrays(mean, np.where(std == 0.0, 1.0, std))


def identity_scaler(dim: int) -> ScalerState:
    """No-op codec (mean 0, scale 1)."""
    return ScalerState(torch.zeros(dim), torch.ones(dim))
