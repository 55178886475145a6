"""Workload objectives (the port of `geovpr.objectives.workloads`):
target encoding, training loss, flip remapping of targets, decoding,
metrics and the monitored metric.

| Objective            | Reference recipe                                      |
|----------------------|-------------------------------------------------------|
| GeoposeObjective     | scaled lat/lon (swin_finetuning.py:89,                |
|                      | swin_attempt_2.py:158)                                |
| AngleDirectObjective | raw degrees, wrapped % 360                            |
|                      | (efficientnet_finetuning.py:66-68,110)                |
| AngleSinCosObjective | encoded pair (en_finetuning_gemini.py:158,            |
|                      | swin_angle_finetuning_sin_cos.py:65-69)               |
"""

from __future__ import annotations

import dataclasses

import torch

from geovpr_torch.objectives.angle_codec import SinCosCodec, wrap_degrees
from geovpr_torch.objectives.losses import (acos_angular_loss_deg,
                                            angular_error_deg,
                                            geopose_metrics, huber_loss,
                                            maae_deg, mse_loss)
from geovpr_torch.objectives.scaler import ScalerState


def _flip_heading(targets, flip):
    """A horizontal flip mirrors a heading: theta -> (180 - theta) mod 360,
    with the same flip decision that transformed the image."""
    flip = flip.reshape(flip.shape + (1,) * (targets.dim() - flip.dim()))
    return torch.where(flip, torch.remainder(180.0 - targets, 360.0),
                       targets)


@dataclasses.dataclass(frozen=True)
class GeoposeObjective:
    """(lat, lon) regression with the StandardScaler target codec; Huber
    (delta `huber_delta`) or MSE on the scaled targets."""

    loss_name: str = "huber"
    huber_delta: float = 1.0
    out_dim: int = 2

    def encode_targets(self, latlon, scaler: ScalerState):
        return scaler.transform(latlon)

    def loss(self, preds, enc_targets, mask=None):
        if self.loss_name == "huber":
            return huber_loss(preds, enc_targets, self.huber_delta, mask)
        if self.loss_name == "mse":
            return mse_loss(preds, enc_targets, mask)
        raise ValueError(self.loss_name)

    def remap_flip(self, targets, flip):
        return targets   # a flip does not move the camera

    def decode_predictions(self, preds, scaler: ScalerState):
        return scaler.inverse_transform(preds)

    def metrics(self, decoded, raw_targets, mask=None):
        return geopose_metrics(decoded, raw_targets, mask)

    monitor = "mse"


@dataclasses.dataclass(frozen=True)
class AngleDirectObjective:
    """Direct scalar-degree regression, the circular MAAE as the loss;
    predictions wrapped % 360."""

    out_dim: int = 1

    def encode_targets(self, angle_deg, scaler=None):
        return angle_deg.reshape(-1, 1)

    def loss(self, preds, enc_targets, mask=None):
        return maae_deg(wrap_degrees(preds[:, 0]), enc_targets[:, 0], mask)

    def remap_flip(self, targets, flip):
        return _flip_heading(targets, flip)

    def decode_predictions(self, preds, scaler=None):
        return wrap_degrees(preds[:, 0])

    def metrics(self, decoded, raw_targets, mask=None):
        return {"maae": maae_deg(decoded, raw_targets, mask)}

    monitor = "maae"


@dataclasses.dataclass(frozen=True)
class AngleSinCosObjective:
    """sin/cos-encoded angle regression, decoded by the codec's order; MSE
    on the encoded pair, or ("acos") the geodesic loss of the unit-
    normalised prediction."""

    loss_name: str = "mse"
    codec: SinCosCodec = SinCosCodec("cos_sin")
    out_dim: int = 2

    def encode_targets(self, angle_deg, scaler=None):
        return self.codec.encode(angle_deg)

    def loss(self, preds, enc_targets, mask=None):
        if self.loss_name == "mse":
            return mse_loss(preds, enc_targets, mask)
        if self.loss_name == "acos":
            return acos_angular_loss_deg(self.codec.normalize(preds),
                                         enc_targets, mask)
        raise ValueError(self.loss_name)

    def remap_flip(self, targets, flip):
        return _flip_heading(targets, flip)

    def decode_predictions(self, preds, scaler=None):
        return self.codec.decode(preds)

    def metrics(self, decoded, raw_targets, mask=None):
        return {"maae": maae_deg(decoded, raw_targets, mask)}

    monitor = "maae"


def per_sample_errors(objective, decoded, raw_targets):
    """Per-image error column of the CSV exports: |error| per axis for
    geopose (validation_swin_2.py:205-218), the circular error for angles
    (validation_script.py:212-221)."""
    if isinstance(objective, GeoposeObjective):
        return (decoded - raw_targets).abs()
    return angular_error_deg(decoded, raw_targets)
