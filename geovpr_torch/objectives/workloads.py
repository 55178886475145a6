"""The objectives' serving half (the port of
`geovpr.objectives.workloads`: decode, metrics and the monitored metric;
the training losses come with the training slice).

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

from geovpr_torch.objectives.angle_codec import SinCosCodec, wrap_degrees
from geovpr_torch.objectives.losses import (angular_error_deg,
                                            geopose_metrics, maae_deg)
from geovpr_torch.objectives.scaler import ScalerState


@dataclasses.dataclass(frozen=True)
class GeoposeObjective:
    """(lat, lon) regression with the StandardScaler target codec."""

    def decode_predictions(self, preds, scaler: ScalerState):
        return scaler.inverse_transform(preds)

    def metrics(self, decoded, raw_targets, mask=None):
        return geopose_metrics(decoded, raw_targets, mask)


@dataclasses.dataclass(frozen=True)
class AngleDirectObjective:
    """Direct scalar-degree regression; predictions wrapped % 360."""

    def decode_predictions(self, preds, scaler=None):
        return wrap_degrees(preds[:, 0])

    def metrics(self, decoded, raw_targets, mask=None):
        return {"maae": maae_deg(decoded, raw_targets, mask)}

    monitor = "maae"


@dataclasses.dataclass(frozen=True)
class AngleSinCosObjective:
    """sin/cos-encoded angle regression, decoded by the codec's order."""

    codec: SinCosCodec = SinCosCodec("cos_sin")

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
