"""The geopose objective's serving half (the port of
`geovpr.objectives.workloads.GeoposeObjective`: decode and metrics; the
training losses come with the training slice)."""

from __future__ import annotations

import dataclasses

from geovpr_torch.objectives.losses import geopose_metrics
from geovpr_torch.objectives.scaler import ScalerState


@dataclasses.dataclass(frozen=True)
class GeoposeObjective:
    """(lat, lon) regression with the StandardScaler target codec."""

    def decode_predictions(self, preds, scaler: ScalerState):
        return scaler.inverse_transform(preds)

    def metrics(self, decoded, raw_targets, mask=None):
        return geopose_metrics(decoded, raw_targets, mask)
