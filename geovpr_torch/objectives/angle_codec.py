"""Angle <-> sin/cos codec (the port's copy of
`geovpr.objectives.angle_codec`).

The reference has two column orders, each consistent in itself:

- the EfficientNet family stores targets as ``[cos, sin]`` and decodes with
  ``atan2(x[:,1], x[:,0])`` (en_finetuning_gemini.py:60,221);
- the Swin/DINOv2 sin/cos family stores ``[sin, cos]`` and decodes
  ``atan2(x[:,0], x[:,1])`` (swin_angle_finetuning_sin_cos.py:47,73;
  dino_v2_gemini.py:138).

The order is a named property of the codec, so that a checkpoint is never
decoded with the other convention.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def wrap_degrees(deg: torch.Tensor) -> torch.Tensor:
    """Wrap any angle to [0, 360) (floored modulo, as `jnp.mod`). The train
    manifest holds angles up to 750 deg; scripts that train directly on
    degrees wrap predictions `% 360` (efficientnet_finetuning.py:110)."""
    return torch.remainder(deg, 360.0)


@dataclasses.dataclass(frozen=True)
class SinCosCodec:
    """Degrees to a 2-vector on the unit circle and back. order "cos_sin":
    columns [cos t, sin t]; "sin_cos": [sin t, cos t]."""

    order: str = "cos_sin"

    def __post_init__(self):
        if self.order not in ("cos_sin", "sin_cos"):
            raise ValueError(f"unknown codec order {self.order!r}")

    def encode(self, deg: torch.Tensor) -> torch.Tensor:
        rad = deg * (math.pi / 180.0)
        s, c = torch.sin(rad), torch.cos(rad)
        pair = (c, s) if self.order == "cos_sin" else (s, c)
        return torch.stack(pair, dim=-1)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """2-vector -> degrees in [0, 360), as
        `(rad2deg(atan2(sin, cos)) + 360) % 360` (en_finetuning_gemini.py:
        221-223)."""
        if self.order == "cos_sin":
            c, s = x[..., 0], x[..., 1]
        else:
            s, c = x[..., 0], x[..., 1]
        deg = torch.rad2deg(torch.atan2(s, c))
        return torch.remainder(deg + 360.0, 360.0)

    def normalize(self, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        """Project raw head output onto the unit circle
        (swin_angle_finetuning_sin_cos.py:62)."""
        return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)

    def flip_horizontal(self, deg: torch.Tensor) -> torch.Tensor:
        """Heading under a horizontal image flip: t -> (180 - t) mod 360
        (swin_angle_finetuning_gemini.py:59-76)."""
        return torch.remainder(180.0 - deg, 360.0)
