"""Regression heads (the port of `geovpr.heads.regression`).

- `LinearHead`: Linear(D -> out)
- `MlpHead`: (Linear -> ReLU -> Dropout) x num_hidden_layers -> Linear
- `SinCosHead`: Dropout -> [Linear -> ReLU -> Dropout] -> Linear(-> 2),
  optionally unit-normalised

Submodule names follow the flax tree (`hidden0`, `out`), so the weight
bridge maps `head/hidden0/kernel` to `head.hidden0.weight`. Heads hold f32
weights, compute in f32 and emit f32 whatever the backbone's dtype.
In training mode the dropouts have flax's semantics and draw from the
generator `geovpr_torch.models.layers.set_rng` gives them.
"""

from __future__ import annotations

import torch
from torch import nn

from geovpr_torch.models.layers import Dropout, normalize_l2


class LinearHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int = 2, device=None):
        super().__init__()
        self.out = nn.Linear(in_dim, out_dim, device=device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.out(features.float())


class MlpHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int = 2, hidden: int = 512,
                 dropout: float = 0.3, num_hidden_layers: int = 1,
                 device=None):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        dims = [in_dim] + [hidden] * num_hidden_layers
        for i in range(num_hidden_layers):
            self.add_module(f"hidden{i}", nn.Linear(dims[i], hidden,
                                                    device=device))
        self.drop = Dropout(dropout)
        self.out = nn.Linear(dims[-1], out_dim, device=device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features.float()
        for i in range(self.num_hidden_layers):
            x = self.drop(torch.relu(getattr(self, f"hidden{i}")(x)))
        return self.out(x)


class SinCosHead(nn.Module):
    def __init__(self, in_dim: int, dropout: float = 0.3,
                 unit_normalize: bool = False, hidden: int = 0, device=None):
        super().__init__()
        self.unit_normalize = unit_normalize
        self.drop = Dropout(dropout)
        self.hidden0 = (nn.Linear(in_dim, hidden, device=device) if hidden
                        else None)
        self.out = nn.Linear(hidden or in_dim, 2, device=device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = self.drop(features.float())
        if self.hidden0 is not None:
            x = self.drop(torch.relu(self.hidden0(x)))
        x = self.out(x)
        return normalize_l2(x) if self.unit_normalize else x


def build_head(head: str, in_dim: int, out_dim: int, hidden: int = 512,
               dropout: float = 0.3, device=None) -> nn.Module:
    if head == "linear":
        return LinearHead(in_dim, out_dim, device=device)
    if head == "mlp":
        return MlpHead(in_dim, out_dim, hidden, dropout, device=device)
    if head == "mlp2":
        return MlpHead(in_dim, out_dim, hidden, dropout, num_hidden_layers=2,
                       device=device)
    if head == "sincos_linear":
        return SinCosHead(in_dim, dropout, device=device)
    if head == "sincos_mlp":
        return SinCosHead(in_dim, dropout, hidden=hidden, device=device)
    if head == "sincos_unit":
        return SinCosHead(in_dim, dropout, unit_normalize=True, device=device)
    raise ValueError(f"unknown head {head!r}")
