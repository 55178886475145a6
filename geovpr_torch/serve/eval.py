"""Per-batch eval sums and their summary (the geopose half of
`geovpr/train/steps.py:111-188`, `make_eval_step` and `summarize_eval`).

A batch contributes SUMS over its valid rows (f32, on the device) plus the
valid count, so that a ragged final batch, padded by `iterate_batches`,
counts exactly; `summarize_eval` turns the accumulated sums into the
reference's metric suite on the host.
"""

from __future__ import annotations

from typing import Optional

import torch


def eval_sums(decoded: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> dict:
    """Error sums of one batch of decoded (lat, lon) predictions, (B, 2)
    f32, against raw targets (B, 2); `mask` (B,) bool marks real rows."""
    if decoded.dim() != 2:
        raise NotImplementedError(
            "only geopose (B, 2) predictions are served by the port so far; "
            "the angle objectives come with the angle-head slice")
    if mask is None:
        mask = torch.ones(decoded.shape[0], dtype=torch.bool,
                          device=decoded.device)
    m = mask.to(torch.float32)
    err = decoded - target.to(decoded.dtype)
    return {
        "count": m.sum(),
        "sq_err": ((err.T * m).T ** 2).sum(),
        "abs_err": (err.abs().T * m).T.sum(),
        "abs_err_lat": (err[:, 0].abs() * m).sum(),
        "abs_err_lon": (err[:, 1].abs() * m).sum(),
        "sq_err_lat": (err[:, 0] ** 2 * m).sum(),
        "sq_err_lon": (err[:, 1] ** 2 * m).sum(),
    }


def add_sums(total: Optional[dict], sums: dict) -> dict:
    """Accumulate one batch's sums into the running total (on the device,
    so that no batch forces a host sync)."""
    if total is None:
        return dict(sums)
    return {k: total[k] + v for k, v in sums.items()}


def summarize_eval(sums: dict) -> dict:
    """Host-side reduction into the geopose metric suite: MSE averaged over
    both axes (= the competition loss), RMSE, MAE, per-axis MAE."""
    n = max(float(sums["count"]), 1.0)
    out = {"mse": float(sums["sq_err"]) / (2 * n)}
    out["rmse"] = out["mse"] ** 0.5
    out["mae"] = float(sums["abs_err"]) / (2 * n)
    out["mae_lat"] = float(sums["abs_err_lat"]) / n
    out["mae_lon"] = float(sums["abs_err_lon"]) / n
    out["competition_loss"] = out["mse"]
    return out
