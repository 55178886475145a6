"""Per-batch eval sums and their summary (`make_eval_step`'s sums and
`summarize_eval`, `geovpr/train/steps.py:111-188`).

A batch contributes SUMS over its valid rows (f32, on the device) plus the
valid count, so that a ragged final batch, padded by `iterate_batches`,
counts exactly; `summarize_eval` turns the accumulated sums into the
reference's metric suite on the host. Geopose predictions are (B, 2)
(lat, lon); angle predictions (B,) degrees, whose error sums are all
circular: the train manifest holds targets up to 750 deg, so a raw
difference is never taken.
"""

from __future__ import annotations

from typing import Optional

import torch

from geovpr_torch.objectives.losses import angular_error_deg


def eval_sums(decoded: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> dict:
    """Error sums of one batch of decoded predictions, f32, against raw
    targets: geopose (B, 2) against (B, 2), angle (B,) against (B,) or (B,
    1); `mask` (B,) bool marks real rows."""
    if mask is None:
        mask = torch.ones(decoded.shape[0], dtype=torch.bool,
                          device=decoded.device)
    m = mask.to(torch.float32)
    target = target.to(decoded.dtype)
    if decoded.dim() == 1:
        ang = angular_error_deg(decoded, target.reshape(-1))
        ang_err = (ang * m).sum()
        return {"count": m.sum(), "sq_err": (ang ** 2 * m).sum(),
                "abs_err": ang_err, "ang_err": ang_err}
    err = decoded - target
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


def reduce_sums(sums: dict, mesh) -> dict:
    """The sums over every rank's rows: one all-reduce over `data` of the
    stacked sums (unchanged without a mesh)."""
    if mesh is None:
        return sums
    from geovpr_torch.parallel.mesh import all_reduce_
    keys = sorted(sums)
    total = all_reduce_(torch.stack([sums[k].float() for k in keys]), mesh)
    return dict(zip(keys, total.unbind()))


def summarize_eval(sums: dict) -> dict:
    """Host-side reduction into the metric suite: for angles MAAE and the
    mean squared circular error; for geopose MSE averaged over both axes
    (= the competition loss), RMSE, MAE, per-axis MAE."""
    n = max(float(sums["count"]), 1.0)
    if "ang_err" in sums:
        return {"maae": float(sums["ang_err"]) / n,
                "mse": float(sums["sq_err"]) / n}
    out = {"mse": float(sums["sq_err"]) / (2 * n)}
    out["rmse"] = out["mse"] ** 0.5
    out["mae"] = float(sums["abs_err"]) / (2 * n)
    out["mae_lat"] = float(sums["abs_err_lat"]) / n
    out["mae_lon"] = float(sums["abs_err_lon"]) / n
    out["competition_loss"] = out["mse"]
    return out
