"""Prediction CSVs (the port's copy of the geopose and angle writers of
`geovpr/pipeline/export.py:27-115`; tests hold the bytes equal).

- validation (`validation_swin_2.py:205-218`, `%.6f`): filename,
  true_latitude, true_longitude, predicted_latitude, predicted_longitude,
  error_latitude, error_longitude
- test (`val_and_test_swin_2.py:334-339`, sorted by filename): filename,
  predicted_latitude, predicted_longitude
- submission (`swin_validation.py:121-134`, ID from the filename digits,
  sorted numerically): ID, latitude, longitude
- angle validation (`validation_script.py:212-221`, values as Python
  prints them): filename, true_angle, predicted_angle, angular_error
- angle test (`test_script.py:275-276`, sorted by filename): filename,
  predicted_angle_degrees
"""

from __future__ import annotations

import csv
import re
from typing import Sequence

import numpy as np


def _fmt(x: float) -> str:
    return f"{x:.6f}"


def write_geopose_validation_csv(path: str, filenames: Sequence[str],
                                 true_latlon: np.ndarray,
                                 pred_latlon: np.ndarray):
    err = np.abs(pred_latlon - true_latlon)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "true_latitude", "true_longitude",
                    "predicted_latitude", "predicted_longitude",
                    "error_latitude", "error_longitude"])
        for i, name in enumerate(filenames):
            w.writerow([name,
                        _fmt(true_latlon[i, 0]), _fmt(true_latlon[i, 1]),
                        _fmt(pred_latlon[i, 0]), _fmt(pred_latlon[i, 1]),
                        _fmt(err[i, 0]), _fmt(err[i, 1])])


def write_geopose_test_csv(path: str, filenames: Sequence[str],
                           pred_latlon: np.ndarray):
    order = np.argsort(np.asarray(filenames, dtype=object))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "predicted_latitude", "predicted_longitude"])
        for i in order:
            w.writerow([filenames[i], _fmt(pred_latlon[i, 0]),
                        _fmt(pred_latlon[i, 1])])


def write_geopose_preds_csv(path: str, filenames: Sequence[str],
                            pred_latlon: np.ndarray):
    """Submission format: numeric ID parsed from the filename digits, sorted
    ascending."""
    ids = []
    for name in filenames:
        m = re.search(r"(\d+)", name)
        ids.append(int(m.group(1)) if m else -1)
    order = np.argsort(ids)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ID", "latitude", "longitude"])
        for i in order:
            w.writerow([ids[i], _fmt(pred_latlon[i, 0]),
                        _fmt(pred_latlon[i, 1])])


def write_angle_validation_csv(path: str, filenames: Sequence[str],
                               true_angle: np.ndarray, pred_angle: np.ndarray):
    d = np.abs(pred_angle - true_angle) % 360.0
    err = np.minimum(d, 360.0 - d)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "true_angle", "predicted_angle",
                    "angular_error"])
        for i, name in enumerate(filenames):
            w.writerow([name, true_angle[i], pred_angle[i], err[i]])


def write_angle_test_csv(path: str, filenames: Sequence[str],
                         pred_angle: np.ndarray):
    order = np.argsort(np.asarray(filenames, dtype=object))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "predicted_angle_degrees"])
        for i in order:
            w.writerow([filenames[i], pred_angle[i]])
