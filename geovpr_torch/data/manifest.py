"""Label CSV manifests (the port's copy of `geovpr.data.manifest`'s
`Manifest`, `load_manifest` and `list_test_images`, so the CLIs need
nothing of `geovpr`).

A manifest CSV has the columns filename, timestamp, latitude, longitude,
angle, Region_ID. Rows whose image is missing under `image_root` are
dropped by default; `screen_corrupt_images` also opens each file with PIL.
Tests hold this copy to the original on the same CSV.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Sequence

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


@dataclasses.dataclass
class Manifest:
    filenames: list[str]
    latitude: np.ndarray    # (N,) float32
    longitude: np.ndarray   # (N,) float32
    angle: np.ndarray       # (N,) float32, raw degrees (may exceed 360)
    region_id: np.ndarray   # (N,) int32
    image_root: str = ""

    def __len__(self) -> int:
        return len(self.filenames)

    @property
    def latlon(self) -> np.ndarray:
        return np.stack([self.latitude, self.longitude], axis=1)

    def paths(self) -> list[str]:
        return [os.path.join(self.image_root, f) for f in self.filenames]

    def select(self, idx: Sequence[int]) -> "Manifest":
        idx = np.asarray(idx)
        return Manifest(
            filenames=[self.filenames[i] for i in idx],
            latitude=self.latitude[idx],
            longitude=self.longitude[idx],
            angle=self.angle[idx],
            region_id=self.region_id[idx],
            image_root=self.image_root,
        )


def _verify_image(path: str) -> bool:
    try:
        from PIL import Image
        with Image.open(path) as img:
            img.verify()
        return True
    except Exception:
        return False


def load_manifest(csv_path: str, image_root: str = "",
                  screen_missing_files: bool = True,
                  screen_corrupt_images: bool = False) -> Manifest:
    filenames: list[str] = []
    lat, lon, ang, region = [], [], [], []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            name = row["filename"]
            if image_root and (screen_missing_files or screen_corrupt_images):
                path = os.path.join(image_root, name)
                if screen_missing_files and not os.path.isfile(path):
                    continue
                if screen_corrupt_images and not _verify_image(path):
                    continue
            filenames.append(name)
            lat.append(float(row["latitude"]))
            lon.append(float(row["longitude"]))
            ang.append(float(row["angle"]))
            region.append(int(row["Region_ID"]))
    return Manifest(
        filenames=filenames,
        latitude=np.asarray(lat, np.float32),
        longitude=np.asarray(lon, np.float32),
        angle=np.asarray(ang, np.float32),
        region_id=np.asarray(region, np.int32),
        image_root=image_root,
    )


def list_test_images(test_dir: str) -> list[str]:
    """Unlabeled test images: the files with an image extension, sorted by
    name (val_and_test_swin_2.py:125-140)."""
    return sorted(n for n in os.listdir(test_dir)
                  if n.lower().endswith(IMAGE_EXTENSIONS))
