"""Frame-triplet dataset over scene directories, port of the evaluation
part of `vfi_tpu/data/dataset.py`.

Each subdirectory of `data_dir` is a scene; its frames are the name-sorted
.png/.jpg/.jpeg files; the samples are the overlapping (i, i + interval,
i + 2 * interval) triplets. PNGs decode through the port's own decoder
(`vfi_tpu_torch.native`). Loading, augmentation and normalization of
training samples belong to the training slice and are not ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from vfi_tpu_torch import native

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_EXTS = (".png", ".jpg", ".jpeg")


def load_image(path: str) -> np.ndarray:
    """Decode a PNG to (H, W, 3) float32 RGB in [0, 1]; other formats and
    PNGs the decoder cannot read raise ValueError."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only PNG frames are supported")
    with open(path, "rb") as f:
        img = native.decode_png_rgb(f.read())
    return img.astype(np.float32) / 255.0


@dataclass
class TripletDataset:
    """Index of (frame0, frame_t, frame1) triplet paths: for each scene
    subdirectory of `data_dir` (sorted), its name-sorted frames taken as
    overlapping (i, i + interval, i + 2 * interval) triplets."""

    data_dir: str
    frame_interval: int = 1
    triplets: List[Tuple[str, str, str]] = field(init=False)

    def __post_init__(self):
        self.triplets = []
        fi = self.frame_interval
        for scene in sorted(os.listdir(self.data_dir)):
            scene_path = os.path.join(self.data_dir, scene)
            if not os.path.isdir(scene_path):
                continue
            frames = sorted(os.path.join(scene_path, f)
                            for f in os.listdir(scene_path)
                            if f.lower().endswith(_EXTS))
            for i in range(len(frames) - 2 * fi):
                self.triplets.append((frames[i], frames[i + fi],
                                      frames[i + 2 * fi]))

    def __len__(self) -> int:
        return len(self.triplets)
