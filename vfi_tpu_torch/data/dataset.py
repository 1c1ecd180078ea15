"""Frame-triplet dataset over scene directories, port of
`vfi_tpu/data/dataset.py`.

Each subdirectory of `data_dir` is a scene; its frames are the name-sorted
.png/.jpg/.jpeg files; the samples are the overlapping (i, i + interval,
i + 2 * interval) triplets. PNGs decode through the port's own decoder
(`vfi_tpu_torch.native`). `get(idx, rng)` loads, augments
(`data/augment.py`) and ImageNet-normalizes one training sample; decoded
frames are cached (FIFO, read-only arrays) up to `cache_decoded_mb`.
The eval CLI reads only the index (`triplets`) and `load_image`.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vfi_tpu_torch import native
from vfi_tpu_torch.data.augment import AugmentConfig, augment_triplet

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
    overlapping (i, i + interval, i + 2 * interval) triplets.

    `augment`: an AugmentConfig, or None (no augmentation). `normalize`:
    ImageNet-normalize after augmentation, the reference's training
    convention. `cache_decoded_mb`: the budget of the decoded-frame cache
    (0 disables it); the oldest entry goes first, and cached arrays are
    read-only, since the augment and normalize steps never write them."""

    data_dir: str
    frame_interval: int = 1
    augment: Optional[AugmentConfig] = None
    normalize: bool = True
    cache_decoded_mb: float = 512.0
    triplets: List[Tuple[str, str, str]] = field(init=False)

    def __post_init__(self):
        self._cache: dict = {}
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
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

    def _load(self, path: str) -> np.ndarray:
        img = self._cache.get(path)
        if img is not None:
            return img
        img = load_image(path)
        limit = int(self.cache_decoded_mb * 1e6)
        if limit > 0 and img.nbytes <= limit:
            img.setflags(write=False)
            with self._cache_lock:
                while self._cache_bytes + img.nbytes > limit and self._cache:
                    oldest = next(iter(self._cache))
                    self._cache_bytes -= self._cache.pop(oldest).nbytes
                if path not in self._cache:
                    self._cache[path] = img
                    self._cache_bytes += img.nbytes
        return img

    def get(self, idx: int, rng: np.random.Generator) -> Sequence[np.ndarray]:
        """Load, augment and normalize one triplet: three (h, w, 3)
        float32 arrays."""
        frames = [self._load(p) for p in self.triplets[idx]]
        if self.augment is not None:
            frames = augment_triplet(frames, rng, self.augment)
        if self.normalize:
            frames = [(f - IMAGENET_MEAN) / IMAGENET_STD for f in frames]
        return frames
