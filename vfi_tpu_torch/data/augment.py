"""Synchronized triplet augmentations (pure numpy, host-side), the port's
copy of `vfi_tpu/data/augment.py`: the same draws from the same
`np.random.Generator` give the same arrays bit for bit.

Reproduces the reference's augmentation chain
(reference: src/utils/data_utils.py:50-97) with the same sampling laws:

- shared random crop (crop params drawn once per triplet, :51-57)
- shared rotation, uniform in [-180, 180], nearest resample, zeros fill
  (torchvision `functional.rotate` defaults, :59-63)
- shared horizontal flip, p = 0.5 (:65-69)
- color jitter with torchvision's factor laws (brightness/contrast/
  saturation factor ~ U[max(0, 1-v), 1+v]; hue ~ U[-h, h]) applied in a
  random op order. The reference instantiates a fresh ColorJitter per frame,
  so each of the 3 frames gets INDEPENDENT jitter (:72-76) — a consistency
  bug kept as the default; `consistent=True` shares one draw per triplet.
- random 3-channel grayscale (ITU-R 601-2 luma, like PIL convert('L')), p
  applied per triplet (:79-82)

Everything operates on float32 RGB in [0, 1], NHWC-single (H, W, 3).
Divergences from torchvision (documented): jitter/hue math runs in float32
rather than PIL uint8, and rotation uses an inverse-map nearest gather
rather than PIL's implementation — both are sub-quantization-step close.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class AugmentConfig:
    crop_size: Optional[Tuple[int, int]] = (256, 256)
    random_rotation: bool = True
    horizontal_flip: bool = True
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1
    color_jitter: bool = True
    random_grayscale: float = 0.2
    consistent_jitter: bool = False


def random_crop_params(rng: np.random.Generator, hw: Tuple[int, int],
                       out: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """torchvision RandomCrop.get_params: uniform top-left (data_utils.py:52)."""
    h, w = hw
    th, tw = out
    if h < th or w < tw:
        raise ValueError(f"crop {out} larger than image {(h, w)}")
    top = 0 if h == th else int(rng.integers(0, h - th + 1))
    left = 0 if w == tw else int(rng.integers(0, w - tw + 1))
    return top, left, th, tw


def rotate_nearest(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate around the image center, nearest resample, zeros fill —
    torchvision `functional.rotate` defaults (data_utils.py:61-63)."""
    h, w = img.shape[:2]
    a = np.deg2rad(angle_deg)
    cos, sin = np.cos(a), np.sin(a)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    # Inverse mapping: output pixel (y, x) pulls from input rotated by -angle.
    dy, dx = ys - cy, xs - cx
    src_y = cos * dy + sin * dx + cy
    src_x = -sin * dy + cos * dx + cx
    yi = np.rint(src_y).astype(np.int64)
    xi = np.rint(src_x).astype(np.int64)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    out = np.zeros_like(img)
    out[valid] = img[yi[valid], xi[valid]]
    return out


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def _grayscale(img: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma (PIL convert('L') weights), keepdims."""
    return (img[..., 0] * 0.299 + img[..., 1] * 0.587
            + img[..., 2] * 0.114)[..., None]


def _rgb_to_hsv(img: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    # Elementwise maximum/minimum instead of axis reductions: the hue op is
    # the data pipeline's hot spot on this 1-core host, and numpy's
    # reduce-over-minor-axis is ~4x slower than two elementwise maxima.
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, h)
    h = (h / 6.0) % 1.0
    return h, s, v


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    # Branch-free "K-mod" form of the standard sextant formula (identical
    # math to the p/q/t case table, ~4x faster than stacking 6 choices and
    # gathering): chan(n) = v - v*s*clip(min(k, 4-k), 0, 1), k = (n+6h) mod 6.
    vs = v * s

    def chan(n: float) -> np.ndarray:
        k = (n + h * 6.0) % 6.0
        return v - vs * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0)

    return np.stack([chan(5.0), chan(3.0), chan(1.0)], -1)


def sample_jitter_params(rng: np.random.Generator, cfg: AugmentConfig):
    """torchvision ColorJitter.get_params: one factor per property + a random
    application order."""
    order = rng.permutation(4)
    fb = rng.uniform(max(0.0, 1 - cfg.brightness), 1 + cfg.brightness) if cfg.brightness else None
    fc = rng.uniform(max(0.0, 1 - cfg.contrast), 1 + cfg.contrast) if cfg.contrast else None
    fs = rng.uniform(max(0.0, 1 - cfg.saturation), 1 + cfg.saturation) if cfg.saturation else None
    fh = rng.uniform(-cfg.hue, cfg.hue) if cfg.hue else None
    return order, fb, fc, fs, fh


def apply_jitter(img: np.ndarray, params) -> np.ndarray:
    order, fb, fc, fs, fh = params
    for op in order:
        if op == 0 and fb is not None:      # brightness
            img = np.clip(img * fb, 0.0, 1.0)
        elif op == 1 and fc is not None:    # contrast: blend with mean luma
            mean = _grayscale(img).mean()
            img = _blend(img, mean, fc)
        elif op == 2 and fs is not None:    # saturation: blend with grayscale
            img = _blend(img, _grayscale(img), fs)
        elif op == 3 and fh is not None:    # hue: HSV rotation
            h, s, v = _rgb_to_hsv(img)
            img = _hsv_to_rgb((h + fh) % 1.0, s, v)
    return img.astype(np.float32)


def augment_triplet(
    frames: Sequence[np.ndarray],
    rng: np.random.Generator,
    cfg: AugmentConfig,
) -> list[np.ndarray]:
    """Apply the full augmentation chain to a (f0, ft, f1) triplet.

    Args:
      frames: three (H, W, 3) float32 arrays in [0, 1].
    Returns: three augmented (h', w', 3) float32 arrays in [0, 1].
    """
    frames = list(frames)
    if cfg.crop_size:
        top, left, th, tw = random_crop_params(rng, frames[0].shape[:2], cfg.crop_size)
        frames = [f[top:top + th, left:left + tw] for f in frames]
    if cfg.random_rotation:
        angle = float(rng.uniform(-180.0, 180.0))
        frames = [rotate_nearest(f, angle) for f in frames]
    if cfg.horizontal_flip and rng.random() > 0.5:
        frames = [f[:, ::-1].copy() for f in frames]
    if cfg.color_jitter:
        if cfg.consistent_jitter:
            params = sample_jitter_params(rng, cfg)
            frames = [apply_jitter(f, params) for f in frames]
        else:
            # Reference behavior: independent draw per frame (data_utils.py:72-76).
            frames = [apply_jitter(f, sample_jitter_params(rng, cfg)) for f in frames]
    if cfg.random_grayscale and rng.random() < cfg.random_grayscale:
        frames = [np.repeat(_grayscale(f), 3, axis=-1).astype(np.float32) for f in frames]
    return frames
