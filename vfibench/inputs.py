"""Frame pairs for a run, made from `--seed` by the benchmark's own code.

A pool of distinct pairs of consecutive Middlebury frames (the tracked
PNGs under `data/processed/{train,val}`), chosen, cropped and flipped by
the seed, then resized with a separable bilinear filter (half-pixel
centres, no antialiasing) to the cell's frame size. Every seed gives the
same number of pairs at the same size, so the work does not depend on the
seed; only which frames, which crop and which flips do.

Needs numpy and OpenCV's PNG decoder (`cv2`), no torch, so the serving
cell's client process can make the same pool without loading torch.
"""

from __future__ import annotations

import functools
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
DATA_ROOT = REPO / "data" / "processed"
SPLITS = ("train", "val")
SOURCE_HW = (480, 640)        # every Middlebury frame under DATA_ROOT
_FRAME = re.compile(r"frame(\d+)\.png$")


def scene_pairs(data_root: Path = DATA_ROOT) -> list:
    """Every (frame t, frame t+1) path pair of the splits' scenes, sorted."""
    pairs = []
    for split in SPLITS:
        for scene in sorted((data_root / split).iterdir()):
            nums = {int(m.group(1)): p for p in scene.iterdir()
                    if (m := _FRAME.search(p.name))}
            pairs += [(nums[t], nums[t + 1]) for t in sorted(nums)
                      if t + 1 in nums]
    if not pairs:
        raise FileNotFoundError(f"no consecutive frame pairs under "
                                f"{data_root}")
    return pairs


def decode_png(path: Path) -> np.ndarray:
    """(H, W, 3) uint8 RGB; grey PNGs come back with three equal planes."""
    import cv2

    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError(f"cannot decode {path}")
    return np.ascontiguousarray(bgr[..., ::-1])


@functools.lru_cache(maxsize=8)
def _interp_matrix(out_n: int, in_n: int) -> np.ndarray:
    """(out_n, in_n) bilinear weights, half-pixel centres, sources below 0
    clamped to 0 (as `F.interpolate(align_corners=False)`)."""
    src = np.maximum((np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_n - 1)
    i1 = np.minimum(i0 + 1, in_n - 1)
    w1 = src - i0
    m = np.zeros((out_n, in_n), np.float64)
    np.add.at(m, (np.arange(out_n), i0), 1.0 - w1)
    np.add.at(m, (np.arange(out_n), i1), w1)
    m = m.astype(np.float32)
    m.flags.writeable = False
    return m


def resize_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8, bilinear, rounded."""
    mh = _interp_matrix(h, img.shape[0])
    mw = _interp_matrix(w, img.shape[1])
    out = np.tensordot(mh, img.astype(np.float32), axes=(1, 0))
    out = np.tensordot(mw, out, axes=(1, 1)).transpose(1, 0, 2)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def make_pool(seed: int, n_pairs: int, size: tuple, crop: tuple,
              data_root: Path = DATA_ROOT) -> tuple:
    """(f0, f1): two (n_pairs, H, W, 3) uint8 arrays at `size` = (H, W).
    Pair i is a distinct consecutive pair drawn by the seed, cut to a
    `crop` = (h, w) window at a seeded position, flipped left-right and
    upside-down each with probability 1/2, and resized to `size`."""
    rng = np.random.default_rng(seed)
    pairs = scene_pairs(data_root)
    if n_pairs > len(pairs):
        raise ValueError(f"{n_pairs} pairs asked, {len(pairs)} exist")
    pick = rng.choice(len(pairs), size=n_pairs, replace=False)
    ch, cw = crop
    jobs = []
    for k in pick:
        y = int(rng.integers(0, SOURCE_HW[0] - ch + 1))
        x = int(rng.integers(0, SOURCE_HW[1] - cw + 1))
        flips = tuple(bool(v) for v in rng.integers(0, 2, size=2))
        jobs.append((pairs[k], y, x, flips))

    def one(job):
        paths, y, x, (flip_x, flip_y) = job
        out = []
        for p in paths:
            img = decode_png(p)
            if img.shape[:2] != SOURCE_HW:
                raise ValueError(f"{p}: {img.shape[:2]}, expected "
                                 f"{SOURCE_HW}")
            img = img[y:y + ch, x:x + cw]
            if flip_x:
                img = img[:, ::-1]
            if flip_y:
                img = img[::-1]
            out.append(resize_u8(img, *size))
        return out

    f0 = np.empty((n_pairs, *size, 3), np.uint8)
    f1 = np.empty_like(f0)
    with ThreadPoolExecutor(max_workers=4) as ex:
        for i, (a, b) in enumerate(ex.map(one, jobs)):
            f0[i], f1[i] = a, b
    return f0, f1
