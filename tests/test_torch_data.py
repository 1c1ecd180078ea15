"""The port's PNG decoder and triplet index vs `vfi_tpu.data.dataset`:
decoded frames equal bit for bit (Yosemite's frames are 8-bit gray, PNG
colour type 0, and come out as three equal channels); the triplet lists
are the same. Synthetic PNGs (written with PIL) cover the other colour
types and the five scanline filters."""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from vfi_tpu.data.dataset import TripletDataset as JTriplets
from vfi_tpu.data.dataset import load_image as jload
from vfi_tpu_torch.data import TripletDataset, load_image
from vfi_tpu_torch.native import decode_png_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAL = os.path.join(REPO, "data", "processed", "val")


@pytest.mark.parametrize("frame", ["Yosemite/frame10.png",
                                   "Army/frame07.png", "Urban/frame14.png",
                                   "Teddy/frame11.png", "Grove/frame09.png"])
def test_load_image_matches_jax_bit_for_bit(frame):
    path = os.path.join(VAL, frame)
    got = load_image(path)
    assert got.dtype == np.float32 and got.shape == (480, 640, 3)
    np.testing.assert_array_equal(got, jload(path))


def test_gray_png_gives_three_equal_channels():
    path = os.path.join(VAL, "Yosemite", "frame10.png")
    with open(path, "rb") as f:
        assert f.read(26)[25] == 0              # IHDR colour type: gray
    img = load_image(path)
    assert (img[..., 0] == img[..., 1]).all()
    assert (img[..., 1] == img[..., 2]).all()


@pytest.mark.parametrize("interval", [1, 2, 3])
def test_triplets_match_jax(interval):
    got = TripletDataset(VAL, interval)
    ref = JTriplets(VAL, interval, augment=None, normalize=False)
    assert got.triplets == ref.triplets and len(got) == len(ref)


def test_triplets_skip_files_and_other_extensions(tmp_path):
    """Files beside the scenes are not scenes; only .png/.jpg/.jpeg count
    as frames, in name order."""
    (tmp_path / "notes.txt").write_text("x")
    scene = tmp_path / "S"
    scene.mkdir()
    for name in ("f3.png", "f1.PNG", "f2.jpg", "readme.md", "f0.jpeg"):
        (scene / name).write_bytes(b"")
    ds = TripletDataset(str(tmp_path))
    assert ds.triplets == [tuple(str(scene / n) for n in names)
                           for names in (("f0.jpeg", "f1.PNG", "f2.jpg"),
                                         ("f1.PNG", "f2.jpg", "f3.png"))]
    assert ds.triplets == JTriplets(str(tmp_path), normalize=False).triplets


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_decoder_matches_pil_on_every_colour_type(tmp_path, mode):
    rng = np.random.default_rng(1)
    # A smooth gradient plus noise: PIL's encoder picks a mix of filters.
    base = (np.add.outer(np.arange(37), np.arange(53)) * 3 % 256)
    arr = (base[..., None] + rng.integers(0, 9, (37, 53, 4))) % 256
    img = Image.fromarray(arr.astype(np.uint8), "RGBA").convert(mode)
    path = tmp_path / f"x_{mode}.png"
    img.save(path)
    ref = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(decode_png_rgb(path.read_bytes()), ref)


def _png(w, h, rows, color_type=2, depth=8, interlace=0):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def test_each_scanline_filter():
    """Rows filtered by None, Sub, Up, Average and Paeth in turn, each
    built by hand from a known image."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (5, 7, 3)).astype(np.int32)
    raw = b""
    prev = np.zeros(7 * 3, np.int32)
    for y, filt in enumerate(range(5)):
        cur = img[y].reshape(-1)
        left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        if filt == 0:
            pred = np.zeros_like(cur)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prev
        elif filt == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([filt]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    got = decode_png_rgb(_png(7, 5, raw))
    np.testing.assert_array_equal(got, img.astype(np.uint8))


@pytest.mark.parametrize("data", [
    b"not a png at all",
    _png(2, 2, b"\x00" + b"\x00" * 12 + b"\x00" + b"\x00" * 12,
         depth=16, color_type=3),                  # no 16-bit palettes
    _png(2, 2, b"\x00" * 14, interlace=1),         # Adam7 needs 15 bytes
    _png(2, 2, b"\x00" * 5),                       # short scanlines
    _png(2, 1, b"\x07" + b"\x00" * 6),             # unknown filter
])
def test_decoder_refuses_what_it_cannot_read(data):
    with pytest.raises(ValueError):
        decode_png_rgb(data)


def test_load_image_refuses_other_formats(tmp_path):
    path = tmp_path / "x.jpg"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    with pytest.raises(ValueError):
        load_image(str(path))
