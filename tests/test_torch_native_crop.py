"""The port's fused crop + hflip + [0, 1] + ImageNet-normalize core
(`vfi_tpu_torch.native.crop_flip_normalize`, C++ in `native/png.cpp`)
against the JAX package's (`vfi_tpu.native.crop_flip_normalize`, C++ in
`vfi_tpu/native/vfi_io.cpp`), bit for bit, and against numpy's arithmetic
on the same window; a window reaching outside the image raises
ValueError, where the JAX core reads past the image."""

import numpy as np
import pytest

from vfi_tpu import native as jnative
from vfi_tpu_torch import native

H, W = 23, 37
MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
STD = np.asarray([0.229, 0.224, 0.225], np.float32)
INV255 = np.float32(1.0) / np.float32(255.0)


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(19).integers(0, 256, (H, W, 3),
                                              dtype=np.uint8)


def _numpy(img, top, left, crop, hflip, norm):
    """The core's arithmetic in numpy: s * float32(1/255), or the fused
    multiply-add float32(s * float64(1/255) - mean) (the float64 sum of a
    byte times a float32 and a float32 is exact) divided by std."""
    ch, cw = crop
    win = img[top:top + ch, left:left + cw]
    if hflip:
        win = win[:, ::-1]
    if not norm:
        return win.astype(np.float32) * INV255
    fused = (win.astype(np.float64) * np.float64(INV255)
             - MEAN.astype(np.float64)).astype(np.float32)
    return fused / STD


def test_available():
    assert native.available()


# the whole image, a 1x1 window, a window off every edge
@pytest.mark.parametrize("top,left,crop", [(0, 0, (H, W)), (22, 36, (1, 1)),
                                           (3, 5, (16, 20))])
@pytest.mark.parametrize("hflip", [False, True])
@pytest.mark.parametrize("norm", [False, True])
def test_crop_flip_normalize_is_bit_equal_to_jax(img, top, left, crop, hflip,
                                                 norm):
    got = native.crop_flip_normalize(img, top, left, crop, hflip, norm)
    assert got.dtype == np.float32 and got.shape == crop + (3,)
    np.testing.assert_array_equal(
        got, jnative.crop_flip_normalize(img, top, left, crop, hflip, norm))
    np.testing.assert_array_equal(
        got, _numpy(img, top, left, crop, hflip, norm))


@pytest.mark.parametrize("top,left,crop", [
    (-1, 0, (2, 2)), (0, -1, (2, 2)), (22, 0, (2, 2)), (0, 36, (2, 2)),
    (0, 0, (H + 1, W)), (0, 0, (H, W + 1))])
def test_window_outside_the_image_raises(img, top, left, crop):
    with pytest.raises(ValueError, match="outside"):
        native.crop_flip_normalize(img, top, left, crop, False, True)


def test_takes_rgb_images_only(img):
    with pytest.raises(ValueError, match="RGB"):
        native.crop_flip_normalize(img[..., 0], 0, 0, (2, 2), False, False)
