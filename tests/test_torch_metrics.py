"""`psnr` / `ssim` and the .flo reader of the port vs `vfi_tpu.utils`
(float32, inputs from numpy seeds). Tolerances: PSNR 1e-4 dB, SSIM 1e-5,
EPE 1e-5 px."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.utils import flo as jflo
from vfi_tpu.utils.metrics import psnr as jpsnr
from vfi_tpu.utils.metrics import ssim as jssim
from vfi_tpu_torch.utils import flo
from vfi_tpu_torch.utils.metrics import psnr, ssim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GT = os.path.join(REPO, "data", "processed", "other-gt-flow")


def _pair(rng, shape, noise):
    target = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(target + rng.normal(0, noise, shape), 0, 1).astype(
        np.float32)
    return pred, target


@pytest.mark.parametrize("shape,noise", [((3, 32, 48, 3), 0.05),
                                         ((2, 11, 11, 3), 0.2),
                                         ((1, 40, 24, 1), 0.01)])
def test_psnr_ssim_match_jax(rng, shape, noise):
    pred, target = _pair(rng, shape, noise)
    got_p = psnr(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    got_s = ssim(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    assert got_p.shape == got_s.shape == (shape[0],)
    np.testing.assert_allclose(got_p, np.asarray(jpsnr(jnp.asarray(pred),
                                                       jnp.asarray(target))),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_s, np.asarray(jssim(jnp.asarray(pred),
                                                       jnp.asarray(target))),
                               rtol=0, atol=1e-5)


def test_identical_images(rng):
    img = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32))
    np.testing.assert_allclose(ssim(img, img).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(psnr(img, img).numpy(), 120.0, atol=1e-4)


def test_ssim_keeps_the_tf32_setting():
    before = torch.backends.cudnn.allow_tf32
    ssim(torch.zeros(1, 12, 12, 3), torch.ones(1, 12, 12, 3))
    assert torch.backends.cudnn.allow_tf32 == before


def test_read_flo_and_epe_match_jax(rng, tmp_path):
    path = os.path.join(GT, "RubberWhale", "flow10.flo")
    gt = flo.read_flo(path)
    np.testing.assert_array_equal(gt, jflo.read_flo(path))
    assert not flo.flow_valid_mask(gt).all()     # has unknown pixels
    pred = (gt * flo.flow_valid_mask(gt)[..., None]
            + rng.normal(0, 0.5, gt.shape)).astype(np.float32)
    assert abs(flo.endpoint_error(pred, gt)
               - jflo.endpoint_error(pred, gt)) < 1e-5
    bad = tmp_path / "bad.flo"
    bad.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError):
        flo.read_flo(str(bad))
