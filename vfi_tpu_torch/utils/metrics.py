"""PSNR / SSIM per image, NHWC, float32 — port of `vfi_tpu/utils/metrics.py`.

SSIM follows Wang et al. 2004: an 11x11 Gaussian window (sigma 1.5), a
depthwise VALID filter (edge windows excluded), the variances clamped at
0, the mean over the valid windows and the channels.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """(B, H, W, C) in [0, max_val] -> (B,) PSNR in dB."""
    pred, target = pred.float(), target.float()
    mse = ((pred - target) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10((max_val * max_val) / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = (torch.arange(size, dtype=torch.float32, device=device)
         - (size - 1) / 2.0)
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    g = g / g.sum()
    return torch.outer(g, g)


@contextlib.contextmanager
def _no_tf32():
    """Full float32 convolutions: cuDNN runs float32 convs in TF32 by
    default, the JAX filter uses Precision.HIGHEST. Restores the setting."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         window_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """(B, H, W, C) in [0, max_val] -> (B,) mean SSIM. float32 throughout
    (the E[x^2] - mu^2 cancellation breaks in bf16), with TF32 off for the
    filter."""
    pred = pred.float().permute(0, 3, 1, 2)
    target = target.float().permute(0, 3, 1, 2)
    c = pred.shape[1]
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    kern = _gaussian_kernel(window_size, sigma, pred.device)
    kern = kern[None, None].expand(c, 1, window_size, window_size)

    def filt(x):
        return F.conv2d(x, kern, groups=c)

    with _no_tf32():
        mu_p, mu_t = filt(pred), filt(target)
        mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
        sigma_pp = (filt(pred * pred) - mu_pp).clamp_min(0.0)
        sigma_tt = (filt(target * target) - mu_tt).clamp_min(0.0)
        sigma_pt = filt(pred * target) - mu_pt
    num = (2.0 * mu_pt + c1) * (2.0 * sigma_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sigma_pp + sigma_tt + c2)
    return (num / den).mean(dim=(1, 2, 3))
