"""Loss functions (NHWC), the port of `vfi_tpu/losses/losses.py`: the
reference's training objective of Charbonnier, VGG-perceptual, colour
histogram and Sobel-gradient terms, plus the temporal-consistency term
that needs a flow estimator."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from vfi_tpu_torch.ops.histogram import color_histogram, soft_color_histogram
from vfi_tpu_torch.ops.sobel import sobel_gradients
from vfi_tpu_torch.ops.warp import warp


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return (pred - target).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error."""
    return ((pred - target) ** 2).mean()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     epsilon: float = 1e-3) -> torch.Tensor:
    """mean(sqrt(diff^2 + eps^2))."""
    return torch.sqrt((pred - target) ** 2 + epsilon * epsilon).mean()


def gradient_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sobel edge difference: mean(|dGx| + |dGy|)."""
    pgx, pgy = sobel_gradients(pred)
    tgx, tgy = sobel_gradients(target)
    return ((pgx - tgx).abs() + (pgy - tgy).abs()).mean()


def color_histogram_loss(pred: torch.Tensor, target: torch.Tensor,
                         num_bins: int = 256,
                         soft: bool = False) -> torch.Tensor:
    """Sum over channels and bins of |hist_p - hist_t|, over the batch.
    The exact histogram (`soft=False`, the reference's) gives the term no
    gradient; `soft=True` bins linearly and has one."""
    hist = soft_color_histogram if soft else color_histogram
    return (hist(pred, num_bins) - hist(target, num_bins)).abs().sum() / \
        pred.shape[0]


def temporal_consistency_loss(pred: torch.Tensor, frame0: torch.Tensor,
                              frame1: torch.Tensor,
                              flow_estimator: Callable) -> torch.Tensor:
    """Warp both end frames toward the prediction by the estimated flow,
    nearest mode, and penalize the disagreement."""
    w0 = warp(frame0, flow_estimator(frame0, pred), mode="nearest")
    w1 = warp(frame1, flow_estimator(pred, frame1), mode="nearest")
    return (w0 - pred).abs().mean() + (w1 - pred).abs().mean()


@dataclass(frozen=True)
class LossWeights:
    """Weights of the total objective (the reference YAML's values)."""

    charbonnier: float = 0.5
    vgg: float = 0.15
    color: float = 0.3
    gradient: float = 0.1
    temporal: float = 0.15


def total_loss(pred: torch.Tensor, target: torch.Tensor,
               vgg_loss_fn: Optional[Callable],
               weights: LossWeights = LossWeights(),
               flow_estimator: Optional[Callable] = None,
               frame0: Optional[torch.Tensor] = None,
               frame1: Optional[torch.Tensor] = None,
               soft_histogram: bool = False) -> tuple[torch.Tensor, dict]:
    """(weighted total, dict of the unweighted terms). `temporal` is a term
    only with a positive weight, an estimator and both end frames."""
    terms = {
        "charbonnier": charbonnier_loss(pred, target),
        "vgg": (vgg_loss_fn(pred, target) if vgg_loss_fn is not None
                else torch.zeros((), dtype=pred.dtype, device=pred.device)),
        "color": color_histogram_loss(pred, target, soft=soft_histogram),
        "gradient": gradient_loss(pred, target),
    }
    total = (weights.charbonnier * terms["charbonnier"]
             + weights.vgg * terms["vgg"]
             + weights.color * terms["color"]
             + weights.gradient * terms["gradient"])
    if (weights.temporal > 0 and flow_estimator is not None
            and frame0 is not None and frame1 is not None):
        terms["temporal"] = temporal_consistency_loss(pred, frame0, frame1,
                                                      flow_estimator)
        total = total + weights.temporal * terms["temporal"]
    return total, terms
