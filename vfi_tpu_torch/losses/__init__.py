"""Loss stack of the port: Charbonnier, VGG-perceptual, colour histogram,
Sobel gradient and temporal consistency."""

from vfi_tpu_torch.losses.losses import (LossWeights, charbonnier_loss,
                                         color_histogram_loss, gradient_loss,
                                         l1_loss, l2_loss,
                                         temporal_consistency_loss,
                                         total_loss)
from vfi_tpu_torch.losses.perceptual import VGGPerceptualLoss, vgg_l1

__all__ = ["LossWeights", "VGGPerceptualLoss", "charbonnier_loss",
           "color_histogram_loss", "gradient_loss", "l1_loss", "l2_loss",
           "temporal_consistency_loss", "total_loss", "vgg_l1"]
