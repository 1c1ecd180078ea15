"""VGG16 perceptual loss, the port of `vfi_tpu/losses/perceptual.py`:
both images resized to 224x224 (bilinear, align_corners=False, no
antialiasing), ImageNet-normalized, and compared by the mean absolute
difference of one VGG16 feature tap. `vgg_l1` is that function over a
given trunk, shared with the trainer."""

from __future__ import annotations

import warnings
from typing import Any, Optional

import torch

from vfi_tpu_torch.models.vgg import (IMAGENET_MEAN, IMAGENET_STD,
                                      LAYER_INDEX, VGG16Features)
from vfi_tpu_torch.ops.resize import resize_bilinear


def vgg_l1(vgg: VGG16Features, layer_index: int, a: torch.Tensor,
           b: torch.Tensor, resize: bool = True,
           normalize: bool = True) -> torch.Tensor:
    """mean |vgg(a)[layer] - vgg(b)[layer]| after the resize to 224x224 and
    the ImageNet normalization."""
    if resize:
        a = resize_bilinear(a, (224, 224))
        b = resize_bilinear(b, (224, 224))
    if normalize:
        mean = torch.tensor(IMAGENET_MEAN, device=a.device).to(a.dtype)
        std = torch.tensor(IMAGENET_STD, device=a.device).to(a.dtype)
        a = (a - mean) / std
        b = (b - mean) / std
    return (vgg(a)[layer_index] - vgg(b)[layer_index]).abs().mean()


class VGGPerceptualLoss:
    """Callable `(pred, target) -> scalar`.

    `params`: a VGG16Features tree in the JAX layout (`conv{i}/kernel`,
    `conv{i}/bias`; `utils.convert.load_params_npz` of a
    `convert_vgg16_torch` export). Without it the features are random
    (Flax's init from `rng_seed`), which warns: a degradation fit for
    smoke tests, not for parity evals."""

    def __init__(self, params: Optional[Any] = None,
                 layer: str = "relu2_2", resize: bool = True,
                 normalize: bool = True,
                 dtype: Optional[torch.dtype] = None, rng_seed: int = 0):
        self.layer_index = LAYER_INDEX[layer]
        self.resize = resize
        self.normalize = normalize
        self.module = VGG16Features(max_stage=self.layer_index, dtype=dtype)
        if params is None:
            warnings.warn(
                "VGGPerceptualLoss initialized WITHOUT pretrained weights; "
                "using fixed random features. Import torchvision vgg16 "
                "weights via vfi_tpu_torch.utils.convert.convert_vgg16_torch "
                "for reference-parity training/eval.", stacklevel=2)
            self.module.init_flax_default(
                torch.Generator().manual_seed(rng_seed))
        else:
            self.module.load_params(params)
        self.module.requires_grad_(False).eval()

    def __call__(self, pred: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        return vgg_l1(self.module, self.layer_index, pred, target,
                      self.resize, self.normalize)
