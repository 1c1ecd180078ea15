"""VGG16 feature extractor (NHWC) for the perceptual loss, the port of
`vfi_tpu/models/vgg.py`: torchvision `vgg16().features` up to relu4_3, in
four stages whose outputs are the taps relu1_2 / relu2_2 / relu3_3 /
relu4_3. Only stages up to `max_stage` are built, so a relu2_2 loss never
holds or runs the 256- and 512-wide stages.

The convs are named `conv0` ... `conv9` with `weight` / `bias`, so that
`utils.convert.params_from_jax` maps the Flax tree (`conv{i}/kernel`
HWIO, `conv{i}/bias`) or a `convert_vgg16_torch` `.npz` onto it.
Pretrained weights are not in the repository; without them the trainer
runs random features, initialized as Flax's `nn.Conv` does
(`init_flax_default`): lecun_normal kernels, zero biases.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

VGG16_STAGES: Sequence[Sequence[Any]] = (
    (64, 64),                # -> relu1_2
    ("M", 128, 128),         # -> relu2_2
    ("M", 256, 256, 256),    # -> relu3_3
    ("M", 512, 512, 512),    # -> relu4_3
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

LAYER_INDEX = {"relu1_2": 0, "relu2_2": 1, "relu3_3": 2, "relu4_3": 3}

# lecun_normal draws from a normal truncated to two standard deviations,
# scaled so that the variance is 1 / fan_in: the scale is 1 over the
# truncated unit normal's standard deviation.
_TRUNC_STD = 0.87962566103423978


class VGG16Features(nn.Module):
    """Conv trunk emitting the feature map of each stage up to
    `max_stage` (NHWC); `dtype` is the compute dtype (parameters stay
    float32 and are cast at use)."""

    def __init__(self, max_stage: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 in_channels: int = 3):
        super().__init__()
        self.max_stage = max_stage
        self.dtype = dtype
        self.plan = []
        cin, idx = in_channels, 0
        for stage in VGG16_STAGES[:max_stage + 1]:
            items = []
            for item in stage:
                if item == "M":
                    items.append("M")
                    continue
                self.add_module(f"conv{idx}", nn.Conv2d(cin, item, 3,
                                                        padding=1))
                items.append(idx)
                cin, idx = item, idx + 1
            self.plan.append(tuple(items))

    def init_flax_default(self, generator: torch.Generator) -> None:
        """Flax `nn.Conv`'s default init from `generator`: kernels
        lecun_normal (variance 1 / fan_in, truncated at 2 sigma), biases
        zero."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                          2 * std, generator=generator)
                    nn.init.zeros_(m.bias)

    def load_params(self, tree: dict) -> None:
        """Load a JAX-layout tree (a Flax VGG16Features tree, or a
        `convert_vgg16_torch` export holding conv0..conv9): the convs of
        the stages built here are taken, the rest ignored, as Flax ignores
        the parameters a shallower trunk never reads."""
        from vfi_tpu_torch.utils.convert import params_from_jax

        sd = params_from_jax(tree)
        self.load_state_dict({k: sd[k] for k in self.state_dict()})

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        dt = self.dtype or x.dtype
        y = x.to(dt).permute(0, 3, 1, 2)
        feats = []
        for items in self.plan:
            for item in items:
                if item == "M":
                    y = F.max_pool2d(y, 2, 2)
                    continue
                conv = getattr(self, f"conv{item}")
                y = F.conv2d(y, conv.weight.to(dt), None, padding=1)
                y = torch.relu(y + conv.bias.to(dt)[:, None, None])
            feats.append(y.permute(0, 2, 3, 1))
        return feats
