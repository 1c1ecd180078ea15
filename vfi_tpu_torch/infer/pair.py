"""Frame-pair interpolation engine, port of `vfi_tpu/infer/pair.py`.

`FrameInterpolator.midpoints(f0, f1)` takes (B, H, W, 3) float32 frames in
[0, 1], ImageNet-normalizes them on the device, optionally pre-warps frame1
by the SimpleFlowNet flow prior, and runs EMAVFI, split into launches of at
most `max_px_per_launch` pixels. It runs on `cuda` unless the caller passes
`device="cpu"`; without a card and without that argument it raises.

Not ported yet (each raises when asked for): TTA, `auto_scale`,
`io_uint8`, `reference_compat`, mesh / spatial sharding, and the
`recursive` / `midpoints_sequence` entry points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vfi_tpu_torch.models.ema_vfi import EMAVFI
from vfi_tpu_torch.models.flownet import SimpleFlowNet
from vfi_tpu_torch.models.prior import prior_prewarp
from vfi_tpu_torch.utils.convert import infer_model_dims, params_from_jax

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names another device; raises when the
    named CUDA device is missing (no silent CPU route)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev


class FrameInterpolator:
    """Batched two-frame midpoint interpolator.

    `params` / `flow_params` are nested JAX-layout trees as
    `utils.convert.load_params_npz` returns them (the tracked
    `artifacts/*.npz` checkpoints); `fuse_project` and the model dims are
    read off the tree."""

    def __init__(self, params, in_channels: Optional[int] = None,
                 mid_channels: Optional[int] = None,
                 num_blocks: Optional[int] = None, bf16: bool = True,
                 dcn_max_offset: Optional[int] = None,
                 warp_max_flow: Optional[int] = None,
                 cascade_levels: int = 1,
                 flow_params=None,
                 flow_prior_scale: float = 0.5,
                 flow_mid_channels: int = 32,
                 flow_levels: int = 3,
                 max_px_per_launch="auto",
                 device=None,
                 use_kernels: bool = True,
                 tta: bool = False, io_uint8: bool = False,
                 auto_scale: Optional[float] = None, spatial: bool = False,
                 mesh=None, reference_compat: bool = False):
        for name, val in (("tta", tta), ("io_uint8", io_uint8),
                          ("auto_scale", auto_scale is not None),
                          ("spatial", spatial), ("mesh", mesh is not None),
                          ("reference_compat", reference_compat)):
            if val:
                raise NotImplementedError(f"{name} is not ported yet")
        self.device = resolve_device(device)
        if max_px_per_launch == "auto":
            max_px_per_launch = 8_000_000 if flow_params is None else 4_000_000
        self.max_px_per_launch = max_px_per_launch
        dims = infer_model_dims(params)
        dtype = torch.bfloat16 if bf16 else None
        self.model = EMAVFI(
            in_channels=in_channels or dims["in_channels"],
            mid_channels=mid_channels or dims["mid_channels"],
            num_blocks=num_blocks or dims["num_blocks"],
            dtype=dtype, dcn_max_offset=dcn_max_offset,
            warp_max_flow=warp_max_flow, cascade_levels=cascade_levels,
            fuse_project=dims["fuse_project"], use_kernels=use_kernels)
        self.model.load_state_dict(params_from_jax(params))
        self.model.to(self.device).eval()
        self.model.pack_kernel_weights()
        self.flow_module = None
        if flow_params is not None:
            self.flow_module = SimpleFlowNet(
                in_channels=self.model.in_channels,
                mid_channels=flow_mid_channels, levels=flow_levels,
                dtype=dtype)
            self.flow_module.load_state_dict(params_from_jax(flow_params))
            self.flow_module.to(self.device).eval()
        self.flow_prior_scale = flow_prior_scale
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)

    def _normalize(self, f: torch.Tensor) -> torch.Tensor:
        return (f - self._mean) / self._std

    @torch.inference_mode()
    def _forward(self, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
        n0, n1 = self._normalize(f0), self._normalize(f1)
        if self.flow_module is not None:
            n1, _ = prior_prewarp(self.flow_module, n0, n1,
                                  scale=self.flow_prior_scale)
        return self.model(n0, n1)

    def _to_device(self, f) -> torch.Tensor:
        return torch.as_tensor(f).to(self.device, torch.float32)

    def midpoints(self, f0, f1) -> torch.Tensor:
        """Midpoint of each pair: (B, H, W, 3) float32 [0, 1] arrays or
        tensors in, a (B, H, W, 3) float32 tensor on the device out."""
        b = f0.shape[0]
        if self.max_px_per_launch is not None and b > 1:
            px = f0.shape[1] * f0.shape[2]
            cap = max(1, self.max_px_per_launch // px)
            if b > cap:
                return torch.cat([self._midpoints_launch(f0[i:i + cap],
                                                         f1[i:i + cap])
                                  for i in range(0, b, cap)])
        return self._midpoints_launch(f0, f1)

    def _midpoints_launch(self, f0, f1) -> torch.Tensor:
        return self._forward(self._to_device(f0), self._to_device(f1))
