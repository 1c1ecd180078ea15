"""Inference engines of the port."""

from vfi_tpu_torch.infer.pair import FrameInterpolator, resolve_device

__all__ = ["FrameInterpolator", "resolve_device"]
