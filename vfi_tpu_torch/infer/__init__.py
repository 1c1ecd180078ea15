"""Inference engines of the port: the frame-pair engine, and the single-
and multi-clip video pipelines (`infer.video`, `infer.multi`, imported
on their own)."""

from vfi_tpu_torch.infer.pair import (FrameInterpolator,
                                      pick_interpolation_factor,
                                      resolve_device)

__all__ = ["FrameInterpolator", "pick_interpolation_factor",
           "resolve_device"]
