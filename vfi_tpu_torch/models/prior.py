"""Flow-prior pre-warp (port of `vfi_tpu/models/prior.py`): pre-align
frame1 halfway toward frame0 along SimpleFlowNet's flow, with the exact
unbounded warp, before the main model."""

from __future__ import annotations

from typing import Callable

import torch

from vfi_tpu_torch.ops.warp import warp


def prior_prewarp(flow_apply: Callable, frame0: torch.Tensor,
                  frame1: torch.Tensor, scale: float = 0.5
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (prewarped frame1, flow01); `flow_apply(frame0, frame1)`
    gives flow with warp(frame1, flow) ~ frame0."""
    flow01 = flow_apply(frame0, frame1)
    prior = (flow01 * scale).to(frame1.dtype)
    return warp(frame1, prior), flow01
