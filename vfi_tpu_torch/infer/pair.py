"""Frame-pair interpolation engine, port of `vfi_tpu/infer/pair.py`.

`FrameInterpolator.midpoints(f0, f1)` takes (B, H, W, 3) float32 frames in
[0, 1] (uint8 in [0, 255] with `io_uint8`), ImageNet-normalizes them on
the device, optionally pre-warps frame1 by the SimpleFlowNet flow prior,
and runs EMAVFI, split into launches of at most `max_px_per_launch`
pixels. `midpoints_sequence(frames)` does the same for every consecutive
pair of a sequence, shipping each frame to the device once. `tta`
averages four symmetry-transformed forwards; `auto_scale` routes a call at
half resolution when the flow estimator's p95 motion exceeds the
threshold. It runs on `cuda` unless the caller passes `device="cpu"`;
without a card and without that argument it raises.

Not ported yet (each raises when asked for): `reference_compat`, mesh /
spatial sharding, and the `recursive` entry point.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vfi_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from vfi_tpu_torch.models.ema_vfi import EMAVFI
from vfi_tpu_torch.models.flownet import SimpleFlowNet
from vfi_tpu_torch.models.prior import prior_prewarp
from vfi_tpu_torch.ops.resize import resize_bilinear
from vfi_tpu_torch.utils.convert import infer_model_dims, params_from_jax

# TTA's (transform, inverse) pairs on NHWC [0, 1] frames: identity,
# horizontal flip, vertical flip, temporal swap (the midpoint of (f1, f0)
# is the midpoint of (f0, f1)). Flips commute with the per-channel
# normalization, so they apply to the raw frames.
TTA_SYMMETRIES = (
    (lambda a, b: (a, b), lambda o: o),
    (lambda a, b: (a.flip(2), b.flip(2)), lambda o: o.flip(2)),
    (lambda a, b: (a.flip(1), b.flip(1)), lambda o: o.flip(1)),
    (lambda a, b: (b, a), lambda o: o),
)


def percentile_linear(x: torch.Tensor, q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of all of x's elements by
    linear interpolation between the two nearest ranks, the default method
    of `jnp.percentile` (the reference's `p95_flow`) and
    `numpy.percentile`: for n sorted values v and the rank r = q / 100 *
    (n - 1), v[floor(r)] * (1 - frac(r)) + v[ceil(r)] * frac(r), with the
    rank, weights and sum in float32 as `jnp.percentile` computes them.
    The two values come from `torch.kthvalue`, so any element count is
    taken (`torch.quantile` refuses more than 2^24)."""
    v = x.detach().flatten().float()
    n = v.numel()
    if n == 0:
        raise ValueError("percentile of an empty tensor")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must lie in [0, 100], got {q}")
    f32 = np.float32
    r = f32(q) / f32(100.0) * (f32(n) - f32(1.0))
    hw = r - np.floor(r)
    lo = min(int(np.floor(r)), n - 1)
    hi = min(int(np.ceil(r)), n - 1)
    a = f32(v.kthvalue(lo + 1).values.item())
    b = a if hi == lo else f32(v.kthvalue(hi + 1).values.item())
    return float(a * (f32(1.0) - hw) + b * hw)


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
    read off the tree. `conv_kernel` is the model's
    (`models.ema_vfi.EMAVFI`).

    `tta=True` averages, in float32, the midpoints of four transformed
    pairs (`TTA_SYMMETRIES`), each transformed back; the "auto" pixel
    budget halves. `auto_scale=<pixels>` (needs `flow_params`) probes each
    `midpoints` call once, on its first guard chunk: when the 95th
    percentile of the flow estimator's motion magnitude exceeds the
    threshold, the whole call runs on frames resized to half and the
    midpoints are resized back. `auto_scale_stats` records every probe and
    the count of calls routed at half resolution.

    `io_uint8=True` takes and returns uint8 [0, 255] frames (`io_dtype`):
    they go to the device as they are, a quarter of the float32 bytes,
    and convert there (`/ 255`); the midpoints come back as clip(x * 255 +
    0.5, 0, 255) in uint8. Not with auto_scale, as in the JAX engine."""

    def __init__(self, params, in_channels: Optional[int] = None,
                 mid_channels: Optional[int] = None,
                 num_blocks: Optional[int] = None, bf16: bool = True,
                 dcn_max_offset: Optional[int] = None,
                 warp_max_flow: Optional[int] = None,
                 conv_kernel: str = "xla",
                 cascade_levels: int = 1,
                 flow_params=None,
                 flow_prior_scale: float = 0.5,
                 flow_mid_channels: int = 32,
                 flow_levels: int = 3,
                 tta: bool = False,
                 auto_scale: Optional[float] = None,
                 max_px_per_launch="auto",
                 device=None,
                 use_kernels: bool = True,
                 io_uint8: bool = False, spatial: bool = False,
                 mesh=None, reference_compat: bool = False):
        for name, val in (("spatial", spatial),
                          ("mesh", mesh is not None),
                          ("reference_compat", reference_compat)):
            if val:
                raise NotImplementedError(f"{name} is not ported yet")
        if auto_scale is not None and flow_params is None:
            raise ValueError("auto_scale needs flow_params (the flow "
                             "estimator provides the motion-magnitude probe)")
        if auto_scale is not None and io_uint8:
            raise ValueError("auto_scale is not supported with io_uint8")
        self.io_uint8 = io_uint8
        self.io_dtype = np.uint8 if io_uint8 else np.float32
        self.device = resolve_device(device)
        if self.device.type == "cuda" and use_kernels and not bf16:
            raise ValueError("the CUDA kernels run in bfloat16 only; float32 "
                             "kernels are not ported yet (use bf16=True, or "
                             "device='cpu' for the float32 plain path)")
        if max_px_per_launch == "auto":
            max_px_per_launch = 8_000_000 if flow_params is None else 4_000_000
            if tta:
                max_px_per_launch //= 2
        self.max_px_per_launch = max_px_per_launch
        self.tta = tta
        self.auto_scale = auto_scale
        self.auto_scale_stats = {"probes": [], "scaled": 0}
        dims = infer_model_dims(params)
        dtype = torch.bfloat16 if bf16 else None
        self.model = EMAVFI(
            in_channels=in_channels or dims["in_channels"],
            mid_channels=mid_channels or dims["mid_channels"],
            num_blocks=num_blocks or dims["num_blocks"],
            dtype=dtype, dcn_max_offset=dcn_max_offset,
            warp_max_flow=warp_max_flow, cascade_levels=cascade_levels,
            fuse_project=dims["fuse_project"], conv_kernel=conv_kernel,
            use_kernels=use_kernels)
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

    def _single(self, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
        n0, n1 = self._normalize(f0), self._normalize(f1)
        if self.flow_module is not None:
            n1, _ = prior_prewarp(self.flow_module, n0, n1,
                                  scale=self.flow_prior_scale)
        return self.model(n0, n1)

    def _forward(self, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
        if not self.tta:
            return self._single(f0, f1)
        outs = [inv(self._single(*tf(f0, f1))).float()
                for tf, inv in TTA_SYMMETRIES]
        return torch.stack(outs).mean(dim=0)

    def _to_device(self, f) -> torch.Tensor:
        """Frames in the io dtype -> float32 [0, 1] on the device; uint8
        frames go up as they are and convert there."""
        if self.io_uint8:
            return torch.as_tensor(f).to(self.device).float() / 255.0
        return torch.as_tensor(f).to(self.device, torch.float32)

    def _from_forward(self, out: torch.Tensor) -> torch.Tensor:
        """The forward's [0, 1] midpoints in the io dtype."""
        if not self.io_uint8:
            return out
        return torch.clamp(out.float() * 255.0 + 0.5, 0.0, 255.0).to(
            torch.uint8)

    def _guard_cap(self, f0) -> Optional[int]:
        """Pairs per launch under `max_px_per_launch` (None: no guard)."""
        if self.max_px_per_launch is None:
            return None
        return max(1, self.max_px_per_launch // (f0.shape[1] * f0.shape[2]))

    def midpoints(self, f0, f1) -> torch.Tensor:
        """Midpoint of each pair: (B, H, W, 3) arrays or tensors in the io
        dtype in, a (B, H, W, 3) tensor in the io dtype on the device
        out."""
        b = f0.shape[0]
        # auto_scale decides once per call, so every guard chunk of one
        # batch takes the same route.
        scaled = (self._probe_scaled(f0, f1)
                  if self.auto_scale is not None else False)
        cap = self._guard_cap(f0)
        if cap is not None and b > cap:
            return torch.cat([self._midpoints_launch(f0[i:i + cap],
                                                     f1[i:i + cap], scaled)
                              for i in range(0, b, cap)])
        return self._midpoints_launch(f0, f1, scaled)

    @torch.inference_mode()
    def midpoints_sequence(self, frames) -> torch.Tensor:
        """Midpoints of every consecutive pair of an (N+1, H, W, 3)
        sequence in the io dtype -> (N, H, W, 3) on the device, the same
        numbers as `midpoints(frames[:-1], frames[1:])`. Each frame goes
        to the device once and the pairs are sliced there (the pair route
        ships every interior frame twice). Past the pixel budget the
        frames go in chunks of `cap` frames that overlap by one; when one
        pair alone exceeds it, through `midpoints`, whose guard splits by
        pairs (chunking by frames cannot shrink below two, and recursing
        on a two-frame chunk never ends)."""
        n1 = frames.shape[0]
        if n1 < 2:
            raise ValueError("midpoints_sequence needs >= 2 frames")
        px = frames.shape[1] * frames.shape[2]
        if (self.max_px_per_launch is not None
                and n1 * px > self.max_px_per_launch):
            if 2 * px > self.max_px_per_launch:
                return self.midpoints(frames[:-1], frames[1:])
            cap = max(2, self.max_px_per_launch // px)
            return torch.cat([self.midpoints_sequence(frames[i:i + cap])
                              for i in range(0, n1 - 1, cap - 1)])
        if self.auto_scale is not None:
            # the probe decides per call over the pairs, as in midpoints
            return self.midpoints(frames[:-1], frames[1:])
        fr = self._to_device(frames)
        return self._from_forward(self._forward(fr[:-1], fr[1:]))

    @torch.inference_mode()
    def _flow_p95(self, f0: torch.Tensor, f1: torch.Tensor) -> float:
        """95th percentile (linear interpolation, `jnp.percentile`'s
        default) of the flow estimator's motion magnitude over the pairs."""
        fl = self.flow_module(self._normalize(f0), self._normalize(f1))
        mag = torch.sqrt(fl[..., 0].square() + fl[..., 1].square())
        return percentile_linear(mag, 95.0)

    def _probe_scaled(self, f0, f1) -> bool:
        """One auto_scale probe on at most the first guard chunk's pairs:
        True routes the whole call at half resolution."""
        cap = self._guard_cap(f0)
        if cap is not None:
            f0, f1 = f0[:cap], f1[:cap]
        p95 = self._flow_p95(self._to_device(f0), self._to_device(f1))
        self.auto_scale_stats["probes"].append(p95)
        if p95 > self.auto_scale:
            self.auto_scale_stats["scaled"] += 1
            return True
        return False

    @torch.inference_mode()
    def _midpoints_launch(self, f0, f1, scaled: bool = False
                          ) -> torch.Tensor:
        f0, f1 = self._to_device(f0), self._to_device(f1)
        if not scaled:
            return self._from_forward(self._forward(f0, f1))
        # Large motion: halve the resolution (halves the apparent flow,
        # back inside the trunk's receptive field) and resize the
        # midpoints back to the native size.
        h, w = f0.shape[1], f0.shape[2]
        half = (h // 2, w // 2)
        out = self._forward(resize_bilinear(f0, half),
                            resize_bilinear(f1, half))
        return resize_bilinear(out, (h, w))
