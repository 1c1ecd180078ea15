"""Frame-pair interpolation engine, port of `vfi_tpu/infer/pair.py`.

`FrameInterpolator.midpoints(f0, f1)` takes (B, H, W, 3) float32 frames in
[0, 1] (uint8 in [0, 255] with `io_uint8`), ImageNet-normalizes them on
the device, optionally pre-warps frame1 by the SimpleFlowNet flow prior,
and runs EMAVFI, split into launches of at most `max_px_per_launch`
pixels. `midpoints_sequence(frames)` does the same for every consecutive
pair of a sequence, shipping each frame to the device once;
`recursive(f0, f1, factor)` inserts `factor` frames per pair by repeated
bisection (`reference_compat`: the one midpoint repeated, as the reference
CLI writes it). `tta` averages four symmetry-transformed forwards;
`auto_scale` routes a call at half resolution when the flow estimator's
p95 motion exceeds the threshold. It runs on `cuda` unless the caller
passes `device="cpu"`; without a card and without that argument it
raises.

Data parallelism (`mesh`, `parallel.make_mesh`): one process splits each
launch's batch over the mesh's 'data' rows, one model replica a device
(the JAX engine's `shard_map` over 'data' with replicated params); a
batch the axis does not divide is padded with its last pair and sliced
back. Spatial sharding (`spatial=True`): the process is one rank of a
`torch.distributed` group (`spatial_group`, None: the default group) and
every rank calls `midpoints` with the same frames; the exact halo pipeline
(`parallel.spatial`) runs each rank's band of rows and the midpoints are
gathered on every rank. The JAX engine's other H-sharding, GSPMD on the
XLA ops without `use_pallas`, has no counterpart: `spatial=True` always
takes the halo pipeline, so it needs the bounded DCN and warp.

CUDA graphs: on a card, each launch of a fixed shape is captured once as
a `torch.cuda.CUDAGraph` and replayed after, so the host issues one graph
launch in place of the ~650 ops of the flow prior and the model. A
launch here is one guard chunk (or the body of `midpoints_sequence`):
its frames in the io dtype in static input buffers, then the conversion
to float32, the normalisation, the prior, the model (TTA's four forwards
and the half-size route of auto_scale included) and the midpoints in the
io dtype, copied out of the static output before the next replay can
overwrite it. A key (batch, H, W, io dtype, device, route and the backend
flags that pick cuDNN's and cuBLAS's kernels) runs eager on its first
launch, which warms the library plans and the resize matrices (a shape
seen once never pays for a capture). Its next launch made with no
profiler recording runs eager once more, in the thread that captures (a
capture cannot create that thread's cuDNN and cuBLAS handles), and is
captured; later launches replay: the same kernels in the same order, so
the midpoints equal the eager path's bit for bit. A capture that fails
leaves its key eager, with a warning. The graphs of an engine share one
memory pool and replay in turn on one stream; at most `GRAPH_KEYS` keys
are kept, the least recently used dropped. Routes the engine can see
cannot be captured run eager: the CPU, `spatial` (and so
`broadcast_inputs`), a mesh with more than one 'data' row, frames in
another dtype than the io dtype, a launch inside someone else's capture,
and the auto_scale probe (it reads its percentile on the host).
`graph_stats` counts the launches `captured`, `replayed` and run `eager`,
and the graphs `evicted`. The kernel wrappers count a kernel where they
launch it (`ops.cuda.launch_counts`): once an eager launch, twice a
captured one (its eager run, then its recording), never a replay, whose
kernels show only in a device trace.

Host spans (`utils.profiling.span`, recorded only under a profiler): a
call is `vfi.midpoints`; each guard chunk (and the body of
`midpoints_sequence`) a `vfi.launch`, holding its copies in
(`vfi.upload`, one a frame batch), the forward (`vfi.forward`: the
normalisation, the flow prior and the model's stage spans, or on a
replayed launch `vfi.replay`, the graph's launch, in which the stages
record no span) and the midpoints in the io dtype (`vfi.output`).
"""

from __future__ import annotations

import copy
import threading
import warnings
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from vfi_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from vfi_tpu_torch.models.ema_vfi import EMAVFI
from vfi_tpu_torch.models.flownet import SimpleFlowNet
from vfi_tpu_torch.models.prior import prior_prewarp
from vfi_tpu_torch.ops.resize import keep_matrices, resize_bilinear
from vfi_tpu_torch.parallel import comm
from vfi_tpu_torch.parallel.mesh import make_mesh, shard_batch
from vfi_tpu_torch.parallel.spatial import (build_spatial_forward,
                                            required_halo)
from vfi_tpu_torch.utils.convert import infer_model_dims, params_from_jax
from vfi_tpu_torch.utils.profiling import span

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


# Launch keys whose CUDA graphs an engine keeps. The serving batcher pads
# each launch to its bucket's launch size (`pad_to_max`, on by default), so
# a frame size takes one key, which its sequence route's full chunks
# share; unpadded, it sends every batch size from 1 to the guard's cap (4
# pairs at 720p with the flow prior), and 8 holds that range at two frame
# sizes. Past it the least recently used key is dropped. The graphs share one memory pool, so a
# kept key costs its static inputs and output (33 MB for 4 uint8 pairs at
# 720p) and the graph's own few MB, not a second copy of the activations.
GRAPH_KEYS = 8


def capture_flags() -> tuple:
    """The backend flags that decide which cuDNN and cuBLAS kernels a
    launch runs, which a CUDA graph freezes at its capture."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    return (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
            c.allow_tf32, c.benchmark, c.deterministic)


class _Graph:
    """One captured launch: the graph, its static input and output
    buffers and the resize matrices it reads (kept alive past their
    cache)."""
    __slots__ = ("graph", "in0", "in1", "out", "kept")


# A key whose capture failed: its launches run eager.
_NO_GRAPH = object()


def pick_interpolation_factor(src_fps: float, target_fps: Optional[float],
                              max_factor: int = 4) -> tuple[int, float]:
    """The reference CLI's factor selection: with no target, the f in
    [1, max_factor] that brings src_fps * (f + 1) closest to 60 (a tie
    keeps the smaller f: 24 fps gives 1); with a target, round(target /
    src - 1) clamped to [1, max_factor]. Returns (factor, output fps =
    src_fps * (factor + 1))."""
    if target_fps is None:
        best_f, best_err = 1, float("inf")
        for f in range(1, max_factor + 1):
            err = abs(src_fps * (f + 1) - 60.0)
            if err < best_err:
                best_f, best_err = f, err
        factor = best_f
    else:
        factor = int(round(target_fps / src_fps - 1))
        factor = max(1, min(factor, max_factor))
    return factor, src_fps * (factor + 1)


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
    (`models.ema_vfi.EMAVFI`). `bf16=True` runs the model in bf16 (the
    kernels' bf16 instances on the card), `bf16=False` in float32 (their
    float32 instances; the engine leaves `torch.backends`' TF32 flags as
    the caller set them, which reach only the cuDNN convs outside the
    kernels).

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
    0.5, 0, 255) in uint8. Not with auto_scale, as in the JAX engine.

    `reference_compat=True` makes `recursive` repeat the one midpoint
    `factor` times, as the reference CLI does.

    `mesh` (a `parallel.Mesh`): the devices of the data-parallel replicas,
    one a 'data' row (its first device); the midpoints come back on the
    first. Default: every visible card when `device` is None or "cuda"
    without an index (as the JAX engine's default mesh), else `device`
    alone. A mesh may name one device more than once (replicas that take
    turns on one card); chunks of the `max_px_per_launch` guard and the
    auto_scale probe stay divisible by the 'data' axis.

    `spatial=True` (with `spatial_group`): see the module docstring; not
    with the flow prior, `io_uint8` or TTA, as in the JAX engine. Heights
    are edge-padded to a multiple of 8 * the group's size and cropped
    back. `data_group` (the ranks that share this rank's place in their
    spatial groups, one a group) adds the 'data' axis: the batch, padded
    to a multiple of its size, splits over the spatial groups and the
    shares are gathered. `broadcast_inputs=True` lets the default group's
    rank 0 alone call `midpoints` (and what calls it): the frames reach
    every other rank by `broadcast`, which serve rank 0's calls in
    `follow()` until it calls `release()`.

    On a card, launches of a shape seen before replay a CUDA graph (see
    the module docstring); `graph_stats` counts them."""

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
                 mesh=None, reference_compat: bool = False,
                 spatial_group=None, broadcast_inputs: bool = False,
                 data_group=None):
        if flow_params is not None and spatial:
            raise ValueError("flow-prior inference is not supported with "
                             "spatial sharding (global pyramid flow)")
        if io_uint8 and spatial:
            raise ValueError("io_uint8 is not supported with spatial "
                             "sharding (the halo pipeline is float-typed)")
        if tta and spatial:
            raise ValueError("tta is not supported with spatial sharding")
        if auto_scale is not None and flow_params is None:
            raise ValueError("auto_scale needs flow_params (the flow "
                             "estimator provides the motion-magnitude probe)")
        if auto_scale is not None and io_uint8:
            raise ValueError("auto_scale is not supported with io_uint8")
        self.reference_compat = reference_compat
        self.io_uint8 = io_uint8
        self.io_dtype = np.uint8 if io_uint8 else np.float32
        self.device = resolve_device(
            mesh.data_devices[0] if device is None and mesh is not None
            else device)
        if spatial:
            if mesh is not None:
                raise ValueError("spatial=True shards over spatial_group's "
                                 "ranks; pass no mesh")
            if not torch.distributed.is_initialized():
                raise RuntimeError("spatial=True needs a torch.distributed "
                                   "process group (init_process_group)")
            required_halo(num_blocks or infer_model_dims(params)[
                "num_blocks"], dcn_max_offset, warp_max_flow)
        elif broadcast_inputs or data_group is not None:
            raise ValueError("broadcast_inputs and data_group need "
                             "spatial=True")
        if mesh is None:
            whole = self.device.type == "cuda" and self.device.index is None
            mesh = make_mesh(devices=None if whole else [self.device])
        elif device is not None and torch.device(device) != \
                mesh.data_devices[0]:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh.data_devices[0]}")
        self.mesh = mesh
        self.device = mesh.data_devices[0]
        for dev in mesh.data_devices:
            resolve_device(dev)
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
        # One (model, flow module) replica a further device of the 'data'
        # axis, sharing nothing with the first but the weights' values.
        self._replicas = {self.device: (self.model, self.flow_module)}
        for dev in mesh.data_devices:
            if dev not in self._replicas:
                model = copy.deepcopy(self.model).to(dev)
                model.pack_kernel_weights()
                flow = (None if self.flow_module is None
                        else copy.deepcopy(self.flow_module).to(dev))
                self._replicas[dev] = (model, flow)
        self.spatial = spatial
        self.spatial_group = spatial_group
        self.data_group = data_group
        self.broadcast_inputs = broadcast_inputs
        # The 'data' axis: the mesh's rows, or in spatial mode the ranks
        # of data_group (one a spatial group).
        self._n_data = (mesh.shape["data"] if not spatial else
                        1 if data_group is None else comm.size(data_group))
        self._spatial_fwd_cache: dict = {}
        self.graph_stats = {"captured": 0, "replayed": 0, "eager": 0,
                            "evicted": 0}
        # launch key -> its _Graph, None once it has run eager, or
        # _NO_GRAPH; least recently used first
        self._graphs: OrderedDict = OrderedDict()
        self._graph_pool = None
        self._graph_lock = threading.Lock()

    def _normalize(self, f: torch.Tensor) -> torch.Tensor:
        if f.device != self._mean.device:
            return (f - self._mean.to(f.device)) / self._std.to(f.device)
        return (f - self._mean) / self._std

    def _single(self, f0: torch.Tensor, f1: torch.Tensor,
                replica=None) -> torch.Tensor:
        model, flow = replica or (self.model, self.flow_module)
        with span("vfi.normalize"):
            n0, n1 = self._normalize(f0), self._normalize(f1)
        if flow is not None:
            with span("vfi.prior"):
                n1, _ = prior_prewarp(flow, n0, n1,
                                      scale=self.flow_prior_scale)
        return model(n0, n1)

    def _forward_one(self, f0, f1, replica=None) -> torch.Tensor:
        if not self.tta:
            return self._single(f0, f1, replica)
        outs = [inv(self._single(*tf(f0, f1), replica)).float()
                for tf, inv in TTA_SYMMETRIES]
        return torch.stack(outs).mean(dim=0)

    def _forward(self, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
        """The forward of a batch the 'data' axis divides: each row's
        share on its replica's device, the midpoints back on the first."""
        with span("vfi.forward"):
            if self.mesh.shape["data"] == 1:
                return self._forward_one(f0, f1)
            outs = [self._forward_one(a, b, self._replicas[a.device])
                    for a, b in shard_batch((f0, f1), self.mesh)]
            return torch.cat([o.to(self.device) for o in outs])

    def _spatial_fwd(self, global_h: int):
        """The halo pipeline's forward for one padded height, built once."""
        fn = self._spatial_fwd_cache.get(global_h)
        if fn is None:
            fn = build_spatial_forward(self.model, global_h,
                                       preprocess=self._normalize,
                                       group=self.spatial_group)
            self._spatial_fwd_cache[global_h] = fn
        return fn

    def _spatial_launch(self, f0: torch.Tensor, f1: torch.Tensor
                        ) -> torch.Tensor:
        """The batch through the halo pipeline: H edge-padded to a
        multiple of 8 * ranks (the stride-4 grid and 8-row slabs), this
        rank's band, the midpoint gathered and cropped. Rows further than
        the halo from the padded edge are exact; the last ones see a
        displaced frame edge. With `data_group` this spatial group runs
        its share of the (padded) batch and the shares are gathered."""
        with span("vfi.forward"):
            if self.data_group is not None:
                k = f0.shape[0] // self._n_data
                i = comm.rank(self.data_group) * k
                out = self._spatial_band(f0[i:i + k], f1[i:i + k])
                return comm.all_gather_rows(out, self.data_group, dim=0)
            return self._spatial_band(f0, f1)

    def _spatial_band(self, f0: torch.Tensor, f1: torch.Tensor
                      ) -> torch.Tensor:
        h, n = f0.shape[1], comm.size(self.spatial_group)
        hpad = (-h) % (8 * n)
        if hpad:
            f0, f1 = (torch.cat([x, x[:, -1:].expand(-1, hpad, -1, -1)],
                                dim=1) for x in (f0, f1))
        fn = self._spatial_fwd(h + hpad)
        s = comm.rank(self.spatial_group) * fn.h_local
        out = comm.all_gather_rows(fn(f0[:, s:s + fn.h_local],
                                      f1[:, s:s + fn.h_local]),
                                   self.spatial_group)
        return out[:, :h] if hpad else out

    def _to_device(self, f) -> torch.Tensor:
        """Frames in the io dtype -> float32 [0, 1] on the device; uint8
        frames go up as they are and convert there."""
        with span("vfi.upload"):
            if self.io_uint8:
                return self._to_float(torch.as_tensor(f).to(self.device))
            return torch.as_tensor(f).to(self.device, torch.float32)

    def _to_float(self, x: torch.Tensor) -> torch.Tensor:
        """Frames in the io dtype on the device -> float32 [0, 1]."""
        return x.float() / 255.0 if self.io_uint8 else x

    def _from_forward(self, out: torch.Tensor) -> torch.Tensor:
        """The forward's [0, 1] midpoints in the io dtype."""
        if not self.io_uint8:
            return out
        return torch.clamp(out.float() * 255.0 + 0.5, 0.0, 255.0).to(
            torch.uint8)

    def _guard_cap(self, f0) -> Optional[int]:
        """Pairs per launch under `max_px_per_launch` (None: no guard),
        a multiple of the 'data' axis."""
        if self.max_px_per_launch is None:
            return None
        d = self._n_data
        cap = max(1, self.max_px_per_launch // (f0.shape[1] * f0.shape[2]))
        return max(d, cap // d * d)

    def midpoints(self, f0, f1) -> torch.Tensor:
        """Midpoint of each pair: (B, H, W, 3) arrays or tensors in the io
        dtype in, a (B, H, W, 3) tensor in the io dtype on the device
        out."""
        with span("vfi.midpoints"):
            if self.broadcast_inputs:
                if comm.rank() != 0:
                    raise RuntimeError("with broadcast_inputs only rank 0 "
                                       "calls midpoints; the others "
                                       "follow()")
                head = torch.tensor([1, *f0.shape[:3]], device=self.device)
                torch.distributed.broadcast(head, 0)
                f0, f1 = (self._to_device(x).contiguous() for x in (f0, f1))
                for x in (f0, f1):
                    torch.distributed.broadcast(x, 0)
            return self._midpoints(f0, f1)

    def follow(self) -> int:
        """On a rank other than 0 under `broadcast_inputs`: take part in
        each of rank 0's `midpoints` calls until it calls `release()`;
        returns the count of calls served."""
        served = 0
        while True:
            head = torch.zeros(4, dtype=torch.long, device=self.device)
            torch.distributed.broadcast(head, 0)
            if int(head[0]) == 0:
                return served
            f0, f1 = (torch.empty(*head[1:].tolist(), 3,
                                  device=self.device) for _ in range(2))
            for x in (f0, f1):
                torch.distributed.broadcast(x, 0)
            self._midpoints(f0, f1)
            served += 1

    def release(self) -> None:
        """Rank 0 under `broadcast_inputs`: end the other ranks'
        `follow()`."""
        head = torch.zeros(4, dtype=torch.long, device=self.device)
        torch.distributed.broadcast(head, 0)

    def _midpoints(self, f0, f1) -> torch.Tensor:
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
        if (self.auto_scale is not None or self.spatial
                or self.mesh.shape["data"] > 1):
            # the probe decides per call over the pairs, and the routed
            # modes pad and split, as in midpoints
            return self.midpoints(frames[:-1], frames[1:])
        with span("vfi.launch"):
            key = self._graph_key(frames[:-1])
            if key is None:
                fr = self._to_device(frames)
            else:
                # each frame up once; the pairs are copied on the device
                # into the graph's inputs
                with span("vfi.upload"):
                    raw = torch.as_tensor(frames).to(self.device)
                out = self._replay(key, raw[:-1], raw[1:])
                if out is not None:
                    return out
                with span("vfi.upload"):
                    fr = self._to_float(raw)
            self.graph_stats["eager"] += 1
            return self._launch_body(fr[:-1], fr[1:], False)

    @torch.inference_mode()
    def _flow_p95(self, f0: torch.Tensor, f1: torch.Tensor) -> float:
        """95th percentile (linear interpolation, `jnp.percentile`'s
        default) of the flow estimator's motion magnitude over the pairs."""
        with span("vfi.normalize"):
            n0, n1 = self._normalize(f0), self._normalize(f1)
        with span("vfi.prior"):
            fl = self.flow_module(n0, n1)
            mag = torch.sqrt(fl[..., 0].square() + fl[..., 1].square())
            return percentile_linear(mag, 95.0)

    def _probe_scaled(self, f0, f1) -> bool:
        """One auto_scale probe on at most the first guard chunk's pairs:
        True routes the whole call at half resolution."""
        cap = self._guard_cap(f0)
        if cap is not None:
            f0, f1 = f0[:cap], f1[:cap]
        f0, f1 = self._pad_batch(self._to_device(f0), self._to_device(f1))
        p95 = self._flow_p95(f0, f1)
        self.auto_scale_stats["probes"].append(p95)
        if p95 > self.auto_scale:
            self.auto_scale_stats["scaled"] += 1
            return True
        return False

    def _pad_batch(self, f0: torch.Tensor, f1: torch.Tensor) -> tuple:
        """Pad the batch to a multiple of the 'data' axis with its last
        pair."""
        pad = (-f0.shape[0]) % self._n_data
        if pad:
            f0, f1 = (torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
                      for x in (f0, f1))
        return f0, f1

    @torch.inference_mode()
    def _midpoints_launch(self, f0, f1, scaled: bool = False
                          ) -> torch.Tensor:
        with span("vfi.launch"):
            key = self._graph_key(f0, scaled)
            if key is not None:
                out = self._replay(key, f0, f1)
                if out is not None:
                    return out
            self.graph_stats["eager"] += 1
            b = f0.shape[0]
            f0, f1 = self._pad_batch(self._to_device(f0),
                                     self._to_device(f1))
            return self._launch_body(f0, f1, scaled)[:b]

    def _launch_body(self, f0: torch.Tensor, f1: torch.Tensor,
                     scaled: bool) -> torch.Tensor:
        """A launch's work on the device, from float32 [0, 1] frames (the
        batch padded to the 'data' axis) to its midpoints in the io dtype
        (float32 on the half-size route)."""
        h, w = f0.shape[1], f0.shape[2]
        if self.spatial:
            out = self._spatial_launch(f0, f1)
        elif not scaled:
            out = self._forward(f0, f1)
        else:
            # Large motion: halve the resolution (halves the apparent
            # flow, back inside the trunk's receptive field) and resize
            # the midpoints back to the native size.
            half = (h // 2, w // 2)
            out = self._forward(resize_bilinear(f0, half),
                                resize_bilinear(f1, half))
        with span("vfi.output"):
            return (resize_bilinear(out, (h, w)) if scaled
                    else self._from_forward(out))

    def _graph_key(self, f0, scaled: bool = False) -> Optional[tuple]:
        """The CUDA-graph key of a launch on the pairs `f0` (and their
        partners, of the same shape), or None for a route that runs eager
        (see the module docstring)."""
        if (self.device.type != "cuda" or self.spatial or self._n_data > 1
                or torch.cuda.is_current_stream_capturing()):
            return None
        t = torch.as_tensor(f0)
        if t.dtype != (torch.uint8 if self.io_uint8 else torch.float32):
            return None
        return (tuple(t.shape), t.dtype, self.device, scaled,
                capture_flags())

    def _replay(self, key: tuple, f0, f1) -> Optional[torch.Tensor]:
        """The launch through the key's CUDA graph, or None where this
        launch runs eager: the key's first launch, any launch while a
        profiler records (a capture is never profiled) and a key whose
        capture failed. The key's next launch is captured (`_capture`);
        later ones copy their frames into the graph's inputs, replay it
        and return a copy of its output."""
        with self._graph_lock:
            g = self._graphs.get(key, False)
            if (g is False or g is _NO_GRAPH
                    or (g is None and torch.autograd._profiler_enabled())):
                self._keep_graph(key, g or None)
                return None
            if g is None:
                out, g = self._capture(key, f0, f1)
                self._keep_graph(key, g)
                self.graph_stats["eager" if g is _NO_GRAPH
                                 else "captured"] += 1
                return out
            self._graphs.move_to_end(key)
            with span("vfi.upload"):
                g.in0.copy_(torch.as_tensor(f0))
            with span("vfi.upload"):
                g.in1.copy_(torch.as_tensor(f1))
            with span("vfi.forward"), span("vfi.replay"):
                g.graph.replay()
            self.graph_stats["replayed"] += 1
            with span("vfi.output"):
                return g.out.clone()

    def _capture(self, key: tuple, f0, f1) -> tuple:
        """The key's launch on these pairs, run eager in this thread
        (which makes this thread's cuDNN and cuBLAS handles: a capture
        cannot), then captured into a graph of the engine's pool. Returns
        the eager midpoints and the graph, or `_NO_GRAPH` where the
        capture failed: a warning says why, the key runs eager from then
        on, and the next capture takes a new pool (a failed capture
        leaves its pool recording)."""
        g = _Graph()
        g.in0, g.in1 = (torch.empty(key[0], dtype=key[1], device=self.device
                                    ).copy_(torch.as_tensor(x))
                        for x in (f0, f1))
        out = self._launch_body(self._to_float(g.in0), self._to_float(g.in1),
                                key[3])
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        g.graph = torch.cuda.CUDAGraph()
        try:
            with keep_matrices() as g.kept, torch.cuda.device(self.device), \
                    torch.cuda.graph(g.graph, pool=self._graph_pool,
                                     capture_error_mode="thread_local"):
                g.out = self._launch_body(self._to_float(g.in0),
                                          self._to_float(g.in1), key[3])
        except RuntimeError as e:
            warnings.warn(f"CUDA graph capture of the launch {key[:2]} "
                          f"failed; it runs eager: {e}")
            self._graph_pool = None
            g = _NO_GRAPH
        return out, g

    def _keep_graph(self, key: tuple, g) -> None:
        """Record the key (most recently used), dropping the least
        recently used past `GRAPH_KEYS`."""
        self._graphs[key] = g
        self._graphs.move_to_end(key)
        while len(self._graphs) > GRAPH_KEYS:
            _, old = self._graphs.popitem(last=False)
            if isinstance(old, _Graph):
                self.graph_stats["evicted"] += 1

    def recursive(self, f0, f1, factor: int) -> list:
        """`factor` frames between each pair, as a list of `midpoints`
        results. For factor = 2^k - 1 this is recursive bisection (3: the
        midpoint, then the quarter points); other factors take the next
        level and drop the extras uniformly. With `reference_compat` the
        one midpoint is repeated `factor` times.

        Each level's midpoints feed the next as the tensors they are (in
        the io dtype), with no trip through the host. Touches only
        `self.midpoints` and `self.reference_compat`, so the multi-clip
        engine (`infer.multi.SharedEngine`) borrows it as it is."""
        if factor < 1:
            return []
        mid = self.midpoints(f0, f1)
        if factor == 1:
            return [mid]
        if self.reference_compat:
            return [mid] * factor
        left = self.recursive(f0, mid, factor // 2)
        right = self.recursive(mid, f1, factor // 2)
        frames = left + [mid] + right
        if len(frames) > factor:    # an even factor: drop extras uniformly
            keep = np.linspace(0, len(frames) - 1, factor).round().astype(int)
            frames = [frames[i] for i in keep]
        return frames
