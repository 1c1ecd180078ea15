"""Exact spatial (H) sharding with a halo exchange, the counterpart of
`vfi_tpu/parallel/spatial.py`, over a `torch.distributed` group: one
process a rank, each rank a horizontal band of the frame.

1. One halo exchange per frame of the pair (`comm.exchange_halo`): each
   rank gets its neighbours' boundary rows, building an (H_local + 2 *
   halo)-row slab; beyond the first and last rank the rows are zeros
   (outside the image).
2. The whole model forward runs on the slab, the CUDA kernels included at
   the slab's shape. The model's spatial mode (`EMAVFI.with_spatial`)
   masks rows outside the image after every row-mixing layer, sums the
   context pool over the ranks' owned rows, and runs the cascade's coarse
   pass on the gathered global pair.
3. The rank keeps the center H_local rows.

A row's result differs from the one-device forward only within the
network's receptive field of the slab's edges; `required_halo` bounds
that field layer by layer, so with at least that halo every owned row is
the one-device result up to float summation order. That needs the bounded
sampling configuration: an unbounded warp or DCN can read any row.
"""

from __future__ import annotations

from typing import Optional

import torch

from vfi_tpu_torch.parallel import comm


def required_halo(num_blocks: int = 3, dcn_max_offset: Optional[int] = 2,
                  warp_max_flow: Optional[int] = 16) -> int:
    """Rows of halo an exact spatially sharded forward needs: the
    receptive field toward the slab's edge, stage by stage (feature
    extraction 1 + num_blocks 3x3 convs; motion +3; the warp's reach
    warp_max_flow + 1, taken as max with the flow's depth; each DCN
    dcn_max_offset + 2; reconstruction +3), rounded up to a multiple of 8
    (which also meets the context encoder's stride-4 alignment)."""
    if dcn_max_offset is None or warp_max_flow is None:
        raise ValueError(
            "spatial sharding requires the bounded sampling configuration "
            "(dcn_max_offset / warp_max_flow set): unbounded warp/DCN can "
            "read any row of the frame, so no finite halo is exact")
    d = 1 + num_blocks
    d += 3
    d = max(d, warp_max_flow + 1)
    d += num_blocks * (dcn_max_offset + 2)
    d += 3
    return -(-d // 8) * 8


def build_spatial_forward(model, global_h: int, halo: Optional[int] = None,
                          preprocess=None, group=None):
    """The spatially sharded forward of `model` (an EMAVFI; its bounded
    sampling settings set the halo) for frames of `global_h` rows over
    `group`'s ranks. Returns `fn(f0_local, f1_local) -> out_local`: each
    rank passes its own H_local = global_h / size rows (rank order down
    the frame), on its device, and gets its H_local rows of the midpoint.
    `preprocess` (e.g. the ImageNet normalization) applies to each local
    band before the exchange. global_h must divide by 4 * size (the
    context encoder's stride-4 grid), the halo by 4, and the halo may not
    exceed H_local."""
    if halo is None:
        halo = required_halo(model.num_blocks,
                             model.fusion_dcn0.max_offset,
                             model.warp_max_flow)
    n = comm.size(group)
    if global_h % (4 * n) != 0:
        raise ValueError(
            f"H={global_h} must divide by 4*spatial={4 * n} (strided "
            "context-encoder grid alignment); pad the frames")
    h_local = global_h // n
    if halo % 4 != 0:
        raise ValueError(f"halo={halo} must be a multiple of 4")
    if halo > h_local:
        raise ValueError(
            f"halo={halo} exceeds the per-shard rows {h_local}: use fewer "
            "'spatial' shards for this resolution")
    spatial_model = model.with_spatial(group, halo, global_h)

    def fn(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
        if f0.shape[1] != h_local or f1.shape[1] != h_local:
            raise ValueError(f"each rank passes its {h_local} rows, got "
                             f"{f0.shape[1]} and {f1.shape[1]}")
        if preprocess is not None:
            f0, f1 = preprocess(f0), preprocess(f1)
        f0 = comm.exchange_halo(f0, halo, group)
        f1 = comm.exchange_halo(f1, halo, group)
        return spatial_model(f0, f1)[:, halo:halo + h_local]

    fn.halo, fn.h_local = halo, h_local
    return fn


def spatial_interpolate(model, frame0: torch.Tensor, frame1: torch.Tensor,
                        halo: Optional[int] = None, group=None
                        ) -> torch.Tensor:
    """One spatially sharded midpoint: every rank of `group` calls it with
    the same global (B, H, W, C) frames on its device, keeps its rows,
    runs `build_spatial_forward`'s function and gathers the global
    midpoint, which every rank returns. Callers that repeat it should
    cache the built function."""
    fn = build_spatial_forward(model, frame0.shape[1], halo, group=group)
    s = comm.rank(group) * fn.h_local
    rows = slice(s, s + fn.h_local)
    return comm.all_gather_rows(fn(frame0[:, rows], frame1[:, rows]), group)
