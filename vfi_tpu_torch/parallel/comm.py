"""The collectives of the port's multi-device modes over a
`torch.distributed` process group (None: the default group), the
counterparts of the named-axis collectives of the JAX package:

- `rank` / `size`: `lax.axis_index` / `lax.axis_size`;
- `all_reduce_sum`: `lax.psum`;
- `all_gather_rows`: `lax.all_gather(..., axis=1, tiled=True)` of NHWC
  slabs, rank order along H (or along the batch);
- `exchange_halo`: the pair of `ppermute`s of `vfi_tpu/parallel/spatial.py`
  (`_exchange_halo`): a rank's top and bottom `halo` rows go to its
  neighbours, and a rank at the edge of the group gets zeros.

Only `all_gather` and `all_reduce` are used, which NCCL and gloo both take
for CUDA tensors (gloo also for CPU ones; gloo's point-to-point ops take
CPU tensors only), so the same code runs on NCCL with one card a rank and
on gloo with ranks that share a card or run on the CPU. Gathers move the
tensor's bytes as they are (as uint8: gloo's gathers of CUDA tensors
refuse some types, bf16's int16 view among them), so no backend's type
support limits them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def rank(group=None) -> int:
    return dist.get_rank(group)


def size(group=None) -> int:
    return dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the group's ranks, on every rank (a new
    tensor)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(x: torch.Tensor, group=None) -> list:
    x = x.contiguous()
    raw = x.view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(size(group))]
    dist.all_gather(parts, raw, group=group)
    return [p.view(x.dtype) for p in parts]


def all_gather_rows(x: torch.Tensor, group=None, dim: int = 1
                    ) -> torch.Tensor:
    """(B, h, W, C) on each rank -> (B, size * h, W, C): the ranks' rows
    stacked along H (`dim`; 0 stacks their batches) in rank order, on
    every rank."""
    return torch.cat(_all_gather(x, group), dim=dim)


def exchange_halo(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """(B, h, W, C) -> (B, h + 2 * halo, W, C): the previous rank's last
    `halo` rows above, the next rank's first `halo` rows below, zeros
    beyond the group's first and last rank. One all_gather of every rank's
    two edges."""
    if not 0 < halo <= x.shape[1]:
        raise ValueError(f"halo={halo} must lie in [1, {x.shape[1]}]")
    r, n = rank(group), size(group)
    edges = _all_gather(torch.cat([x[:, :halo], x[:, -halo:]], dim=1),
                        group)
    zeros = x.new_zeros(x.shape[0], halo, *x.shape[2:])
    top = edges[r - 1][:, halo:] if r > 0 else zeros
    bottom = edges[r + 1][:, :halo] if r < n - 1 else zeros
    return torch.cat([top, x, bottom], dim=1)
