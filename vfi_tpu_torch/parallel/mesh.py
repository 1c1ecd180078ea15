"""Device meshes of the port, the counterpart of `vfi_tpu/parallel/mesh.py`.

A `Mesh` is a data x spatial grid of `torch.device`s. The engine's data
parallelism uses it in one process: the batch splits over the 'data' rows
(`shard_batch`), one model replica a device. The spatial axis and training
run one process a rank instead (`torch.distributed`, `parallel.comm`),
so there a mesh only names the axes' sizes.

JAX's `NamedSharding` helpers (`batch_sharding`, `spatial_sharding`,
`replicated`) have no counterpart: a torch tensor lives on one device, and
what a sharding says is said here by where `shard_batch` puts each piece
or by which rows a rank keeps.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class Mesh:
    """A ('data', 'spatial') grid of devices: `devices[i][j]` is the device
    of data row i, spatial column j; `shape` is {"data": d, "spatial": s}.
    """

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in devices)
        if not self.devices or len({len(r) for r in self.devices}) != 1 \
                or not self.devices[0]:
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.shape = {"data": len(self.devices),
                      "spatial": len(self.devices[0])}

    @property
    def data_devices(self) -> tuple:
        """The first device of each data row: where its replica runs."""
        return tuple(row[0] for row in self.devices)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices})"


def visible_devices() -> list:
    """Every visible card (`cuda:0` .. `cuda:n-1`); none is an error."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass devices=[...] "
                           "(e.g. [torch.device('cpu')]) to build a mesh on "
                           "the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(data: int = -1, spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'spatial') mesh over `devices` (default: every visible
    card). `data=-1` takes every device `spatial` leaves. An explicit
    `devices` list may name one device more than once (replicas that share
    a card, or the CPU); the default never does."""
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    if spatial <= 0:
        raise ValueError(f"spatial axis must be >= 1, got {spatial}")
    if data == -1:
        if n % spatial != 0:
            raise ValueError(f"{n} devices not divisible by spatial={spatial}")
        data = n // spatial
    if data * spatial > n:
        raise ValueError(f"mesh {data}x{spatial} needs {data * spatial} "
                         f"devices, have {n}")
    return Mesh([devices[i * spatial:(i + 1) * spatial]
                 for i in range(data)])


def shard_batch(batch, mesh: Mesh) -> list:
    """Split each (B, ...) tensor or array of `batch` (a tuple or list)
    over the mesh's 'data' rows: a list with one tuple a row, its pieces
    (B / data rows each, in order) on that row's device. B must divide by
    the 'data' axis."""
    d = mesh.shape["data"]
    b = batch[0].shape[0]
    if any(x.shape[0] != b for x in batch) or b % d:
        raise ValueError(f"batch of {[x.shape[0] for x in batch]} does not "
                         f"split evenly over the 'data' axis ({d})")
    n = b // d
    return [tuple(torch.as_tensor(x[i * n:(i + 1) * n]).to(dev)
                  for x in batch)
            for i, dev in enumerate(mesh.data_devices)]
