"""Multi-device modes of the port (`vfi_tpu/parallel/`'s counterpart):
the device mesh and batch split of the engine's data parallelism, the
collectives over a `torch.distributed` group, and the exact spatial halo
pipeline."""

from vfi_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from vfi_tpu_torch.parallel.spatial import (build_spatial_forward,
                                            required_halo,
                                            spatial_interpolate)

__all__ = ["Mesh", "make_mesh", "shard_batch", "build_spatial_forward",
           "required_halo", "spatial_interpolate"]
