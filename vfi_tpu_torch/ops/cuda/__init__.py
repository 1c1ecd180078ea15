"""Wrappers over the port's hand-written CUDA kernels (`csrc/*.cu`).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version, defined or imported in the same module, only for a tensor
that lies on the CPU. Every wrapper keeps a plain integer `launches` that
it raises by one where it launches its kernel, and nowhere else; each also
counts per call shape in `launches_by_shape`.

Nothing here builds at import: the shared library is compiled on the first
launch (`build.load`).
"""

from typing import Callable, NamedTuple

from vfi_tpu_torch.ops.cuda.conv import (conv_chain, conv_chain_plain,
                                         pack_conv_chain)
from vfi_tpu_torch.ops.cuda.sampling import (bounded_warp, bounded_warp_plain,
                                             deform_conv2d_bounded,
                                             deform_conv2d_bounded_plain,
                                             pack_dcn)

WRAPPERS = (conv_chain, deform_conv2d_bounded, bounded_warp)


class Ops(NamedTuple):
    """The three functions the model calls; `KERNELS` and `PLAIN` share
    their signatures."""
    conv_chain: Callable
    deform_conv2d_bounded: Callable
    bounded_warp: Callable


KERNELS = Ops(conv_chain, deform_conv2d_bounded, bounded_warp)
# The plain versions on any device: the reference a run on the card is
# held against.
PLAIN = Ops(conv_chain_plain, deform_conv2d_bounded_plain, bounded_warp_plain)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        fn.launches_by_shape.clear()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["KERNELS", "Ops", "PLAIN", "WRAPPERS", "bounded_warp",
           "bounded_warp_plain", "conv_chain", "conv_chain_plain",
           "deform_conv2d_bounded", "deform_conv2d_bounded_plain",
           "launch_counts", "pack_conv_chain", "pack_dcn",
           "reset_launch_counts"]
