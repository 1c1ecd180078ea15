"""Wrappers over the port's hand-written CUDA kernels (`csrc/*.cu`).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version, defined or imported in the same module, only for a tensor
that lies on the CPU. Every wrapper keeps a plain integer `launches` that
it raises by one where it launches its kernel, and nowhere else; each also
counts per call shape in `launches_by_shape`, and all but the warp per
(form, dtype tag) of their input in `launches_by_input` (`INPUT_FORMS`:
whole, a view or two parts read in place, or a copy the wrapper made).
`conv_chain_fused`, the fused chain kernel's wrapper, runs on no model
path, so its count in `launch_counts` is 0 wherever the model runs.

Nothing here builds at import: the shared library is compiled on the first
launch (`build.load`).
"""

from typing import Callable, NamedTuple

from vfi_tpu_torch.ops.cuda.conv import (INPUT_FORMS, as_parts, cat_parts,
                                         chain_plan, conv2d, conv2d_plain,
                                         conv2d_plan, conv_chain,
                                         conv_chain_fused, conv_chain_plain,
                                         in_place, pack_conv2d,
                                         pack_conv_chain, reads_views)
from vfi_tpu_torch.ops.cuda.sampling import (bounded_warp, bounded_warp_plain,
                                             dcn_plan, deform_conv2d_bounded,
                                             deform_conv2d_bounded_plain,
                                             hand_backward, pack_dcn)

WRAPPERS = (conv_chain, deform_conv2d_bounded, bounded_warp, conv2d,
            conv_chain_fused)
# The wrappers that count their launches by input form.
INPUT_WRAPPERS = (conv_chain, deform_conv2d_bounded, conv2d,
                  conv_chain_fused)


class Ops(NamedTuple):
    """The four functions the model calls; `KERNELS` and `PLAIN` share
    their signatures."""
    conv_chain: Callable
    deform_conv2d_bounded: Callable
    bounded_warp: Callable
    conv2d: Callable


KERNELS = Ops(conv_chain, deform_conv2d_bounded, bounded_warp, conv2d)
# The plain versions on any device: the reference a run on the card is
# held against.
PLAIN = Ops(conv_chain_plain, deform_conv2d_bounded_plain, bounded_warp_plain,
            conv2d_plain)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        fn.launches_by_shape.clear()
    for fn in INPUT_WRAPPERS:
        fn.launches_by_input.clear()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def input_form_counts() -> dict:
    """Launches of `INPUT_WRAPPERS` by input form (`INPUT_FORMS`), summed
    over the wrappers and dtypes since the last `reset_launch_counts`."""
    out = dict.fromkeys(INPUT_FORMS, 0)
    for fn in INPUT_WRAPPERS:
        for (form, _), n in fn.launches_by_input.items():
            out[form] += n
    return out


__all__ = ["INPUT_FORMS", "INPUT_WRAPPERS", "KERNELS", "Ops", "PLAIN",
           "WRAPPERS", "as_parts", "bounded_warp", "bounded_warp_plain",
           "cat_parts", "chain_plan", "conv2d", "conv2d_plain",
           "conv2d_plan", "conv_chain", "conv_chain_fused",
           "conv_chain_plain", "dcn_plan", "deform_conv2d_bounded",
           "deform_conv2d_bounded_plain",
           "hand_backward", "in_place", "input_form_counts",
           "launch_counts", "pack_conv2d", "pack_conv_chain", "pack_dcn",
           "reads_views", "reset_launch_counts"]
