"""Plain PyTorch ops of the port (NHWC). The CUDA kernel wrappers live in
`ops/cuda/` and are imported from there explicitly, so importing this
package builds nothing."""

from vfi_tpu_torch.ops.deform_conv_shifts import deform_conv2d_shifts
from vfi_tpu_torch.ops.resize import resize_bilinear
from vfi_tpu_torch.ops.warp import bilinear_sample, warp

__all__ = ["bilinear_sample", "deform_conv2d_shifts", "resize_bilinear",
           "warp"]
