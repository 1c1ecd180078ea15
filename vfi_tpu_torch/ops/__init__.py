"""Plain PyTorch ops of the port (NHWC). The CUDA kernel wrappers live in
`ops/cuda/` and are imported from there explicitly, so importing this
package builds nothing."""

from vfi_tpu_torch.ops.deform_conv_shifts import deform_conv2d_shifts
from vfi_tpu_torch.ops.resize import resize_bilinear
from vfi_tpu_torch.ops.histogram import color_histogram, soft_color_histogram
from vfi_tpu_torch.ops.sobel import sobel_gradients
from vfi_tpu_torch.ops.warp import (bilinear_sample, grid_sample,
                                    nearest_sample, warp)

__all__ = ["bilinear_sample", "color_histogram", "deform_conv2d_shifts",
           "grid_sample", "nearest_sample", "resize_bilinear",
           "sobel_gradients", "soft_color_histogram", "warp"]
