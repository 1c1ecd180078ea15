"""Operations and bytes of the model's ops, from the configuration's
shapes alone, and the card's published peaks: the yardstick of the
roofline and MFU metrics.

`PEAK_*` and `bound` are the arithmetic of `chip_smoke.py` (NVIDIA's H100
SXM data sheet, dense rates, at the 700 W limit). A count is the least
work the op needs, whatever implements it: every input byte read once,
every output byte written once, weights once per call; intermediate
activations of a conv chain are not counted, since a fused kernel need
not write them.
"""

PEAK_BYTES = 3.35e12     # HBM3, bytes/s
PEAK_BF16 = 989e12       # bf16 tensor-core FLOP/s
PEAK_TF32 = 495e12
PEAK_F32 = 67e12         # float32 outside the tensor cores
BF16 = 2                 # bytes an element of the served dtype


def bound_s(nbytes: float, flops_bf16: float, flops_f32: float = 0.0) -> float:
    """Least seconds: the larger of bytes over the memory rate and each
    type's operations over its own peak (the tensor cores and the float32
    units run at once)."""
    return max(nbytes / PEAK_BYTES, flops_bf16 / PEAK_BF16,
               flops_f32 / PEAK_F32)
