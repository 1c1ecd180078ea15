"""The modulated deformable 3x3 convolution (DCNv2), stride 1, one offset
group: 9 taps of a bilinear sample, modulated by the mask, contracted
Cin -> Cout."""

from vfibench.counts import BF16


def dcn(b: int, h: int, w: int, cin: int, cout: int) -> dict:
    """FLOPs of the contraction; bytes of x, the offsets (18 channels),
    the mask (9), the weights, the bias and the output. The bilinear
    blend's float32 work (8 FLOPs a tap and input channel) is not
    counted: at these shapes it never binds."""
    n = b * h * w
    return {"flops": 2.0 * n * 9 * cin * cout,
            "bytes": float(BF16 * (n * (cin + 18 + 9 + cout)
                                   + 9 * cin * cout + cout)),
            "out": (h, w)}
