"""A k x k convolution and a chain of stride-1 3x3 convolutions."""

from vfibench.counts import BF16


def out_size(n: int, k: int, stride: int) -> int:
    """Output rows (or columns) at padding k // 2."""
    return (n + 2 * (k // 2) - k) // stride + 1


def conv(b: int, h: int, w: int, cin: int, cout: int, k: int = 3,
         stride: int = 1) -> dict:
    """One conv on a (b, h, w, cin) input: FLOPs (multiply and add) and
    bytes (input, weights, bias, output)."""
    ho, wo = out_size(h, k, stride), out_size(w, k, stride)
    flops = 2.0 * b * ho * wo * k * k * cin * cout
    nbytes = BF16 * (b * h * w * cin + k * k * cin * cout + cout
                     + b * ho * wo * cout)
    return {"flops": flops, "bytes": float(nbytes), "out": (ho, wo)}


def chain(b: int, h: int, w: int, chans: tuple) -> dict:
    """Stride-1 3x3 convs chans[0] -> chans[1] -> ...: FLOPs of every
    layer; bytes of the chain's input, every layer's weights and bias,
    and the last output."""
    flops = sum(2.0 * b * h * w * 9 * ci * co
                for ci, co in zip(chans[:-1], chans[1:]))
    weights = sum(9 * ci * co + co for ci, co in zip(chans[:-1], chans[1:]))
    nbytes = BF16 * (b * h * w * (chans[0] + chans[-1]) + weights)
    return {"flops": flops, "bytes": float(nbytes), "out": (h, w)}
