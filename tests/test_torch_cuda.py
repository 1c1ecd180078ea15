"""The port's CUDA kernels vs their plain versions on the card, at small
shapes with ragged edges (the 720p main-path shapes run in
chip_smoke.py). Needs an NVIDIA GPU and nvcc; skips without a GPU. Run on
the card with `python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`
(tests/conftest.py imports jax, which a GPU host that runs only the port
need not have).

Tolerance: two bf16 ulps at the top of the output's range (2**-7 *
max|plain|): kernel and plain version differ only in float32 summation
order, which can move a bf16 rounding by one ulp."""

import pytest
import torch

from vfi_tpu_torch.ops.cuda import (bounded_warp, bounded_warp_plain,
                                    conv_chain, conv_chain_plain,
                                    deform_conv2d_bounded,
                                    deform_conv2d_bounded_plain,
                                    launch_counts, reset_launch_counts)

pytestmark = pytest.mark.cuda
REL_TOL = 2.0 ** -7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL * ref.float().abs().max().item()


def _rnd(gen, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
        torch.bfloat16)


@pytest.mark.parametrize("hw", [(8, 16), (13, 37), (40, 72)])
@pytest.mark.parametrize("chans,acts", [
    ((64, 64, 64, 64), (True, True, True)),
    ((128, 64, 64, 2), (True, True, False)),
    ((64, 27), (False,)),
    ((64, 64, 32, 3), (True, True, False)),
    ((16, 48, 16, 8, 5), (True, False, True, False)),
])
def test_conv_chain_kernel(dev, hw, chans, acts):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _rnd(gen, dev, 2, *hw, chans[0])
    ws = [torch.randn(co, ci, 3, 3, generator=gen, device=dev) / (9 * ci) ** .5
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [torch.randn(co, generator=gen, device=dev) * 0.1 for co in chans[1:]]
    reset_launch_counts()
    got = conv_chain(x, ws, bs, acts)
    assert launch_counts()["conv_chain"] == 1
    _close(got, conv_chain_plain(x, ws, bs, acts))


@pytest.mark.parametrize("hw", [(8, 16), (13, 37), (24, 130)])
@pytest.mark.parametrize("cin,cout,R", [(64, 64, 1), (16, 32, 2), (32, 16, 3)])
def test_deform_conv2d_bounded_kernel(dev, hw, cin, cout, R):
    gen = torch.Generator(device=dev).manual_seed(1)
    x = _rnd(gen, dev, 2, *hw, cin)
    off = _rnd(gen, dev, 2, *hw, 18, scale=0.8 * R)
    mask = torch.sigmoid(_rnd(gen, dev, 2, *hw, 9, scale=2.0).float()).to(
        torch.bfloat16)
    w = torch.randn(cout, cin, 3, 3, generator=gen, device=dev) / (9 * cin) ** .5
    b = torch.randn(cout, generator=gen, device=dev) * 0.1
    reset_launch_counts()
    got = deform_conv2d_bounded(x, off, mask, w, b, R)
    assert launch_counts()["deform_conv2d_bounded"] == 1
    _close(got, deform_conv2d_bounded_plain(x, off, mask, w, b, R))


@pytest.mark.parametrize("hw", [(8, 16), (13, 37), (33, 140)])
@pytest.mark.parametrize("R", [4, 16])
def test_bounded_warp_kernel(dev, hw, R):
    gen = torch.Generator(device=dev).manual_seed(2)
    img = _rnd(gen, dev, 2, *hw, 3)
    flow = _rnd(gen, dev, 2, *hw, 2, scale=1.5 * R)
    reset_launch_counts()
    got = bounded_warp(img, flow, R)
    assert launch_counts()["bounded_warp"] == 1
    _close(got, bounded_warp_plain(img, flow, R))


def test_kernels_refuse_float32(dev):
    x = torch.zeros(1, 8, 16, 16, device=dev)
    with pytest.raises(TypeError):
        conv_chain(x, [torch.zeros(16, 16, 3, 3, device=dev)], [None], (True,))
    with pytest.raises(TypeError):
        bounded_warp(torch.zeros(1, 8, 16, 3, device=dev),
                     torch.zeros(1, 8, 16, 2, device=dev))


def test_packed_weights_match_packing_on_the_call(dev):
    from vfi_tpu_torch.ops.cuda import pack_conv_chain, pack_dcn

    gen = torch.Generator(device=dev).manual_seed(3)
    x = _rnd(gen, dev, 1, 13, 37, 64)
    ws = [torch.randn(27, 64, 3, 3, generator=gen, device=dev) / 24]
    bs = [torch.randn(27, generator=gen, device=dev) * 0.1]
    assert torch.equal(conv_chain(x, ws, bs, (False,),
                                  packed=pack_conv_chain(ws, bs)),
                       conv_chain(x, ws, bs, (False,)))
    off = _rnd(gen, dev, 1, 13, 37, 18)
    mask = torch.sigmoid(_rnd(gen, dev, 1, 13, 37, 9).float()).to(
        torch.bfloat16)
    w = torch.randn(64, 64, 3, 3, generator=gen, device=dev) / 24
    assert torch.equal(
        deform_conv2d_bounded(x, off, mask, w, None, 1,
                              packed=pack_dcn(w, None)),
        deform_conv2d_bounded(x, off, mask, w, None, 1))
    with pytest.raises(ValueError):
        conv_chain(x, ws, bs, (False,), packed=pack_dcn(w, None))
    with pytest.raises(ValueError):
        deform_conv2d_bounded(x, off, mask, w, None, 1,
                              packed=pack_dcn(w[:32], None))
