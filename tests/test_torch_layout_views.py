"""Inputs in parts and views: the conv and DCN wrappers take a tensor or its
two parts split along channels, and the bf16 kernels read channels-
contiguous views (strides multiples of 8 elements, 0 too) in place.

CPU: the plain versions (and the wrappers, which run them for CPU tensors)
on parts equal them on the concatenation; `in_place` and `kernel_input`
say which layouts the loaders read, what the float32 instances copy, and
refuse a view or part they cannot read; EMAVFI's forward in parts equals
its concatenating forward bit for bit.

Card (marker `cuda`, skipped without a GPU): each kernel on parts and
views equals the same kernel on the zero-padded concatenation (the path
that copied them) bit for bit, the padded outputs' tails are zeros, q12's
engine in parts equals its concatenating twin bit for bit eager and
replayed, qocc's within the fuse projection's one rounding, and no main
path launch copies an input. Run with `python -m pytest --noconftest
tests/test_torch_layout_views.py -m cuda`."""

import numpy as np
import pytest
import torch

from vfi_tpu_torch.models import EMAVFI
from vfi_tpu_torch.ops.cuda import (INPUT_FORMS, PLAIN, Ops, as_parts,
                                    bounded_warp, bounded_warp_plain,
                                    cat_parts, conv2d, conv2d_plain,
                                    conv_chain, conv_chain_plain,
                                    deform_conv2d_bounded,
                                    deform_conv2d_bounded_plain, in_place,
                                    input_form_counts, reset_launch_counts)
from vfi_tpu_torch.ops.cuda import sampling
from vfi_tpu_torch.ops.cuda.conv import kernel_input, parts_args


def _feat_ctx(gen, b=2, h=5, w=7, dtype=torch.float32, device="cpu"):
    feat = torch.randn(b, h, w, 16, generator=gen).to(device, dtype)
    ctx = torch.randn(b, 8, generator=gen).to(device, dtype)
    return feat, ctx[:, None, None, :].expand(b, h, w, 8)


def _rgb8(gen, b=2, h=5, w=7, dtype=torch.float32, device="cpu"):
    """A 3-channel image as the [..., :3] view of an 8-wide buffer whose
    tail holds garbage (a loader must not read it)."""
    buf = torch.randn(b, h, w, 8, generator=gen).to(device, dtype)
    return buf[..., :3]


# ---------------------------------------------------------------- CPU


def test_as_parts_and_cat_parts():
    gen = torch.Generator().manual_seed(0)
    feat, ctx = _feat_ctx(gen)
    assert as_parts(feat) == (feat,)
    assert cat_parts(feat) is feat
    assert torch.equal(cat_parts([feat, ctx]), torch.cat([feat, ctx], -1))
    with pytest.raises(ValueError, match="one or two parts"):
        as_parts((feat, ctx, ctx))
    with pytest.raises(ValueError, match="do not split one input"):
        as_parts((feat, ctx[:, :4]))
    with pytest.raises(ValueError, match="do not split one input"):
        as_parts((feat, ctx.double()))
    with pytest.raises(ValueError, match="NHWC"):
        as_parts(feat[0])


@pytest.mark.parametrize("name,view,readable", [
    ("contiguous 64", lambda t: t[..., :64].contiguous(), True),
    ("67 of a 72-wide buffer", lambda t: t[..., :67], True),
    ("3 of an 8-wide buffer", lambda t: t[..., :8].contiguous()[..., :3],
     True),
    ("a broadcast vector", lambda t: t[:, :1, :1, :64].contiguous().expand(
        2, 5, 7, 64), True),
    ("contiguous 67: 134-byte pixels", lambda t: t[..., :67].contiguous(),
     False),
    ("one channel into its pixel", lambda t: t[..., 1:9], False),
    ("an odd column stride", lambda t: t[:, :, ::3, :64], True),
    ("channels strided", lambda t: t[..., ::2], False),
    ("NCHW permuted", lambda t: t[..., :8].permute(0, 3, 1, 2).contiguous()
     .permute(0, 2, 3, 1), False),
    ("a 67-channel pixel stride", lambda t: t[..., :67].contiguous()[
        ..., :64], False)])
def test_in_place_says_which_layouts_the_loaders_read(name, view, readable):
    buf = torch.zeros(2, 5, 7, 72, dtype=torch.bfloat16)
    assert in_place(view(buf)) == readable, name


def test_kernel_input_forms():
    gen = torch.Generator().manual_seed(1)
    bf = torch.bfloat16
    feat, ctx = _feat_ctx(gen, dtype=bf)
    rgb = _rgb8(gen, dtype=bf)
    assert kernel_input(feat, "t", True) == ((feat,), "whole")
    assert kernel_input((feat,), "t", True) == ((feat,), "whole")
    parts, form = kernel_input((feat, ctx), "t", True)
    assert form == "parts" and parts[0] is feat and parts[1] is ctx
    assert kernel_input((feat, rgb), "t", True)[1] == "parts"
    wide = torch.randn(2, 5, 7, 72, generator=gen).to(bf)
    assert kernel_input(wide[..., :67], "t", True)[1] == "view"
    # A contiguous 67-channel tensor is copied zero-padded to 72.
    (x,), form = kernel_input(wide[..., :67].contiguous(), "t", True)
    assert form == "copied" and x.shape[-1] == 72
    assert torch.equal(x[..., :67], wide[..., :67])
    assert not x[..., 67:].any()
    # The float32 instances take one contiguous tensor of 8k channels.
    f32 = (feat.float(), rgb.float())
    (x,), form = kernel_input(f32, "t", False)
    assert form == "copied" and x.is_contiguous() and x.shape[-1] == 24
    assert torch.equal(x[..., :19], cat_parts(f32)) and not x[..., 19:].any()
    f = feat.float()
    assert kernel_input(f, "t", False) == ((f,), "whole")
    assert set(INPUT_FORMS) == {"whole", "view", "parts", "copied"}


@pytest.mark.parametrize("bad", ["misaligned view", "part 0 of 67",
                                 "misaligned part", "strided channels"])
def test_kernel_input_refuses_what_the_loaders_cannot_read(bad):
    gen = torch.Generator().manual_seed(2)
    bf = torch.bfloat16
    feat, ctx = _feat_ctx(gen, dtype=bf)
    wide = torch.randn(2, 5, 7, 80, generator=gen).to(bf)
    x = {"misaligned view": wide[..., 1:65],
         "part 0 of 67": (wide[..., :67], ctx),
         "misaligned part": (feat, wide[..., 4:12]),
         "strided channels": wide[..., ::2]}[bad]
    with pytest.raises(ValueError, match="reads a channels-contiguous view"):
        kernel_input(x, "conv2d", True)


def test_parts_args_are_pointer_strides_and_channels():
    gen = torch.Generator().manual_seed(3)
    feat, ctx = _feat_ctx(gen, dtype=torch.bfloat16)
    args = parts_args((feat, ctx))
    assert args == (feat.data_ptr(), 5 * 7 * 16, 7 * 16, 16, 16,
                    ctx.data_ptr(), 8, 0, 0, 8)
    assert parts_args((feat,))[5:] == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("kernels", [True, False])
def test_plain_versions_of_parts_equal_them_of_the_concatenation(kernels):
    """conv2d (k 1 and 3), the chain (one and three layers) and the DCN on
    (features, broadcast context) and (features, a 3-of-8 view) equal the
    same function on the concatenation bit for bit; the wrappers, given
    CPU tensors, run these plain versions."""
    gen = torch.Generator().manual_seed(4)
    feat, ctx = _feat_ctx(gen)
    rgb = _rgb8(gen)
    for x in ((feat, ctx), (feat, rgb), [feat, rgb]):
        cat = torch.cat(list(x), dim=-1)
        cin = cat.shape[-1]
        for k in (1, 3):
            wt = torch.randn(6, cin, k, k, generator=gen)
            bt = torch.randn(6, generator=gen)
            fn = conv2d if kernels else conv2d_plain
            assert torch.equal(fn(x, wt, bt, True), fn(cat, wt, bt, True))
        ws = [torch.randn(8, cin, 3, 3, generator=gen),
              torch.randn(8, 8, 3, 3, generator=gen),
              torch.randn(2, 8, 3, 3, generator=gen)]
        bs = [torch.randn(w.shape[0], generator=gen) for w in ws]
        fn = conv_chain if kernels else conv_chain_plain
        for n in (1, 3):
            acts = (True, True, False)[:n]
            assert torch.equal(fn(x, ws[:n], bs[:n], acts),
                               fn(cat, ws[:n], bs[:n], acts))
        off = torch.randn(2, 5, 7, 18, generator=gen) * 1.5
        mask = torch.sigmoid(torch.randn(2, 5, 7, 9, generator=gen))
        wt = torch.randn(cin, cin, 3, 3, generator=gen) / 8
        bt = torch.randn(cin, generator=gen)
        fn = deform_conv2d_bounded if kernels else deform_conv2d_bounded_plain
        assert torch.equal(fn(x, off, mask, wt, bt, 2),
                           fn(cat, off, mask, wt, bt, 2))


def test_wrappers_on_parts_that_need_grad_take_the_concatenation():
    """A part that needs a gradient: the wrappers record autograd of the
    plain version on the concatenation, so the gradient reaches each
    part as it reaches the concatenation's slice."""
    gen = torch.Generator().manual_seed(5)
    feat, _ = _feat_ctx(gen)
    rgb = _rgb8(gen)
    wt = torch.randn(4, 19, 3, 3, generator=gen)
    a = feat.clone().requires_grad_()
    conv_chain((a, rgb), [wt], [None], (True,)).sum().backward()
    b = torch.cat([feat, rgb], -1).requires_grad_()
    conv_chain(b, [wt], [None], (True,)).sum().backward()
    assert torch.equal(a.grad, b.grad[..., :16])


def _pad8_warp(image, flow, max_flow=16, padded=False):
    """The bounded warp's plain version, asked for a padded output
    (`padded`) into an 8-wide buffer, returned as its [..., :C] view, as
    the bf16 kernel returns it on the card."""
    out = bounded_warp_plain(image, flow, max_flow)
    if not padded:
        return out
    buf = out.new_zeros(*out.shape[:3], 8)
    buf[..., :out.shape[-1]] = out
    return buf[..., :out.shape[-1]]


@pytest.mark.parametrize("fuse", [True, False])
def test_the_forward_in_parts_equals_the_concatenating_forward(fuse):
    """EMAVFI in float32 on the CPU with the plain versions (the warp's
    output an 8-wide buffer's view, as on the card): the forward that
    hands the kernels parts (`_reads_parts` forced) equals the one that
    concatenates bit for bit, with the fuse projection (through
    `ops.conv2d`) and without (through the first DCN), the cascade's
    coarse pass included."""
    torch.manual_seed(0)
    model = EMAVFI(mid_channels=16, num_blocks=2, fuse_project=fuse,
                   dcn_max_offset=2, warp_max_flow=16, cascade_levels=2,
                   conv_kernel="pallas", use_kernels=False)
    with torch.no_grad():
        for i in range(2):
            getattr(model, f"fusion_dcn{i}").offset_conv.weight.normal_(
                0, 0.05)
    model.ops = Ops(PLAIN.conv_chain, PLAIN.deform_conv2d_bounded,
                    _pad8_warp, PLAIN.conv2d)
    model.pack_kernel_weights()
    gen = torch.Generator().manual_seed(6)
    f0 = torch.rand(2, 16, 24, 3, generator=gen)
    f1 = torch.roll(f0, (1, -2), dims=(1, 2))
    calls = []

    def spy(fn):
        def wrapped(x, *a, **k):
            calls.append(isinstance(x, tuple))
            return fn(x, *a, **k)
        return wrapped

    model.ops = Ops(*(spy(f) if i != 2 else f
                      for i, f in enumerate(model.ops)))
    with torch.no_grad():
        assert not model._reads_parts(f0)      # a CPU input concatenates
        want = model(f0, f1)
        assert not any(calls)
        model._reads_parts = lambda x: True
        got = model(f0, f1)
    # parts: both motion chains, and the fuse projection or DCN 0 and its
    # offset conv (inside the DCN call)
    assert sum(calls) == (3 if fuse else 4)
    assert torch.equal(got, want)


def test_reads_parts_only_for_bf16_cuda_pallas_without_grad():
    """What `_reads_parts` observes: the conv_kernel setting, the input's
    device and dtype, spatial mode and whether grad is recorded (CPU and
    meta tensors stand in for what they can)."""
    m = EMAVFI(mid_channels=8, num_blocks=1, dcn_max_offset=1,
               warp_max_flow=16, conv_kernel="pallas")
    x = torch.zeros(1, 8, 8, 3, dtype=torch.bfloat16)
    assert not m._reads_parts(x)               # not CUDA
    assert not m._reads_parts(x.to("meta"))


# What `_reads_parts` is given, and what it answers: a bf16 input on the
# card (or standing in for one), the kernels under conv_kernel "pallas",
# no spatial mode, no gradient to record. Parameters require grad as they
# do in a fresh model; "frozen" models have none that do.
READS_PARTS_CASES = [
    ("no_grad", dict(no_grad=True), True),
    ("frozen", dict(frozen=True), True),
    ("float32", dict(no_grad=True, dtype=torch.float32), False),
    ("spatial", dict(no_grad=True, spatial=True), False),
    ("xla", dict(no_grad=True, conv_kernel="xla"), False),
    ("plain_versions", dict(no_grad=True, use_kernels=False), False),
    ("parameters_need_grad", dict(), False),
    ("input_needs_grad", dict(frozen=True, input_grad=True), False),
    ("input_grad_under_no_grad", dict(no_grad=True, input_grad=True), True),
]


def _reads_parts_case(dev, no_grad=False, frozen=False, dtype=torch.bfloat16,
                      spatial=False, conv_kernel="pallas", use_kernels=True,
                      input_grad=False) -> bool:
    m = EMAVFI(mid_channels=8, num_blocks=1, dcn_max_offset=1,
               warp_max_flow=16, conv_kernel=conv_kernel,
               use_kernels=use_kernels)
    if frozen:
        m.requires_grad_(False)
    if spatial:
        m.spatial_global_h = 16
    x = torch.zeros(1, 8, 8, 3, dtype=dtype, device=dev)
    x.requires_grad_(input_grad)
    if no_grad:
        with torch.no_grad():
            return m._reads_parts(x)
    return m._reads_parts(x)


@pytest.mark.parametrize("case,kw,want", READS_PARTS_CASES,
                         ids=[c[0] for c in READS_PARTS_CASES])
def test_reads_parts_observes_dtype_mode_kernels_and_grad(monkeypatch, case,
                                                         kw, want):
    """`_reads_parts` on a CPU tensor that reports itself on the card
    (`Tensor.is_cuda` patched): every condition but the device."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert _reads_parts_case("cpu", **kw) == want, case


# ---------------------------------------------------------------- card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _rnd(gen, dev, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
        torch.bfloat16)


def _card_parts(gen, dev, kind, b, h, w):
    """(parts, concatenation) of one kind: a stride-0 part (features,
    broadcast context), a 3-in-8 part (features, the [..., :3] view of an
    8-wide buffer with garbage in its tail), or a 72-wide buffer's
    [..., :67] view (one part), its tail garbage too."""
    feat = _rnd(gen, dev, b, h, w, 64)
    if kind == "broadcast":
        ctx = _rnd(gen, dev, b, 64)
        parts = (feat, ctx[:, None, None, :].expand(b, h, w, 64))
    elif kind == "rgb8":
        parts = (feat, _rnd(gen, dev, b, h, w, 8)[..., :3])
    else:
        parts = (_rnd(gen, dev, b, h, w, 72)[..., :67],)
    return parts, torch.cat(parts, dim=-1).contiguous()


KINDS = ["broadcast", "rgb8", "view67"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,cout", [(1, 64), (3, 27)])
def test_conv2d_reads_parts_as_the_padded_concatenation(dev, kind, k, cout):
    gen = torch.Generator(device=dev).manual_seed(7)
    parts, cat = _card_parts(gen, dev, kind, 2, 13, 37)
    cin = cat.shape[-1]
    wt = torch.randn(cout, cin, k, k, generator=gen, device=dev) / cin
    bt = torch.randn(cout, generator=gen, device=dev)
    reset_launch_counts()
    got = conv2d(parts if len(parts) > 1 else parts[0], wt, bt, k == 3)
    form = input_form_counts()
    want = conv2d(cat, wt, bt, k == 3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert form["parts" if len(parts) > 1 else "view"] == 1
    assert form["copied"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layers", [1, 3])
def test_conv_chain_reads_parts_as_the_padded_concatenation(dev, kind,
                                                            layers):
    gen = torch.Generator(device=dev).manual_seed(8)
    parts, cat = _card_parts(gen, dev, kind, 2, 13, 37)
    cin = cat.shape[-1]
    chans = (cin, 27) if layers == 1 else (cin, 64, 64, 2)
    ws = [torch.randn(co, ci, 3, 3, generator=gen, device=dev) / (3 * ci)
          for ci, co in zip(chans[:-1], chans[1:])]
    bs = [torch.randn(co, generator=gen, device=dev) * 0.1
          for co in chans[1:]]
    acts = (True,) * (layers - 1) + (False,)
    reset_launch_counts()
    got = conv_chain(parts if len(parts) > 1 else parts[0], ws, bs, acts)
    assert input_form_counts()["copied"] == 0
    want = conv_chain(cat, ws, bs, acts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("R,design", [(2, "tile"), (8, "stream")])
def test_dcn_reads_parts_as_the_padded_concatenation(dev, kind, R, design):
    """Both designs (C = 67 at R = 2 on the tile design, at R = 8 on the
    stream design; C = 128 on the stream design at both)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    parts, cat = _card_parts(gen, dev, kind, 2, 13, 37)
    cin = cat.shape[-1]
    plan = sampling.dcn_plan(cin, cin, R, torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin)
    assert plan["design"] == (design if cin == 67 else "stream")
    off = _rnd(gen, dev, 2, 13, 37, 18, scale=0.8 * R)
    mask = torch.sigmoid(_rnd(gen, dev, 2, 13, 37, 9, scale=2.0).float()).to(
        torch.bfloat16)
    wt = torch.randn(cin, cin, 3, 3, generator=gen, device=dev) / (3 * cin)
    bt = torch.randn(cin, generator=gen, device=dev) * 0.1
    reset_launch_counts()
    got = deform_conv2d_bounded(parts if len(parts) > 1 else parts[0], off,
                                mask, wt, bt, R)
    assert input_form_counts()["copied"] == 0
    want = deform_conv2d_bounded(cat, off, mask, wt, bt, R)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _tail(view: torch.Tensor, width: int) -> torch.Tensor:
    """The channels past a [..., :C] view's end in its `width`-wide
    buffer."""
    full = torch.as_strided(view, (*view.shape[:3], width), view.stride(),
                            view.storage_offset())
    return full[..., view.shape[-1]:]


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [67, 27, 3])
@pytest.mark.parametrize("cin,R,design", [(64, 1, "tile"),
                                          (128, 4, "stream")])
def test_dcn_writes_odd_widths_padded_with_zero_tails(dev, monkeypatch,
                                                      cout, cin, R, design):
    """Without grad a bf16 DCN of Cout % 8 != 0 returns the [..., :Cout]
    view of a Cout8-wide buffer whose tail is +0 bit for bit (also where
    the input holds infinities, whose products with the packed weights'
    zero columns would be NaN), its values those of the unpadded launch,
    on both designs (the stream design forced, as its plan holds no
    narrow Cout at these sizes), where the caller asks for it (`padded`);
    else the output is the contiguous Cout-wide tensor."""
    if design == "stream":
        monkeypatch.setattr(sampling, "dcn_plan", sampling._stream_plan)
    gen = torch.Generator(device=dev).manual_seed(10)
    x = _rnd(gen, dev, 1, 13, 37, cin)
    x[0, 3, 5, 7] = float("inf")
    off = _rnd(gen, dev, 1, 13, 37, 18, scale=0.8 * R)
    wt = torch.randn(cout, cin, 3, 3, generator=gen, device=dev) / 24
    bt = torch.randn(cout, generator=gen, device=dev)
    got = deform_conv2d_bounded(x, off, None, wt, bt, R, padded=True)
    assert got.shape[-1] == cout and got.stride(2) == -(-cout // 8) * 8
    plain = deform_conv2d_bounded(x, off, None, wt, bt, R)
    assert plain.is_contiguous() and plain.shape[-1] == cout
    plan = sampling.dcn_plan(cin, cout, R, torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin)
    assert plan["design"] == design
    wpk, bpk = sampling.pack_dcn(wt, bt)
    want = sampling._dcn_launch((x,), "whole", off, None, wpk, bpk, cin,
                                cout, R, plan, dev.index)
    torch.cuda.synchronize()
    assert want.is_contiguous()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert torch.equal(plain.nan_to_num(), want.nan_to_num())
    tail = _tail(got, got.stride(2))
    assert (tail.view(torch.int16) == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(13, 37), (16, 64), (9, 7)])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_rgb_warp_writes_eight_channels_with_zero_tails(dev, c, hw):
    """Without grad, asked for it (`padded`), the bf16 RGB warp returns the
    [..., :C] view of an 8-wide buffer (on its vector path and its 2-byte
    one: odd W) whose tail is +0 bit for bit; its values equal the plain
    version's. Not asked, it returns a contiguous C-wide tensor."""
    gen = torch.Generator(device=dev).manual_seed(11)
    img = torch.rand(3, *hw, c, generator=gen, device=dev).to(torch.bfloat16)
    flow = _rnd(gen, dev, 3, *hw, 2, scale=12.0)
    plain = bounded_warp(img, flow, 16)
    assert plain.is_contiguous()
    assert torch.equal(plain, bounded_warp_plain(img, flow, 16))
    got = bounded_warp(img, flow, 16, padded=True)
    torch.cuda.synchronize()
    assert got.shape == img.shape and got.stride(2) == 8
    assert torch.equal(got, bounded_warp_plain(img, flow, 16))
    assert (_tail(got, 8).view(torch.int16) == 0).all()
    assert in_place(got)


@pytest.mark.cuda
@pytest.mark.parametrize("case,kw,want", READS_PARTS_CASES,
                         ids=[c[0] for c in READS_PARTS_CASES])
def test_reads_parts_on_the_card(dev, case, kw, want):
    """`_reads_parts` on a card tensor: each case as on the CPU."""
    assert _reads_parts_case(dev, **kw) == want, case


def _engines(dev, config, **kw):
    """Two engines over one random tree of the configuration's topology
    (qocc: the fuse projection, R=1; q12: 67-wide DCNs, R=2; flow prior,
    cascade 2, warp bound 16, conv_kernel "pallas", bf16, uint8 frames) on
    64x96 frames in launches of 4 pairs: the first as it runs, the second
    a twin that concatenates (`_reads_parts` returns False)."""
    from vfi_tpu_torch.infer import FrameInterpolator
    from vfi_tpu_torch.models import SimpleFlowNet
    from vfi_tpu_torch.utils.convert import params_to_jax

    fuse, radius = {"qocc": (True, 1), "q12": (False, 2)}[config]
    torch.manual_seed(0)
    model = EMAVFI(mid_channels=64, num_blocks=3, fuse_project=fuse,
                   dcn_max_offset=radius, warp_max_flow=16)
    with torch.no_grad():
        for i in range(3):
            getattr(model, f"fusion_dcn{i}").offset_conv.weight.normal_(
                0, 0.02)
    params = params_to_jax(model.state_dict())
    flow = params_to_jax(SimpleFlowNet(mid_channels=32,
                                       levels=3).state_dict())
    kw = dict(flow_params=flow, bf16=True, io_uint8=True,
              dcn_max_offset=radius, warp_max_flow=16, cascade_levels=2,
              conv_kernel="pallas", device=dev,
              max_px_per_launch=4 * 64 * 96, **kw)
    parts, cat = FrameInterpolator(params, **kw), FrameInterpolator(params,
                                                                    **kw)
    cat.model._reads_parts = lambda x: False
    return parts, cat


def _pairs(seed, b):
    rng = np.random.default_rng(seed)
    f0 = rng.integers(0, 256, (b, 64, 96, 3), dtype=np.uint8)
    f1 = np.roll(f0, (2, -3), axis=(1, 2))
    return torch.from_numpy(f0).pin_memory(), torch.from_numpy(f1).pin_memory()


# qocc's midpoints (uint8) in parts against the concatenating twin: the
# fuse projection's one rounding moves a value by at most this many levels
# and moves at most this share of them (a 720p flagship call: 2 levels,
# 3.7% of the values).
QOCC_MAX_LEVELS = 2
QOCC_DIFF_SHARE = 0.10


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["q12", "qocc"])
def test_engine_in_parts_equals_the_concatenating_twin(dev, config):
    """Calls of 8 pairs (two launches of 4): eager, captured, then replayed
    (CUDA graphs). q12: bit for bit against the twin that concatenates;
    qocc: within the fuse projection's one rounding (the kernel adds the
    bias in float32 before one rounding, the twin's cuDNN conv and bias add
    round twice): at most QOCC_MAX_LEVELS apart, and in at most
    QOCC_DIFF_SHARE of the values. No launch of either configuration
    copies an input; the twin's launches (which ask for no padded output)
    copy q12's 67-wide inputs zero-padded seven times: each DCN's and its
    offset conv's, and the reconstruction's."""
    eng, twin = _engines(dev, config)
    for i, seed in enumerate((1, 2, 1, 3)):
        f0, f1 = _pairs(seed, 8)
        reset_launch_counts()
        got = eng.midpoints(f0, f1)
        forms = input_form_counts()
        want = twin.midpoints(f0, f1)
        torch.cuda.synchronize()
        assert forms["copied"] == 0, forms
        if i == 0:
            assert forms["parts"] > 0
        if config == "q12":
            assert torch.equal(got, want)
        else:
            d = (got.int() - want.int()).abs()
            share = (d > 0).float().mean().item()
            assert d.max().item() <= QOCC_MAX_LEVELS, (d.max().item(), share)
            assert share <= QOCC_DIFF_SHARE, (d.max().item(), share)
    assert eng.graph_stats["replayed"] >= 4
    reset_launch_counts()
    twin._graph_key = lambda *args: None
    twin.midpoints(*_pairs(4, 4))
    copied = input_form_counts()["copied"]
    assert copied == (7 if config == "q12" else 0)
