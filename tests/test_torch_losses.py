"""The port's sampling ops, Sobel, histograms, loss stack, VGG trunk and
perceptual loss against `vfi_tpu`, float32 on both sides (JAX convs and
matmuls at HIGHEST precision), inputs from numpy seeds.

Tolerances: the warps, grids, Sobel and the soft histogram to 1e-6
(absolute, values of order 1); the exact histogram equal; each loss term
to 1e-6 relative; the VGG features from one converted tree to 1e-5
(relative to the tap's largest value: several f32 convs summed in
another order)."""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.losses import losses as jl
from vfi_tpu.losses.perceptual import VGGPerceptualLoss as JVGGLoss
from vfi_tpu.models.flownet import SimpleFlowNet as JFlowNet
from vfi_tpu.models.vgg import VGG16Features as JVGG
from vfi_tpu_torch.losses import (LossWeights, VGGPerceptualLoss,
                                  charbonnier_loss, color_histogram_loss,
                                  gradient_loss, l1_loss, l2_loss,
                                  temporal_consistency_loss, total_loss)
from vfi_tpu_torch.models import SimpleFlowNet
from vfi_tpu_torch.models.vgg import LAYER_INDEX, VGG16Features
from vfi_tpu_torch.ops import (color_histogram, grid_sample, nearest_sample,
                               sobel_gradients, soft_color_histogram, warp)
from vfi_tpu_torch.utils.convert import params_from_jax

# The JAX ops package re-exports these functions under the modules'
# names, so the modules are looked up directly.
jh, js, jw = (importlib.import_module(f"vfi_tpu.ops.{m}")
              for m in ("histogram", "sobel", "warp"))

TOL = 1e-6
VGG_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    # flows with exact halves (ties of nearest rounding), integers, and
    # reaches outside the image
    flow = rng.uniform(-4, 4, (2, 12, 16, 2)).astype(np.float32)
    flow[0, :4] = np.round(flow[0, :4] * 2) / 2
    flow[1, :2] = np.round(flow[1, :2])
    return img, flow


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_matches_jax(frames, mode):
    img, flow = frames
    ref = jw.warp(jnp.asarray(img), jnp.asarray(flow), mode=mode)
    got = warp(t(img), t(flow), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_warp_default_is_bilinear_bit_for_bit(frames):
    img, flow = frames
    assert torch.equal(warp(t(img), t(flow)),
                       warp(t(img), t(flow), mode="bilinear"))
    with pytest.raises(ValueError, match="mode"):
        warp(t(img), t(flow), mode="bicubic")


def test_nearest_sample_rounds_half_to_even():
    img = torch.arange(8, dtype=torch.float32).reshape(1, 1, 8, 1)
    xs = torch.tensor([[[0.5, 1.5, 2.5, 3.5, 6.5, 7.5]]])
    got = nearest_sample(img, torch.zeros_like(xs), xs)
    # 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 3.5 -> 4, 6.5 -> 6, 7.5 -> 8 (outside)
    assert got.flatten().tolist() == [0.0, 2.0, 2.0, 4.0, 6.0, 0.0]
    ref = jw.nearest_sample(jnp.asarray(img[0].numpy()),
                            jnp.zeros((1, 6)), jnp.asarray(xs[0].numpy()))
    assert got[0].numpy().tolist() == np.asarray(ref).tolist()


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(frames, mode):
    img, _ = frames
    rng = np.random.default_rng(4)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)
    ref = jw.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode=mode)
    got = grid_sample(t(img), t(grid), mode=mode)
    assert got.shape == (2, 5, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_nearest_warp_passes_no_gradient_to_the_flow(frames):
    img, flow = frames
    f = t(flow).requires_grad_()
    i = t(img).requires_grad_()
    warp(i, f, mode="nearest").sum().backward()
    assert f.grad is None or not f.grad.any()
    assert i.grad.any()


def test_sobel_matches_jax(frames):
    img, _ = frames
    with jax.default_matmul_precision("highest"):
        rgx, rgy = js.sobel_gradients(jnp.asarray(img))
    gx, gy = sobel_gradients(t(img))
    np.testing.assert_allclose(gx.numpy(), np.asarray(rgx), atol=TOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(rgy), atol=TOL)


def _histogram_input():
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.1, 1.1, (2, 9, 11, 3)).astype(np.float32)
    # values on bin edges (k / 255) and the ends of the range
    x[0, 0, :, 0] = np.arange(11, dtype=np.float32) * 25 / 255
    x[1, 1, :3] = [[0.0, 1.0, 0.5]]
    return x


def test_color_histogram_equals_jax():
    x = _histogram_input()
    ref = np.asarray(jh.color_histogram(jnp.asarray(x)))
    got = color_histogram(t(x)).numpy()
    assert got.shape == (2, 3, 256)
    np.testing.assert_array_equal(got, ref)


def test_soft_color_histogram_and_its_gradient_match_jax():
    x = _histogram_input()
    cot = np.random.default_rng(6).normal(size=(2, 3, 256)).astype(np.float32)
    ref = jh.soft_color_histogram(jnp.asarray(x))
    ref_g = jax.grad(lambda v: jnp.sum(jh.soft_color_histogram(v) * cot))(
        jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = soft_color_histogram(xt)
    (got * t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_g),
                               atol=1e-5)


def test_exact_histogram_has_no_gradient():
    xt = t(_histogram_input()).requires_grad_()
    assert not color_histogram(xt).requires_grad
    loss = color_histogram_loss(xt, torch.zeros_like(xt))
    assert not loss.requires_grad


@pytest.fixture(scope="module")
def pred_target():
    rng = np.random.default_rng(8)
    pred = rng.uniform(0, 1, (2, 16, 20, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.1, pred.shape), -0.2,
                     1.2).astype(np.float32)
    return pred, target


LOSSES = [("l1", l1_loss, jl.l1_loss), ("l2", l2_loss, jl.l2_loss),
          ("charbonnier", charbonnier_loss, jl.charbonnier_loss),
          ("gradient", gradient_loss, jl.gradient_loss),
          ("color", color_histogram_loss, jl.color_histogram_loss),
          ("color_soft", lambda a, b: color_histogram_loss(a, b, soft=True),
           lambda a, b: jl.color_histogram_loss(a, b, soft=True))]


@pytest.mark.parametrize("name,port_fn,jax_fn", LOSSES,
                         ids=[c[0] for c in LOSSES])
def test_loss_term_and_gradient_match_jax(pred_target, name, port_fn,
                                          jax_fn):
    pred, target = pred_target
    with jax.default_matmul_precision("highest"):
        ref, ref_g = jax.value_and_grad(jax_fn)(jnp.asarray(pred),
                                                jnp.asarray(target))
    p = t(pred).requires_grad_()
    got = port_fn(p, t(target))
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=TOL)
    if got.requires_grad:
        got.backward()
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g),
                                   rtol=1e-5, atol=1e-9)
    else:       # the exact histogram: a constant for autograd, as in JAX
        assert name == "color" and not np.asarray(ref_g).any()


@pytest.fixture(scope="module")
def flow_nets():
    """SimpleFlowNet (8 wide, 2 levels) from one JAX init, on both sides."""
    x = jnp.zeros((1, 16, 16, 3))
    jnet = JFlowNet(mid_channels=8, levels=2)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32),
        jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, x))
    net = SimpleFlowNet(mid_channels=8, levels=2)
    net.load_state_dict(params_from_jax(tree))
    with jax.default_matmul_precision("highest"):
        jflow = jax.jit(lambda a, b: jnet.apply(tree, a, b))
    return jflow, net


def test_temporal_consistency_loss_matches_jax(pred_target, flow_nets):
    pred, target = pred_target
    jflow, flow = flow_nets
    with jax.default_matmul_precision("highest"):
        ref = jl.temporal_consistency_loss(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(target[::-1]),
            jflow)
    with torch.no_grad():
        got = temporal_consistency_loss(t(pred), t(target),
                                        t(target[::-1]), flow)
    np.testing.assert_allclose(float(got), float(ref), rtol=TOL)


@pytest.mark.parametrize("temporal", [0.15, 0.0])
def test_total_loss_terms_match_jax(pred_target, flow_nets, temporal):
    """Same keys, `temporal` only with weight, estimator and both frames;
    each term to TOL relative. The VGG term is a stand-in callable here
    (the VGG tests below hold the trunk)."""
    pred, target = pred_target
    jflow, flow = flow_nets
    w = dict(charbonnier=0.5, vgg=0.15, color=0.3, gradient=0.1,
             temporal=temporal)
    with jax.default_matmul_precision("highest"):
        rtot, rterms = jl.total_loss(
            jnp.asarray(pred), jnp.asarray(target),
            lambda a, b: jnp.mean(jnp.abs(a - b)) * 2.0, jl.LossWeights(**w),
            flow_estimator=jflow, frame0=jnp.asarray(target),
            frame1=jnp.asarray(target[::-1]))
    with torch.no_grad():
        tot, terms = total_loss(
            t(pred), t(target), lambda a, b: (a - b).abs().mean() * 2.0,
            LossWeights(**w), flow_estimator=flow, frame0=t(target),
            frame1=t(target[::-1]))
    assert sorted(terms) == sorted(rterms)
    assert ("temporal" in terms) == (temporal > 0)
    for k in rterms:
        np.testing.assert_allclose(float(terms[k]), float(rterms[k]),
                                   rtol=TOL, err_msg=k)
    np.testing.assert_allclose(float(tot), float(rtot), rtol=TOL)
    _, no_frames = total_loss(t(pred), t(target), None, LossWeights(**w),
                              flow_estimator=flow)
    assert "temporal" not in no_frames and float(no_frames["vgg"]) == 0.0


def _vgg_shapes(stage):
    """The Flax tree's structure and shapes, without running its init."""
    return jax.eval_shape(JVGG(max_stage=stage).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 16, 16, 3)))


@pytest.fixture(scope="module")
def vgg_tree():
    """A full (relu4_3) VGG tree of He-scaled random values, numpy."""
    rng = np.random.default_rng(11)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape) * (
            (2.0 / np.prod(s.shape[:3])) ** 0.5 if len(s.shape) == 4
            else 0.1)).astype(np.float32), _vgg_shapes(3))


def test_vgg_features_match_jax(vgg_tree):
    x = np.random.default_rng(9).normal(size=(2, 24, 32, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        ref = JVGG(max_stage=3).apply(vgg_tree, jnp.asarray(x))
    vgg = VGG16Features(max_stage=3)
    vgg.load_state_dict(params_from_jax(vgg_tree))
    with torch.no_grad():
        got = vgg(t(x))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=VGG_TOL * np.abs(r).max())


@pytest.mark.parametrize("layer", sorted(LAYER_INDEX))
def test_vgg_builds_only_stages_up_to_its_tap(layer):
    """A relu2_2 trunk holds conv0..conv3 and no 256/512-wide stage; its
    names are those of the Flax tree."""
    stage = LAYER_INDEX[layer]
    vgg = VGG16Features(max_stage=stage)
    flax_tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                             _vgg_shapes(stage))
    assert {k: tuple(v.shape) for k, v in vgg.state_dict().items()} == {
        k: tuple(v.shape) for k, v in params_from_jax(flax_tree).items()}
    assert len(vgg(torch.zeros(1, 16, 16, 3))) == stage + 1


def test_vgg_random_init_follows_flax():
    """lecun_normal kernels (std sqrt(1/fan_in), truncated at two of the
    draw's standard deviations), zero biases; from an explicit generator,
    so two inits from one seed are equal."""
    a, b = VGG16Features(max_stage=1), VGG16Features(max_stage=1)
    a.init_flax_default(torch.Generator().manual_seed(3))
    b.init_flax_default(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb)
        if name.endswith("bias"):
            assert not pa.any()
            continue
        fan_in = pa[0].numel()
        std = (1.0 / fan_in) ** 0.5
        assert abs(float(pa.std()) / std - 1.0) < 0.05, name
        assert float(pa.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7


def test_perceptual_loss_matches_jax(pred_target, vgg_tree):
    pred, target = pred_target
    small = jax.tree.map(lambda a: a, vgg_tree)
    with jax.default_matmul_precision("highest"):
        ref = JVGGLoss(params=small, layer="relu2_2")(jnp.asarray(pred),
                                                      jnp.asarray(target))
    loss = VGGPerceptualLoss(params=vgg_tree, layer="relu2_2")
    with torch.no_grad():
        got = loss(t(pred), t(target))
    np.testing.assert_allclose(float(got), float(ref), rtol=VGG_TOL)


def test_perceptual_loss_warns_without_weights():
    with pytest.warns(UserWarning, match="WITHOUT pretrained weights"):
        loss = VGGPerceptualLoss(layer="relu1_2")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        VGGPerceptualLoss(params={"params": {
            k: {"kernel": np.zeros((3, 3, ci, co), np.float32),
                "bias": np.zeros(co, np.float32)}
            for k, ci, co in (("conv0", 3, 64), ("conv1", 64, 64))}},
            layer="relu1_2")
    x = torch.rand(1, 8, 8, 3)
    assert float(loss(x, x)) == 0.0


def test_resize_after_inference_mode_still_trains():
    """A resize first called under inference mode (the eval CLI, the
    engine) caches its interpolation matrix; a later call under autograd
    at the same sizes (the trainer's flow net and loss pyramid) must still
    save it for the backward (ROADMAP §3, fault 3)."""
    from vfi_tpu_torch.ops.resize import _interp_matrix, resize_bilinear

    _interp_matrix.cache_clear()
    with torch.inference_mode():
        resize_bilinear(torch.rand(1, 5, 7, 2), (10, 14))
    x = torch.rand(1, 5, 7, 2, requires_grad=True)
    resize_bilinear(x, (10, 14)).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()

