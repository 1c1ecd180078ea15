"""Shared fixtures of the port's Trainer tests: a tiny directory of PNG
triplets (written with the port's encoder), the qocc recipe's flags at a
tiny width, and warm-start files in the JAX layout."""

import os

import numpy as np

from vfi_tpu_torch import native

# The qocc fine-tune's flags (tools/queueAC.sh), at mid 8, one block, a
# 2-level 8-wide flow net, 32x32 crops and batch 2.
QOCC_TINY = dict(
    batch_size=2, accum_steps=2, remat=True, random_rotation=False,
    consistent_jitter=True, crop_size=(32, 32), target_unit_range=True,
    best_metric="val_psnr", warp_max_flow=16, use_pallas=True,
    ema_decay=0.998, flow_prior=True, flow_photo_pyramid=True,
    fuse_project=True, lr_schedule="cosine", learning_rate=5e-5,
    cosine_min_lr=5e-6, dcn_max_offset=1, cascade_levels=2,
    flow_photo_occlusion=True, mid_channels=8, num_blocks=1,
    flow_mid_channels=8, flow_levels=2, bf16=False, num_epochs=1)


def write_scenes(root, scenes, frames, h=40, w=48, seed=0):
    """`scenes` directories of `frames` PNGs: a random image shifted by
    (f, 2f) pixels in frame f."""
    rng = np.random.default_rng(seed)
    for s in range(scenes):
        d = os.path.join(root, f"scene{s}")
        os.makedirs(d)
        base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for f in range(frames):
            with open(os.path.join(d, f"frame{f:02d}.png"), "wb") as fh:
                fh.write(native.encode_png_rgb(np.roll(base, (f, 2 * f),
                                                       axis=(0, 1))))


def make_data(root):
    """train: 2 scenes x 4 frames (4 triplets, two batches); val: 1 scene
    x 5 frames (3 triplets: one full batch and one padded)."""
    write_scenes(os.path.join(root, "train"), 2, 4, seed=1)
    write_scenes(os.path.join(root, "val"), 1, 5, seed=2)
    return dict(train_data_dir=os.path.join(root, "train"),
                val_data_dir=os.path.join(root, "val"))


def out_paths(root):
    return dict(checkpoint_path=os.path.join(root, "ckpt"),
                best_model_path=os.path.join(root, "best"),
                output_image_path=os.path.join(root, "imgs"))


def write_init(root, seed=0):
    """Warm-start files for the tiny model, flow net and VGG (relu2_2),
    written by the JAX package: random values in the JAX trees' layout
    (kernels at the fan-in scale of torch's init, biases and the DCN's
    offset conv small; with the zero offset conv of JAX's init every
    offset would lie on an integer, where the JAX shifts op and the port
    take different subgradients, ROADMAP §3). Returns the config keys."""
    import jax
    import jax.numpy as jnp

    from vfi_tpu.models import EMAVFI as JEMAVFI
    from vfi_tpu.models.flownet import SimpleFlowNet as JFlowNet
    from vfi_tpu.models.vgg import VGG16Features as JVGG
    from vfi_tpu.utils.convert import save_params_npz

    rng = np.random.default_rng(seed)

    def drawn(s):
        std = (1.0 / np.prod(s.shape[:-1])) ** 0.5 if len(s.shape) > 1 \
            else 0.05
        return rng.normal(0, std, s.shape).astype(np.float32)

    x = jnp.zeros((1, 32, 32, 3))
    key = jax.random.PRNGKey(0)
    model = jax.tree.map(drawn, jax.eval_shape(JEMAVFI(
        mid_channels=8, num_blocks=1, fuse_project=True).init, key, x, x))
    oc = model["params"]["fusion_dcn0"]["offset_conv"]
    for k in oc:
        oc[k] = rng.normal(0, 0.05, oc[k].shape).astype(np.float32)
    flow = jax.tree.map(drawn, jax.eval_shape(JFlowNet(
        mid_channels=8, levels=2).init, key, x, x))
    vgg = jax.tree.map(np.asarray, jax.jit(JVGG(max_stage=1).init)(
        jax.random.PRNGKey(7), x))
    paths = dict(init_model_path=os.path.join(root, "init.npz"),
                 init_flow_path=os.path.join(root, "init.flow.npz"),
                 vgg_weights_path=os.path.join(root, "vgg.npz"))
    for tree, key_ in ((model, "init_model_path"), (flow, "init_flow_path"),
                       (vgg, "vgg_weights_path")):
        save_params_npz(tree, paths[key_])
    return paths


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out
