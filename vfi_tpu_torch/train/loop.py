"""Training loop, the port of `vfi_tpu/train/loop.py`: the train and eval
steps, the sample dump's denormalization and the `Trainer` that drives
epochs of them with checkpoints, exports and per-epoch metrics.

The step is plain eager PyTorch on one card (or the CPU when asked):
- the trained tree is a module: the EMAVFI model, or a ModuleDict
  {"model", "flow"} when the SimpleFlowNet estimator trains jointly (the
  JAX trainer's {"model", "flow"} params); the flow prior pre-warps with
  gradient into the estimator;
- `accum_steps` microbatches run one after another, their gradients
  summed in `.grad` and averaged, with the loss terms, before one update;
- `remat` wraps the EMAVFI forward alone in `torch.utils.checkpoint`, as
  `jax.checkpoint(model.apply)` does; the forward then runs again in the
  backward, so on the card every DCN and warp kernel launches twice a
  microbatch;
- `bf16` means bf16 activations and float32 parameters: the models cast
  at use; `bf16: false` runs float32 activations. `use_pallas` picks the
  model's `use_kernels`: the CUDA kernels (their bf16 or float32
  instances, by the activations' dtype), whose backward is autograd of
  their plain versions (`ops/cuda/grad.py`), or the plain versions
  themselves. A kernel that fails to build or launch raises; nothing
  falls back to the plain version. The trainer leaves `torch.backends`'
  TF32 flags as the caller set them; they reach only the cuDNN convs
  outside the kernels.

The model is never packed (`pack_kernel_weights`): the optimizer moves its
weights, and an unpacked model repacks them on every call, as does the
EMA shadow that val, the sample dump and the exports read.

The loader's threads touch only numpy; every tensor and all autograd work
stay on the thread that calls `run`.

Data parallelism (`mesh.data` > 1): one process a rank of a
`torch.distributed` group (`data_group`; `cli.train` starts them), one
card a rank (or the CPU under gloo). Every rank loads the same global
batch and keeps its rows of each microbatch (`data_rows`), so a
microbatch is the one-process microbatch split over the ranks; after the
last microbatch one `all_reduce` of the flat gradient (the loss terms
ride in the same buffer) averages the ranks before the global-norm clip,
and every rank then takes the same update, its EMA included. The
occlusion-masked photometric term is a ratio of sums over the microbatch,
so its denominator (a scalar without gradient) is summed over the ranks
inside the loss. Val splits each batch the same way and averages the
ranks' metrics. Rank 0 alone writes checkpoints, exports, the sample dump
and logs. A `mesh.spatial` > 1 adds ranks that repeat their data row's
rows, as the JAX trainer's batch sharding replicates the batch over
'spatial': the numbers are the data-only mesh's.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vfi_tpu_torch.data import AugmentConfig, DataLoader, TripletDataset
from vfi_tpu_torch.infer.pair import resolve_device
from vfi_tpu_torch.losses import LossWeights, total_loss, vgg_l1
from vfi_tpu_torch.models import EMAVFI, SimpleFlowNet, prior_prewarp
from vfi_tpu_torch.models.vgg import LAYER_INDEX, VGG16Features
from vfi_tpu_torch.ops.resize import resize_bilinear
from vfi_tpu_torch.ops.warp import warp
from vfi_tpu_torch.parallel import comm
from vfi_tpu_torch.train.checkpoints import (CheckpointManager,
                                             load_params_into,
                                             save_params_npz)
from vfi_tpu_torch.train.state import (CosineScheduler, PlateauScheduler,
                                       TrainState, create_train_state,
                                       set_learning_rate)
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.convert import load_params_npz, params_from_jax
from vfi_tpu_torch.utils.metrics import psnr, ssim

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _unit_range(ft: torch.Tensor) -> torch.Tensor:
    """Invert the ImageNet normalization of the target -> [0, 1]."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(ft.device, ft.dtype)
    std = torch.from_numpy(IMAGENET_STD).to(ft.device, ft.dtype)
    return (ft * std + mean).clamp(0.0, 1.0)


def data_rows(batch_size: int, accum_steps: int, index: int,
              n_data: int) -> np.ndarray:
    """The rows of a global batch that data row `index` of `n_data` takes:
    its contiguous share of each of the `accum_steps` microbatches, in
    microbatch order (so its local batch splits into its microbatches as
    the global one does)."""
    n = batch_size // accum_steps
    m = n // n_data
    return np.concatenate([np.arange(k * n + index * m, k * n + (index + 1)
                                     * m) for k in range(accum_steps)])


def make_train_step(vgg_module: Optional[VGG16Features],
                    vgg_layer_index: int, weights: LossWeights,
                    soft_histogram: bool = False, remat: bool = False,
                    joint_flow: bool = False,
                    target_unit_range: bool = False,
                    flow_prior: bool = False,
                    flow_prior_scale: float = 0.5,
                    accum_steps: int = 1,
                    flow_photo_pyramid: bool = False,
                    flow_photo_occlusion: bool = False,
                    data_group=None) -> Callable:
    """The train step: `train_step(state, f0, ft, f1) -> metrics` runs the
    forward, the loss and the backward of each microbatch and one update
    of `state` in place. The JAX function's `model` and `flow_module` are
    the modules inside `state.params` here (`joint_flow`: the ModuleDict
    {"model", "flow"}); the VGG trunk is frozen. With `data_group` (a
    `torch.distributed` group; `torch.distributed.group.WORLD` for the
    default one) the batch is this rank's rows (`data_rows`) and the step
    is the data-parallel one of the module docstring; None: one process.

    With `joint_flow` the temporal term is live and the estimator trains
    on a photometric term of its own, |warp(f1, flow01) - f0|, masked by
    the forward-backward occlusion test (`flow_photo_occlusion`, taken
    without gradient) and repeated at 1/2 and 1/4 scale
    (`flow_photo_pyramid`)."""

    def vgg_loss_fn(a, b):
        return vgg_l1(vgg_module, vgg_layer_index, a, b)

    world = 1 if data_group is None else comm.size(data_group)

    def masked_photo(err: torch.Tensor, w: Optional[torch.Tensor]):
        """Mean |err| over the pixels `w` keeps (a plain mean without it).
        The weight sum runs over the whole microbatch: over the ranks
        where the step is data-parallel, this rank's share of the term
        then scaled by the ranks, whose average makes the term."""
        if w is None:
            return err.mean()
        if data_group is None:
            return (err * w).sum() / (w.sum() * err.shape[-1] + 1e-6)
        den = comm.all_reduce_sum(w.sum().detach(), data_group)
        return (err * w).sum() * world / (den * err.shape[-1] + 1e-6)

    def loss_fn(params, f0, ft, f1):
        model = params["model"] if joint_flow else params
        flow_fn = params["flow"] if joint_flow else None
        flow01 = None
        if flow_prior:
            f1_in, flow01 = prior_prewarp(flow_fn, f0, f1,
                                          scale=flow_prior_scale)
        else:
            f1_in = f1
        if remat:
            pred = checkpoint(model, f0, f1_in, use_reentrant=False)
        else:
            pred = model(f0, f1_in)
        if target_unit_range:
            ft = _unit_range(ft)
        tot, terms = total_loss(
            pred, ft, vgg_loss_fn if vgg_module is not None else None,
            weights, soft_histogram=soft_histogram, flow_estimator=flow_fn,
            frame0=f0, frame1=f1)
        if not joint_flow:
            return tot, terms
        if flow01 is None:
            flow01 = flow_fn(f0, f1)
        occ_w = None
        if flow_photo_occlusion:
            # Non-occluded pixels satisfy flow01 ~= -flow10(warped); the
            # mask gates the term, it does not train.
            with torch.no_grad():
                bw_w = warp(flow_fn(f1, f0), flow01)
                incons = (flow01 + bw_w).square().sum(-1, keepdim=True)
                mag2 = (flow01.square().sum(-1, keepdim=True)
                        + bw_w.square().sum(-1, keepdim=True))
                occ_w = (incons <= 0.01 * mag2 + 0.5).to(f0.dtype)
            terms["flow_occ_frac"] = 1.0 - occ_w.mean()
        photo = masked_photo((warp(f1, flow01) - f0).abs(), occ_w)
        terms["flow_photo"] = photo
        tot = tot + weights.temporal * photo
        if flow_photo_pyramid:
            hh, ww = f0.shape[1], f0.shape[2]
            for s in (2, 4):
                size = (hh // s, ww // s)
                fl_s = resize_bilinear(flow01, size) / s
                w_s = (None if occ_w is None
                       else resize_bilinear(occ_w, size).detach())
                p_s = masked_photo((warp(resize_bilinear(f1, size), fl_s)
                                     - resize_bilinear(f0, size)).abs(), w_s)
                terms[f"flow_photo_s{s}"] = p_s
                tot = tot + weights.temporal * p_s / s
        return tot, terms

    def train_step(state: TrainState, f0, ft, f1) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        n = f0.shape[0] // accum_steps
        sums = {}
        for k in range(accum_steps):
            sl = slice(k * n, (k + 1) * n)
            tot, terms = loss_fn(state.params, f0[sl], ft[sl], f1[sl])
            tot.backward()
            for key, v in {"loss": tot, **terms}.items():
                sums[key] = sums.get(key, 0.0) + v.detach()
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            sums = {k: v * inv for k, v in sums.items()}
            grads = [p.grad for p in state.leaves() if p.grad is not None]
            torch._foreach_mul_(grads, inv)
        if data_group is not None:
            sums = _average_over_ranks(state, sums, data_group)
        return {**sums, "grad_norm": state.apply_gradients()}

    return train_step


def _average_over_ranks(state: TrainState, sums: dict, group) -> dict:
    """One all_reduce of every gradient and the loss terms in one flat
    float32 buffer, divided by the ranks; the gradients go back into
    `.grad`, the averaged terms are returned."""
    leaves = state.leaves()
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    keys = list(sums)
    flat = torch.cat([p.grad.reshape(-1).float() for p in leaves]
                     + [torch.stack([sums[k].float().reshape(())
                                     for k in keys])])
    flat = comm.all_reduce_sum(flat, group) / comm.size(group)
    o = 0
    for p in leaves:
        n = p.numel()
        p.grad.copy_(flat[o:o + n].view_as(p.grad))
        o += n
    return dict(zip(keys, flat[o:]))


def make_eval_step(weights: LossWeights, soft_histogram: bool = False,
                   target_unit_range: bool = False,
                   flow_prior: bool = False,
                   flow_prior_scale: float = 0.5) -> Callable:
    """Val step: `eval_step(params, f0, ft, f1) -> metrics`, the loss (no
    VGG, no temporal term) and the mean PSNR / SSIM against the target
    un-normalized to [0, 1]. With `flow_prior`, `params` is the joint
    ModuleDict and val runs the same pre-warp as training; otherwise it is
    the model."""

    @torch.no_grad()
    def eval_step(params, f0, ft, f1) -> dict:
        model = params
        if flow_prior:
            f1, _ = prior_prewarp(params["flow"], f0, f1,
                                  scale=flow_prior_scale)
            model = params["model"]
        pred = model(f0, f1)
        gt01 = _unit_range(ft)
        tot, terms = total_loss(pred, gt01 if target_unit_range else ft,
                                None, weights, soft_histogram=soft_histogram)
        return {"loss": tot, **terms, "psnr": psnr(pred, gt01).mean(),
                "ssim": ssim(pred, gt01).mean()}

    return eval_step


def denormalize_to_uint8(img01: np.ndarray) -> np.ndarray:
    """The reference's sample-dump path: treat the [0, 1] output as if it
    were ImageNet-normalized, invert, clip, scale to uint8."""
    img = img01 * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _silent(msg: str) -> None:
    pass


def mesh_axes(data: int, spatial: int, ranks: int) -> tuple:
    """(data, spatial) of a training mesh over `ranks` ranks: data -1
    takes every rank `spatial` leaves (`parallel.make_mesh`'s rule)."""
    if spatial <= 0:
        raise ValueError(f"spatial axis must be >= 1, got {spatial}")
    if data == -1:
        if ranks % spatial != 0:
            raise ValueError(f"{ranks} ranks not divisible by "
                             f"spatial={spatial}")
        data = ranks // spatial
    if data <= 0:
        raise ValueError(f"data axis must be >= 1 or -1, got {data}")
    return data, spatial


class Trainer:
    """End-to-end training: `Trainer(config).run()`.

    Runs on the card unless `device` names another (`resolve_device`:
    without a card it raises RuntimeError). The mesh (`mesh.data` x
    `mesh.spatial`, data -1: every rank spatial leaves) must take every
    rank of `data_group` (None: one process), and the batch must split
    over 'data' and, with accumulation, each microbatch too, as the JAX
    trainer requires. A KeyboardInterrupt saves a checkpoint of the
    epoch in progress with the steps it has done; `resume` continues at
    the next step (the JAX trainer skips the rest of that epoch instead).
    `epoch_stats` keeps, a completed epoch, the
    train loop's seconds and samples, the seconds its steps waited for
    host batches, each optimizer step's milliseconds (synchronised: the
    loss is read back every step), and the val, export and checkpoint
    seconds."""

    def __init__(self, config: TrainConfig, device=None, data_group=None):
        self.cfg = cfg = config
        if cfg.best_metric not in ("val_loss", "val_psnr"):
            raise ValueError(f"unknown best_metric {cfg.best_metric!r} "
                             "(expected 'val_loss' or 'val_psnr')")
        self.data_group = data_group
        world = 1 if data_group is None else comm.size(data_group)
        n_data, n_spatial = mesh_axes(cfg.mesh.data, cfg.mesh.spatial, world)
        if n_data * n_spatial != world:
            raise ValueError(
                f"mesh {n_data}x{n_spatial} needs {n_data * n_spatial} "
                f"ranks, have {world}: start them with "
                f"`python -m vfi_tpu_torch.cli.train`")
        if cfg.batch_size % n_data != 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} must be divisible by the "
                f"'data' mesh axis ({n_data}); set mesh.data explicitly "
                f"(e.g. --mesh.data {max(1, cfg.batch_size)}) or raise "
                f"batch_size")
        if cfg.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {cfg.accum_steps}")
        if cfg.batch_size % cfg.accum_steps:
            raise ValueError(
                f"batch_size {cfg.batch_size} must be divisible by "
                f"accum_steps {cfg.accum_steps} so that each microbatch "
                "has the same size")
        if cfg.accum_steps > 1 and cfg.batch_size % (cfg.accum_steps
                                                     * n_data):
            raise ValueError(
                f"batch_size {cfg.batch_size} must be divisible by "
                f"accum_steps * data-axis ({cfg.accum_steps} * {n_data}) "
                "so each microbatch still shards evenly over the mesh")
        self.rank = 0 if data_group is None else comm.rank(data_group)
        self.leader = self.rank == 0
        self.n_data = n_data
        self.data_index = self.rank // n_spatial
        self.device = dev = resolve_device(device)
        dtype = torch.bfloat16 if cfg.bf16 else None
        self.joint_flow = cfg.temporal_weight > 0 and cfg.train_flow_estimator
        if cfg.flow_prior and not self.joint_flow:
            raise ValueError(
                "flow_prior=true requires train_flow_estimator=true and "
                "temporal_weight > 0 — the prior network IS the jointly-"
                "trained flow estimator (models/prior.py)")
        if cfg.init_flow_path and not self.joint_flow:
            raise ValueError("init_flow_path requires "
                             "train_flow_estimator=true")

        # Fresh parameters from the seed (torch's own init; a fine-tune
        # overwrites them from init_model_path / init_flow_path).
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.model = EMAVFI(
                in_channels=cfg.in_channels, mid_channels=cfg.mid_channels,
                num_blocks=cfg.num_blocks, dtype=dtype,
                dcn_max_offset=cfg.dcn_max_offset,
                warp_max_flow=cfg.warp_max_flow,
                cascade_levels=cfg.cascade_levels,
                fuse_project=cfg.fuse_project, conv_kernel=cfg.conv_kernel,
                use_kernels=cfg.use_pallas)
            self.flow_module = None
            if self.joint_flow:
                torch.manual_seed(cfg.seed + 2)
                self.flow_module = SimpleFlowNet(
                    in_channels=cfg.in_channels,
                    mid_channels=cfg.flow_mid_channels,
                    levels=cfg.flow_levels, dtype=dtype)
        if cfg.init_model_path:
            self._load_init(cfg.init_model_path, self.model, "model")
        if cfg.init_flow_path:
            self._load_init(cfg.init_flow_path, self.flow_module, "flow")
        params = (nn.ModuleDict({"model": self.model,
                                 "flow": self.flow_module})
                  if self.joint_flow else self.model)
        params.to(dev)

        self.vgg_layer_index = LAYER_INDEX[cfg.vgg_layer]
        self.vgg_module = None
        if cfg.vgg_weight > 0:      # vgg_weight 0: no VGG built or run
            self.vgg_module = VGG16Features(max_stage=self.vgg_layer_index,
                                            dtype=dtype)
            if cfg.vgg_weights_path:
                self.vgg_module.load_params(
                    load_params_npz(cfg.vgg_weights_path))
            else:
                self.vgg_module.init_flax_default(
                    torch.Generator().manual_seed(cfg.seed + 1))
            self.vgg_module.requires_grad_(False).to(dev).eval()

        self.state = create_train_state(params, cfg.learning_rate,
                                        cfg.weight_decay, cfg.grad_clip_norm)
        if cfg.lr_schedule == "cosine":
            self.scheduler = CosineScheduler(
                lr0=cfg.learning_rate, total=cfg.num_epochs,
                period=cfg.cosine_restart_period, min_lr=cfg.cosine_min_lr)
        elif cfg.lr_schedule == "plateau":
            self.scheduler = PlateauScheduler(lr=cfg.learning_rate,
                                              factor=cfg.plateau_factor,
                                              patience=cfg.plateau_patience,
                                              min_lr=cfg.plateau_min_lr)
        else:
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                             "(expected 'plateau' or 'cosine')")
        self.weights = LossWeights(
            charbonnier=cfg.charbonnier_weight, vgg=cfg.vgg_weight,
            color=cfg.color_weight, gradient=cfg.gradient_weight,
            temporal=cfg.temporal_weight)
        if cfg.temporal_weight > 0 and not self.joint_flow:
            print("[vfi_tpu_torch] temporal_weight > 0 with "
                  "train_flow_estimator disabled — the temporal term is "
                  "inactive (this matches the reference's shipped "
                  "behavior).")

        jit = cfg.color_jitter
        aug = AugmentConfig(
            crop_size=tuple(cfg.crop_size),
            random_rotation=cfg.random_rotation,
            horizontal_flip=cfg.horizontal_flip,
            brightness=jit.brightness if jit else 0.0,
            contrast=jit.contrast if jit else 0.0,
            saturation=jit.saturation if jit else 0.0,
            hue=jit.hue if jit else 0.0,
            color_jitter=jit is not None,
            random_grayscale=cfg.random_grayscale,
            consistent_jitter=cfg.consistent_jitter)
        self.train_data = TripletDataset(cfg.train_data_dir,
                                         cfg.frame_interval, aug)
        # Val: deterministic crops (the val loader's epoch is pinned to 0),
        # no other augmentation.
        val_aug = AugmentConfig(crop_size=tuple(cfg.crop_size),
                                random_rotation=False, horizontal_flip=False,
                                color_jitter=False, random_grayscale=0.0)
        self.val_data = TripletDataset(cfg.val_data_dir, cfg.frame_interval,
                                       val_aug)
        self.train_loader = DataLoader(self.train_data, cfg.batch_size,
                                       shuffle=True, seed=cfg.seed)
        self.val_loader = DataLoader(self.val_data, cfg.batch_size,
                                     shuffle=False, seed=cfg.seed,
                                     drop_last=False)

        self.train_step = make_train_step(
            self.vgg_module, self.vgg_layer_index, self.weights,
            cfg.soft_histogram, remat=cfg.remat, joint_flow=self.joint_flow,
            target_unit_range=cfg.target_unit_range,
            flow_prior=cfg.flow_prior, flow_prior_scale=cfg.flow_prior_scale,
            accum_steps=cfg.accum_steps,
            flow_photo_pyramid=cfg.flow_photo_pyramid,
            flow_photo_occlusion=cfg.flow_photo_occlusion,
            data_group=data_group)
        self.eval_step = make_eval_step(
            self.weights, cfg.soft_histogram,
            target_unit_range=cfg.target_unit_range,
            flow_prior=cfg.flow_prior, flow_prior_scale=cfg.flow_prior_scale)

        # The params-tree accessors: joint flow training nests the model;
        # the flow prior's forward takes the joint tree.
        self._model_params = ((lambda p: p["model"]) if self.joint_flow
                              else (lambda p: p))
        self._fwd_params = ((lambda p: p) if cfg.flow_prior
                            else self._model_params)

        # Parameter EMA (ema_decay > 0): a shadow tree, updated after every
        # step, that val, the sample dump and the exports read.
        self.ema_params = None
        self._ema_decay = None
        if cfg.ema_decay > 0.0:
            if not 0.0 < cfg.ema_decay < 1.0:
                raise ValueError(f"ema_decay must be in (0, 1), got "
                                 f"{cfg.ema_decay}")
            self._ema_decay = float(cfg.ema_decay)
            self.ema_params = self._shadow(params)

        self.ckpt = CheckpointManager(cfg.checkpoint_path,
                                      keep=cfg.keep_checkpoints)
        self.start_epoch = 0
        self.best_val = float("inf")
        if (cfg.resume and self.ckpt.latest_epoch() is None
                and self.ckpt.orbax_steps()):
            raise RuntimeError(
                f"{self.ckpt.path} holds the JAX trainer's orbax checkpoints "
                f"(steps {self.ckpt.orbax_steps()}) and no checkpoint of the "
                f"port: orbax cannot be read here, and starting afresh would "
                f"write a new best export over that run's; choose another "
                f"checkpoint_path (or set resume false)")
        # (steps done, their summed train loss) of the epoch a resume
        # starts inside: an interrupted epoch resumes at its next step.
        self._partial = (0, 0.0)
        if cfg.resume and self.ckpt.latest_epoch() is not None:
            self.state, last_epoch = self.ckpt.restore(self.state,
                                                       self.scheduler)
            done = int(self.ckpt.last_meta["batches_done"])
            if done >= 0:
                self.start_epoch = last_epoch
                self._partial = (done, self.ckpt.last_meta["train_running"])
            else:
                self.start_epoch = last_epoch + 1
            restored_best = float(self.ckpt.last_meta.get("best_val",
                                                          float("nan")))
            # best_metric val_psnr stores -PSNR (negative), val_loss the
            # loss: a watermark of the other sign is from the other metric.
            wrong_space = (restored_best < 0.0) != (cfg.best_metric
                                                    == "val_psnr")
            if np.isfinite(restored_best) and not wrong_space:
                self.best_val = restored_best
            elif np.isfinite(restored_best):
                print("[vfi_tpu_torch] best_val watermark from the checkpoint "
                      "is in a different score space than "
                      f"best_metric={cfg.best_metric!r} — resetting (first "
                      "post-resume epoch becomes the best)")
            at = (f"inside epoch {last_epoch + 1} after {done} steps"
                  if done >= 0 else f"after epoch {last_epoch + 1}")
            print(f"[vfi_tpu_torch] resumed {at} (step {self.state.step}, "
                  f"lr {self.scheduler.lr:.6f}, best val "
                  f"{self.best_val:.4f})")
            if self.ema_params is not None:
                ema_path = os.path.join(cfg.checkpoint_path, "ema_latest.npz")
                if os.path.exists(ema_path):
                    load_params_into(self.ema_params,
                                     load_params_npz(ema_path))
                else:   # EMA newly enabled on an old run: restart it
                    self.ema_params = self._shadow(self.state.params)
        os.makedirs(cfg.output_image_path, exist_ok=True)
        self.epoch_stats: list = []
        # [epoch in progress, its steps done, their summed train loss]
        self._progress = [self.start_epoch, *self._partial]

    @staticmethod
    def _shadow(params: nn.Module) -> nn.Module:
        shadow = copy.deepcopy(params)
        shadow.requires_grad_(False)
        return shadow

    def _load_init(self, path: str, module: nn.Module, what: str) -> None:
        """Warm start from an exported `.npz`: every configured parameter
        must be there with its shape."""
        loaded = params_from_jax(load_params_npz(path))
        own = module.state_dict()
        if set(loaded) != set(own):
            raise ValueError(
                f"init_{what}_path {path!r} does not match the configured "
                f"{what} params: keys {sorted(set(loaded) ^ set(own))} "
                "differ — check mid_channels/num_blocks/fuse_project/flow_* "
                "settings")
        for k, t in own.items():
            if tuple(loaded[k].shape) != tuple(t.shape):
                raise ValueError(
                    f"init_{what}_path {path!r} does not match the "
                    f"configured {what} params: shape "
                    f"{tuple(loaded[k].shape)} of {k} does not match "
                    f"configured {what} param {tuple(t.shape)} — check "
                    "mid_channels/num_blocks/flow_* settings")
        module.load_state_dict(loaded)

    def _eval_tree(self) -> nn.Module:
        """The params val, the sample dumps and the exports use: the EMA
        shadow when it is on, the live params otherwise."""
        return (self.ema_params if self.ema_params is not None
                else self.state.params)

    @torch.no_grad()
    def _ema_update(self) -> None:
        d = self._ema_decay
        ema = list(self.ema_params.parameters())
        live = [p.detach() for p in self.state.params.parameters()]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, live, alpha=1.0 - d)

    def _save_ema(self) -> None:
        if self.ema_params is not None:
            save_params_npz(self.ema_params,
                            os.path.join(self.cfg.checkpoint_path,
                                         "ema_latest.npz"))

    @torch.no_grad()
    def _sample_fwd(self, params, f0, f1) -> torch.Tensor:
        if self.cfg.flow_prior:
            f1, _ = prior_prewarp(params["flow"], f0, f1,
                                  scale=self.cfg.flow_prior_scale)
            params = params["model"]
        return params(f0, f1)

    def _device_batches(self, loader, wait: Optional[list] = None,
                        skip: int = 0, accum: int = 1):
        """Iterate a host loader with one batch of lookahead: the next
        batch is copied to the device (pinned memory, non-blocking) while
        the current one computes. A short last batch is padded with its
        last sample; this rank keeps its rows (`data_rows` over `accum`
        microbatches); yields (device batch, true size of the global
        batch). `wait`, a one-element list, accumulates the seconds spent
        blocked on the loader; the first `skip` batches are dropped on the
        host (a resumed epoch's steps already done)."""
        full, dev = loader.batch_size, self.device
        rows = (None if self.n_data == 1 else
                data_rows(full, accum, self.data_index, self.n_data))

        def prep(host_batch):
            n = host_batch[0].shape[0]
            if n < full:
                host_batch = tuple(
                    np.concatenate([a, np.repeat(a[-1:], full - n, axis=0)])
                    for a in host_batch)
            if rows is not None:
                host_batch = tuple(a[rows] for a in host_batch)
            ts = [torch.from_numpy(np.ascontiguousarray(a))
                  for a in host_batch]
            if dev.type == "cuda":
                ts = [t.pin_memory().to(dev, non_blocking=True) for t in ts]
            else:
                ts = [t.to(dev) for t in ts]
            return tuple(ts), n

        it = iter(loader)
        for _ in range(skip):
            next(it, None)

        def pull():
            t0 = time.perf_counter()
            try:
                return next(it)
            finally:
                if wait is not None:
                    wait[0] += time.perf_counter() - t0

        try:
            try:
                pending = prep(pull())
            except StopIteration:
                return
            while True:
                try:
                    nxt = prep(pull())
                except StopIteration:
                    break
                yield pending
                pending = nxt
            yield pending
        finally:
            it.close()

    def _log_metrics(self, record: dict) -> None:
        """One JSON line an epoch in <checkpoint_path>/metrics.jsonl."""
        os.makedirs(self.cfg.checkpoint_path, exist_ok=True)
        with open(os.path.join(self.cfg.checkpoint_path, "metrics.jsonl"),
                  "a") as f:
            f.write(json.dumps(record) + "\n")

    def _dump_sample(self, pred: torch.Tensor, epoch: int) -> None:
        from vfi_tpu_torch import native

        img = denormalize_to_uint8(pred[0].float().cpu().numpy())
        with open(os.path.join(self.cfg.output_image_path,
                               f"epoch_{epoch + 1}_generated.png"),
                  "wb") as f:
            f.write(native.encode_png_rgb(img))

    def run(self, num_epochs: Optional[int] = None,
            log: Callable[[str], None] = print) -> dict:
        num_epochs = num_epochs if num_epochs is not None \
            else self.cfg.num_epochs
        if not self.leader:
            log = _silent
        history = {"train_loss": [], "val_loss": [], "psnr": [], "ssim": []}
        try:
            self._run_epochs(num_epochs, history, log)
        except KeyboardInterrupt:
            # Save a resumable checkpoint at the in-progress epoch's index,
            # with the best-model watermark and the steps that epoch has
            # done: a resume runs the rest of it, so that an interrupted
            # run ends where an uninterrupted one does.
            if not self.leader:
                raise
            log("[vfi_tpu_torch] interrupted — saving checkpoint for resume")
            epoch, done, running = self._progress
            last_val = (history["val_loss"][-1] if history["val_loss"]
                        else float("nan"))
            self.ckpt.save(epoch, self.state, self.scheduler,
                           extra={"val_loss": last_val,
                                  "best_val": self.best_val,
                                  "batches_done": done,
                                  "train_running": running})
            self._save_ema()
            self.ckpt.wait()
            raise
        return history

    def _run_epochs(self, num_epochs, history, log):
        cfg = self.cfg
        for epoch in range(self.start_epoch, num_epochs):
            prof = None
            if cfg.profile_dir and epoch == self.start_epoch:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if self.device.type == "cuda"
                    else [])
                prof = profile(activities=acts)
                prof.__enter__()
            # ---- train ----
            t0 = time.time()
            tp = time.perf_counter()
            _, nb, running = self._progress
            skip, wait, step_ms = nb, [0.0], []
            self.train_loader.epoch = epoch
            for i, (batch, _) in enumerate(
                    self._device_batches(self.train_loader, wait, skip,
                                         cfg.accum_steps),
                    start=skip):
                ts = time.perf_counter()
                metrics = self.train_step(self.state, *batch)
                if self.ema_params is not None:
                    self._ema_update()
                running += float(metrics["loss"])
                step_ms.append((time.perf_counter() - ts) * 1e3)
                nb += 1
                self._progress[1:] = [nb, running]
                if i == 0 and self.leader:
                    pred = self._sample_fwd(
                        self._fwd_params(self._eval_tree()), batch[0][:1],
                        batch[2][:1])
                    self._dump_sample(pred, epoch)
                if i % cfg.log_every == 0:
                    terms = {k: round(float(v), 4)
                             for k, v in metrics.items()}
                    log(f"[epoch {epoch + 1}/{num_epochs}] step {i}/"
                        f"{len(self.train_loader)} {terms}")
            train_loss = running / max(nb, 1)   # read back: synchronised
            train_s = time.perf_counter() - tp

            # ---- validate (remainder batches weighted by true size) ----
            tv = time.perf_counter()
            self.val_loader.epoch = 0
            val_running, vp, vs, vn = 0.0, 0.0, 0.0, 0
            for batch, true_n in self._device_batches(self.val_loader):
                m = self.eval_step(self._fwd_params(self._eval_tree()),
                                   *batch)
                if self.data_group is not None:
                    keys = ("loss", "psnr", "ssim")
                    avg = comm.all_reduce_sum(
                        torch.stack([m[k].float() for k in keys]),
                        self.data_group) / comm.size(self.data_group)
                    m = dict(zip(keys, avg))
                w = true_n
                val_running += float(m["loss"]) * w
                vp += float(m["psnr"]) * w
                vs += float(m["ssim"]) * w
                vn += w
            val_loss = val_running / max(vn, 1)
            val_psnr, val_ssim = vp / max(vn, 1), vs / max(vn, 1)
            val_s = time.perf_counter() - tv
            dt = time.time() - t0
            log(f"[epoch {epoch + 1}/{num_epochs}] train {train_loss:.4f} "
                f"val {val_loss:.4f} PSNR {val_psnr:.2f} SSIM "
                f"{val_ssim:.4f} lr {self.scheduler.lr:.6f} ({dt:.1f}s)")
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["psnr"].append(val_psnr)
            history["ssim"].append(val_ssim)
            if self.leader:
                self._log_metrics({"epoch": epoch + 1,
                                   "train_loss": train_loss,
                                   "val_loss": val_loss, "val_psnr": val_psnr,
                                   "val_ssim": val_ssim,
                                   "lr": self.scheduler.lr,
                                   "seconds": round(dt, 2),
                                   "step": int(self.state.step)})

            # ---- best-model export, gated on best_metric ----
            te = time.perf_counter()
            score = -val_psnr if cfg.best_metric == "val_psnr" else val_loss
            if score < self.best_val:
                self.best_val = score
                if self.leader:
                    save_params_npz(self._model_params(self._eval_tree()),
                                    cfg.best_model_path + ".npz")
                    if self.joint_flow:
                        save_params_npz(self._eval_tree()["flow"],
                                        cfg.best_model_path + ".flow.npz")
                what = (f"val PSNR {val_psnr:.3f}"
                        if cfg.best_metric == "val_psnr"
                        else f"val loss {val_loss:.4f}")
                log(f"  new best {what} -> {cfg.best_model_path}.npz")

            if cfg.snapshot_every > 0 and (epoch + 1) % \
                    cfg.snapshot_every == 0 and self.leader:
                snap_dir = os.path.join(cfg.checkpoint_path, "snapshots")
                os.makedirs(snap_dir, exist_ok=True)
                save_params_npz(self._model_params(self._eval_tree()),
                                os.path.join(snap_dir,
                                             f"epoch_{epoch + 1}.npz"))
            export_s = time.perf_counter() - te

            # ---- schedule + checkpoint ----
            tc = time.perf_counter()
            set_learning_rate(self.state, self.scheduler.step(val_loss))
            if self.leader:
                self.ckpt.save(epoch, self.state, self.scheduler,
                               extra={"val_loss": val_loss,
                                      "best_val": self.best_val})
                self._save_ema()
            self._progress = [epoch + 1, 0, 0.0]
            self.epoch_stats.append({
                "epoch": epoch + 1, "train_seconds": train_s,
                "train_samples": (nb - skip) * self.train_loader.batch_size,
                "host_wait_seconds": wait[0], "step_ms": step_ms,
                "val_seconds": val_s, "val_samples": vn,
                "export_seconds": export_s,
                "checkpoint_seconds": time.perf_counter() - tc})
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(cfg.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    cfg.profile_dir, f"trace_epoch_{epoch + 1}.json"))
        self.ckpt.wait()
        return history
