#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vfi_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line with its `seconds`; any failure raises
and the script exits non-zero without a result line:

1. card    the card's name and power limit (nvidia-smi);
2. build   the `nvcc` build of `vfi_tpu_torch/csrc/*.cu` (one process per
           source, in parallel, then one link), and the C++ build of the
           PNG codec and the loader's crop core
           (`vfi_tpu_torch/native/png.cpp`) with this machine's compiler;
           each float32 conv / DCN kernel instance's registers, stack
           frame, spills and TF32 MMAs (`tf32_kernels`: `cuobjdump -sass`
           of the library; fails if one spills, has a stack frame or has
           no TF32 HMMA);
2b. native a Middlebury val frame decoded by the port, then
           `native.crop_flip_normalize` at NATIVE_WINDOWS, with and
           without hflip and ImageNet normalization, each bit for bit
           against numpy's arithmetic on the same window; a window past
           the image refused;
3. kernels each CUDA kernel at every shape a path below launches (and
           the shapes of the kernels' contracts that none does: the DCN at
           C=67 R=4 and R=8 and C=128 R=4 and R=8, the conv at k=1 and
           k=5, the wide warp at R=4 and at C=67) in bf16, held against
           its plain PyTorch version (max abs error within the stated
           tolerance; the warps bit for bit),
           then timed with CUDA events (`ms`: median of N_TIMED
           synchronised calls after warm-up, the wrapper's host path
           included; `device_ms`: per launch of N_BACK_TO_BACK launches
           queued back to back) beside its plain version, one PyTorch
           library call where one computes the same function (`library_ms`,
           `library_device_ms`), and its bound from bytes and operations
           (`x_bound`: device_ms over it); each DCN row names its design
           ("tile" or "stream") and plan, each warp row its instance
           ("rgb", or "wide16" / "wide2b": the wide kernel's 16-byte or
           2-byte instance), each conv row its tile plan (a one-layer chain
           runs the conv kernel, csrc/conv2d.cu); a chain of 2-4 layers
           has a row for each wrapper (`chain_route` "layers":
           `conv_chain`, one conv-kernel launch a layer, which the paths
           run; "fused": `conv_chain_fused`, the chain kernel, which no
           path runs), and cuDNN layer by layer as its library time (a
           sequence of calls). Then the
           float32 instances (rows named `..._f32`, `f32_rows`): each of
           the eight TPU kernels at its bf16 row's shape and every shape
           the float32 phases launch (a float32 chain of 2-4 layers
           through both wrappers too: the layers and the fused kernel's
           float32 instance), against the float32 plain versions
           (TF32 off) within F32_REL_TOL (conv, DCN) and F32_WARP_TOL
           (warps; `bit_exact` says whether they were), their bounds with
           every float32 product as three TF32 passes on the tensor cores
           (`ffma_bound_ms` beside it: every product at the float32 FFMA
           peak), library calls in float32;
4. main    the flagship engine (qocc checkpoint + flow prior, bf16,
           dcn_max_offset=1, warp_max_flow=16, cascade_levels=2,
           conv_kernel="pallas") answers three b=1 requests and one b=2
           request at 1280x720 on the card: launch counts (8 conv-chain,
           3 DCN, 1 warp, 1 conv per engine launch: PER_LAUNCH; "8 / 3 /
           1" below counts the conv-chain, DCN and warp launches and
           implies the fuse projection's conv where the engine is the bf16
           flagship's), no input copied by a wrapper, a replayed launch
           running CAT_KERNELS_GONE fewer concatenation kernels than an
           eager launch of the forward that concatenates, finite outputs
           in [0, 1], PSNR against the same engine run through the plain
           versions on the card, frames/s;
5. serve   (a) the flagship engine with io_uint8 behind the HTTP server
           (`vfi_tpu_torch.serve`, the serve CLI's batcher defaults:
           max_batch 8, 5 ms, 5M px a launch), warmed for 720p pairs and
           5-frame sequences, under a fixed mix from the load generator
           (`tools.bench_serve.run_load`) at 1280x720: 32 raw requests
           from 8 clients, 8 PNG pairs from 4, 4 five-frame sequences
           from 2. Every response 200, 8 / 3 / 1 launches per engine
           launch, every midpoint within PSNR_FLOOR_DB of the same pair
           through the plain-version engine, PNG and raw responses of one
           pair within SERVE_PNG_RAW_LEVELS; per route requests/s,
           midpoints/s, p50 / p99 latency, the batcher's snapshot, and
           the share of the route's wall time the batcher's worker spent
           in launches (stacking, upload, engine, download).
           (b) the serve CLI's own server (`cli.serve.build_server`) at
           the JAX CLI's defaults (exact DCN, unbounded warp): two raw
           requests at 640x480, uint8 midpoints, no kernel launched;
6. video   the flagship engine (float io, as the JAX video path runs it)
           behind `infer.video.interpolate_video`, with a source and a
           sink held in memory (the card's machine has cv2, but no codec
           may stand between the frames and the checks below, which hold
           each source frame bit for bit): VIDEO_FRAMES
           smooth 1280x720 BGR frames of a steady shift at VIDEO_FPS
           (factor 3: two bisection levels of `recursive`), VIDEO_BATCH
           pairs a batch (the engine's 4M-pixel guard runs each as two b=4
           launches). 9 + 8 x 3 frames written in order, each source frame
           bit-equal to its input, each engine output finite, each inserted
           frame within PSNR_FLOOR_DB of the same pipeline through the
           plain-version engine, 8 / 3 / 1 launches per engine launch;
           frames written per second (the pipeline's wall time) and the
           share of it the engine's forwards span on the device. Then one
           reference_compat pass over VIDEO_COMPAT_FRAMES frames: the
           reference CLI's order, duplicates and shift;
7. videos  VIDEOS_CLIPS clips of VIDEOS_FRAMES 1280x720 frames at 30 fps
           (factor 1) through `infer.multi.interpolate_videos` and the
           port's MicroBatcher (VIDEOS_BATCHER): every midpoint within
           PSNR_FLOOR_DB of the plain-version engine, source frames
           bit-equal, launches holding pairs of both clips, 8 / 3 / 1
           launches per engine launch; midpoints/s;
8. infer_cli `cli.infer.main(["two-frame", ...])` with the flagship flags
           on a Middlebury val pair (640x480) decoded by the port, then
           with `--size 360 640`: the written PNG, decoded again, equals
           the engine's own midpoint truncated to uint8 bit for bit, one
           engine launch with 8 / 3 / 1 kernel launches;
9. q12     the 67-channel reference topology (q12: no fuse_proj, R=2)
           with conv_kernel="pallas" on one b=4 batch of Middlebury val
           frames: 8 / 3 / 1 launches, PSNR against its plain-version
           engine (the 67-wide chains and DCN run in the kernels);
           then `q12_r8`: the same batch at dcn_max_offset=8 (a radius
           the JAX engine takes too), whose three DCNs run the stream
           design, counted by shape, against its plain-version engine;
10. eval   the Middlebury eval entry point (`vfi_tpu_torch.cli.eval.sweep`)
           over data/processed/val at batch 4, bf16, conv_kernel="xla"
           and use_pallas, as the JAX package's records were made: qocc
           native, qocc with auto_scale 9.0 + TTA, and q12. Each mean PSNR
           within 0.05 dB and mean SSIM within 0.002 of its record
           (`artifacts/*_eval.json`), 3 DCN and 1 warp launches per model
           forward and no chain launch; per-scene rows, the auto_scale
           probes, seconds and pairs/s; then `eval_epe`: the eval CLI's
           flow-EPE mode (`cli.eval.main`) on the qocc estimator over the
           8 Middlebury GT scenes (frames from data/processed/train), the
           mean within EPE_TOL_PX of artifacts/qocc_epe.json, and the
           estimator's flow on the first scene through `utils.flo`'s
           `write_flo` and `read_flo`: the file's size, its flow bit for
           bit, its EPE within EPE_TOL_PX of the CLI's for that scene;
10b. train the qocc fine-tune recipe (TRAIN_RECIPE) at full width
           through `train.Trainer` for one epoch, warm-started from the
           flagship, random-feature VGG, into a temporary directory:
           `train_fidelity` (one microbatch's loss and gradient through
           the kernels against the plain route, from the same params:
           TRAIN_LOSS_RTOL, TRAIN_GRAD_COS), then the epoch (training
           samples/s, median optimizer-step ms, the share of the step
           loop spent waiting for host batches, val seconds / PSNR / SSIM,
           peak memory; launches counted by taps on the trainer's steps
           on the paths `train` (2x320x320 microbatches, each twice under
           remat), `train_val` (16x320x320) and `train_sample`
           (1x320x320); the params moved, every loss term finite), then
           `train_export` (the best .npz pair at the flagship settings,
           one 720p midpoint, 8 / 3 / 1 launches, counted on the main
           rows) and `train_turns` (one optimizer step a turn on one
           batch of 16, plain / kernel / kernel / plain);
10b1. fp32 the flagship in float32 (`bf16=False`) on card 0: b=1 and b=2
           720p requests through the float32 instances against the
           float32 plain-version engine (F32_ENGINE_ABS, F32_PSNR_DB), 8 /
           3 / 1 launches a request, all float32; frames/s in turns with
           the bf16 engine (F32_TURNS); the float32 and bf16 midpoints'
           PSNR; one `infer two-frame --fp32` request on card 0;
10b2. eval_fp32 the qocc sweep at the records' route in float32, kernel
           route against plain route (F32_EVAL_TOL_DB on the mean PSNR),
           pairs/s, the gap to the bf16 record;
10b3. train_fp32 the qocc recipe with `bf16: false`: one microbatch's
           loss and gradient through the float32 instances against the
           plain route (F32_TRAIN_LOSS_RTOL, F32_TRAIN_GRAD_COS), the
           same reported on four more microbatches (`train_fp32_spread`:
           the loss difference, its colour-histogram part in bin-edge
           crossings and the rest), then one
           optimizer step of 16 a turn against the bf16 recipe's
           (F32_TURNS): median step ms, the float32 steps' peak memory;
10c. dp_engine the flagship engine over a 'data' mesh of DP_RANKS replicas
           (two cards where there are two, else card 0 twice; the line
           says which): an odd batch of DP_ENGINE_BATCH 720p pairs,
           padded with its last pair and split, 8 / 3 / 1 launches a
           replica launch, every midpoint within PSNR_FLOOR_DB of the
           one-device engine; counted on the main rows;
10d. spatial the exact halo pipeline (`parallel.spatial`) through the
           engine's spatial route in DP_RANKS spawned ranks (NCCL over two
           cards where there are two, else gloo with both ranks on card
           0): the qocc checkpoint without the flow prior at the
           flagship's other settings on one 1080p pair (H padded to 1088,
           halo 32, 608-row slabs, the coarse pass at 544x960); per rank
           18 one-layer conv launches, 3 DCN, 1 warp (SPATIAL_PER_RANK),
           counted on rows of their own; the gathered midpoint against
           the one-process engine on the padded frames
           (SPATIAL_PADDED_TOL) and on the 1080-row frames (PSNR_FLOOR_DB,
           SPATIAL_NATIVE_TOL on the rows more than a halo above the
           padding); seconds a midpoint of both, in turns;
10e. dp_train one optimizer step of TRAIN_RECIPE over DP_RANKS spawned
           ranks (the same rule) from train_fidelity's params and pairs,
           each rank one pair a microbatch (its launches on the
           1x320x320 rows), against the one-process step: the loss
           within TRAIN_LOSS_RTOL, the gradient's cosine at least
           TRAIN_GRAD_COS, the params' difference after the step stated;
11. conv_compare conv_kernel "xla" against "pallas", taking turns, on the
           flagship's b=1 720p requests and on the three eval sweeps:
           seconds, which is faster, launches per forward, and each
           sweep's quality under "pallas" against its record;
12. tools  the kernel tools in-process (`vfi_tpu_torch.tools`,
           `TOOL_RUNS`): bench_conv over its four shapes at 720p,
           bench_kernels' DCN at vga (C=67, R=2) and its warp (C=3 and
           C=64): each kernel within tolerance of its plain version, and
           the conv, DCN and warp kernels launched;
12b. user_tools the five user tools in-process at full width (USER_*):
           `profile_forward` (the qocc forward, 4x720x1280, conv_kernel
           "pallas", two chained forwards: device time by category and
           on the timeline, whose rows, overlap and idle gaps must make
           the trace's span, the port's kernels' share above 0),
           `dump_offsets` (qocc's planes on Urban at 720p in float32,
           through the kernels within USER_DUMP_TOL of the plain
           versions' dump) and `bench_kernels --offsets` on them,
           `offset_stats` (Urban, 480x640), `bench_flowprior` (q3ft,
           4x720x1280, the prior's overhead) and `bench_train_step`
           (`kernels` against `handbwd`, the hand-written DCN backward:
           the first step's loss equal, the gradients' cosine at least
           USER_GRAD_COS; ms a step); the conv, DCN and warp kernels
           launched;
13. grad   gradients through each kernel wrapper (conv, chain of three
           layers and of one, DCN on the tile and the stream design, warp
           at C=3 and C=64) against those
           through its plain version at a small shape (GRAD_SHAPE,
           tolerance stated there);
14. profile (only with --profile) torch.profiler over one b=1 request
           (`utils.profiling.device_profile`): the device's busy share of
           the request's wall time, device time by kernel and by category,
           the timeline view;
           the same over one kernel-route optimizer step of the train
           phase (`train_turns`' `profile_kernel_step`).

Each kernel row's `launches` is its count over the paths (main, serve,
video, videos, infer_cli, q12, eval, train, train_val, train_sample,
train_export, fp32, eval_fp32, train_fp32, dp_engine, spatial and
dp_train (summed over the ranks), tools, user_tools) that launch its
shape; a launch
key ends with its instance's dtype ("bf16" or "f32"), and the run fails
when a path launches a (kernel, shape, dtype) that no row checks. Every
phase that means one engine on one card names card 0 (CARD0). The spawned
ranks load the library `build` made; none builds.

The lines before the last are the `kernels` JSON line and the card's
`nvidia-smi --query-gpu=name,power.limit` line; the last line is
`{"ok": true, "device": {...}}`. Imports only torch, numpy and the port.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

import vfi_tpu_torch
from vfi_tpu_torch import native
from vfi_tpu_torch.cli import eval as eval_cli
from vfi_tpu_torch.cli import infer as infer_cli
from vfi_tpu_torch.cli import serve as serve_cli
from vfi_tpu_torch.cli.common import free_port
from vfi_tpu_torch.cli.eval import sweep
from vfi_tpu_torch.data import load_image
from vfi_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from vfi_tpu_torch.infer import FrameInterpolator, pair
from vfi_tpu_torch.infer.multi import interpolate_videos
from vfi_tpu_torch.infer.video import interpolate_video
from vfi_tpu_torch.infer.video_io import (CAP_PROP_FPS, CAP_PROP_FRAME_COUNT,
                                          CAP_PROP_FRAME_HEIGHT,
                                          CAP_PROP_FRAME_WIDTH, to_float,
                                          to_u8)
from vfi_tpu_torch.models import SimpleFlowNet
from vfi_tpu_torch.ops.cuda import (PLAIN, WRAPPERS, as_parts, bounded_warp,
                                    bounded_warp_plain, build, chain_plan,
                                    conv2d,
                                    conv2d_plain, conv2d_plan, conv_chain,
                                    conv_chain_fused, conv_chain_plain,
                                    dcn_plan,
                                    deform_conv2d_bounded,
                                    deform_conv2d_bounded_plain,
                                    input_form_counts, launch_counts,
                                    pack_conv2d,
                                    pack_conv_chain, pack_dcn,
                                    reset_launch_counts)
from vfi_tpu_torch.ops.cuda.conv import chain_fused_plan
from vfi_tpu_torch.ops.resize import resize_bilinear
from vfi_tpu_torch.parallel import make_mesh, required_halo
from vfi_tpu_torch.serve import (BatcherStats, InterpolationServer,
                                 encode_pair_body, encode_raw_body,
                                 encode_seq_body)
from vfi_tpu_torch.tools import (bench_conv, bench_flowprior, bench_kernels,
                                 bench_train_step, dump_offsets,
                                 offset_stats, profile_forward)
from vfi_tpu_torch.tools.bench_serve import run_load
from vfi_tpu_torch.train import (Trainer, TrainState, create_train_state,
                                 make_train_step)
from vfi_tpu_torch.train.loop import data_rows
from vfi_tpu_torch.utils.config import MeshConfig, TrainConfig
from vfi_tpu_torch.utils.convert import load_params_npz, params_from_jax
from vfi_tpu_torch.utils.flo import endpoint_error, read_flo, write_flo
from vfi_tpu_torch.utils.profiling import (device_profile,
                                           port_kernel_counts)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(vfi_tpu_torch.__file__)))
CKPT = os.path.join(ROOT, "artifacts", "emavfi_qocc_best")
Q12 = os.path.join(ROOT, "artifacts", "emavfi_q12_best")
VAL = os.path.join(ROOT, "data", "processed", "val")
H, W = 720, 1280
# The card a single-engine phase runs on: named, since an engine given
# "cuda" without an index takes every visible card as its 'data' mesh (as
# the JAX engine's default mesh does), and then its replicas' launches
# would count on a phase that checks one engine's.
CARD0 = "cuda:0"
# Middlebury val frames and the eval batch.
EH, EW, EB = 480, 640, 4
SEED = 0
N_TIMED = 20
# Back-to-back launches a row's device time averages over.
N_BACK_TO_BACK = 100
# H100 SXM published peaks (dense; NVIDIA's data sheet): HBM bytes/s, bf16
# and TF32 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores.
# They assume the 700 W limit. A float32-accurate product on the tensor
# cores takes three TF32 passes (3xTF32, csrc/common.cuh): 165 TFLOP/s.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
# Kernel vs plain version, both bf16 with float32 accumulation: they differ
# only in summation order, which can move a bf16 rounding by one ulp (and
# a flipped intermediate of a chain nudges the next layer). Tolerance: two
# bf16 ulps at the top of the output's range, 2**-7 * max|plain|.
REL_TOL = 2.0 ** -7
# Engine vs the same engine through the plain versions: bf16 end to end, so
# rounding-order differences compound through ~20 layers and the flow; a
# wrong tap, channel or boundary costs far more than this floor allows.
PSNR_FLOOR_DB = 40.0
FLAGSHIP = dict(bf16=True, dcn_max_offset=1, warp_max_flow=16,
                cascade_levels=2, conv_kernel="pallas")
# The float32 instances. Kernel rows against their float32 plain versions
# (TF32 off): the conv and DCN sum float32 products in another order than
# cuDNN and the plain DCN's matmuls, a few float32 ulps of a ~600-term sum
# at the top of the output's range: 2**-14 * max|plain|; the warps compute
# the plain version's arithmetic: bit-exact expected, 2**-20 * max|plain|
# allowed. Engines: the float32 flagship against its plain-version engine,
# float32 end to end: max abs error 2**-12 and PSNR 80 dB (a wrong tap or
# boundary costs far more); the float32 eval sweep's mean PSNR against the
# plain route's within 0.001 dB; one float32 microbatch's loss within 1e-4
# relative of the plain route's and its gradient's cosine 0.9999.
F32_REL_TOL = 2.0 ** -14
F32_WARP_TOL = 2.0 ** -20
FLAGSHIP_F32 = dict(FLAGSHIP, bf16=False)
F32_ENGINE_ABS = 2.0 ** -12
F32_PSNR_DB = 80.0
F32_EVAL_TOL_DB = 0.001
F32_TRAIN_LOSS_RTOL = 1e-4
F32_TRAIN_GRAD_COS = 0.9999
# Further float32 microbatches (the train set's items from each index on)
# whose loss and gradient against the plain route are reported beside the
# held one, not held: the loss difference's spread, and how much of it is
# the exact colour histogram's (whole pixel values crossing a bin edge).
F32_TRAIN_SPREAD_FROM = (2, 4, 6, 8)
# Turns of the float32 phases against bf16 (engine requests, train steps).
F32_TURNS = ("bf16", "f32", "f32", "bf16")
Q12_ENGINE = dict(bf16=True, dcn_max_offset=2, warp_max_flow=16,
                  cascade_levels=2)
# The q12_r8 request's DCN radius: q12's weights at a radius past the tile
# design's (the stream design's path; the checkpoint was trained at R=2,
# so its quality there is no record).
Q12_R8 = 8
# The eval records' route (`eval.py --use_pallas`: the v4 DCN, the bounded
# warp, the conv trunk on plain XLA convs, the JAX CLI's only setting);
# flow prior, warp bound 16, cascade 2 (tools/queueAF.sh:33-40,
# tools/queueT.sh:114-117). Here the DCN and warp kernels always run.
EVAL_ENGINE = dict(bf16=True, warp_max_flow=16, cascade_levels=2,
                   conv_kernel="xla")
SWEEPS = (
    ("qocc", CKPT, dict(dcn_max_offset=1), "qocc_eval.json"),
    ("qocc_as9_tta", CKPT, dict(dcn_max_offset=1, auto_scale=9.0, tta=True),
     "qocc_autoscale_tta_eval.json"),
    ("q12", Q12, dict(dcn_max_offset=2), "q12_eval.json"),
)
# Quality against the JAX package's records on the TPU: bf16 on both, so
# rounding-order differences move a scene's PSNR by hundredths of a dB;
# a wrong tap, channel or route moves the mean by tenths or more.
PSNR_TOL_DB = 0.05
SSIM_TOL = 0.002
# Launches of each wrapper per engine launch on the flagship path. The
# three one-layer offset chains run the conv kernel (csrc/conv2d.cu) and
# count as conv_chain; the conv2d wrapper runs the fuse projection, which
# reads its input in two parts (features, the warped frame's 8-wide view).
# PER_LAUNCH_CAT: the forwards that concatenate instead (float32, whose
# fuse projection stays a cuDNN conv) and q12's topology (no fuse
# projection). The bf16 flagship's launches copy no input
# (`input_form_counts()["copied"]` 0), and a launch runs CAT_KERNELS_GONE
# fewer concatenation kernels (CatArrayBatchedCopy) than a launch of the
# concatenating forward: the two motion chains' and the fusion's.
PER_LAUNCH = {"conv_chain": 8, "deform_conv2d_bounded": 3, "bounded_warp": 1,
              "conv2d": 1, "conv_chain_fused": 0}
PER_LAUNCH_CAT = dict(PER_LAUNCH, conv2d=0)
CAT_KERNELS_GONE = 3
CHAIN_TPU = "vfi_tpu/ops/pallas/conv.py:543"
CONV_TPU = "vfi_tpu/ops/pallas/conv.py:92"
CONV_V2_TPU = "vfi_tpu/ops/pallas/conv.py:282"
DCN_TPU = "vfi_tpu/ops/pallas/sampling.py:1027"
DCN_V4_TPU = "vfi_tpu/ops/pallas/sampling.py:379"
DCN_V3_TPU = "vfi_tpu/ops/pallas/sampling.py:135"
WARP_TPU = "vfi_tpu/ops/pallas/sampling.py:739"
WARP_V1_TPU = "vfi_tpu/ops/pallas/sampling.py:883"
# The serve phase: the serve CLI's batcher defaults; per route (wire
# route, clients, requests); midpoints a sequence request asks for. A PNG
# response and a raw one of the same pair go through one engine in other
# batches: they may differ where bf16 rounding moves a midpoint across a
# level, by a level or two, no more.
SERVE_BATCHER = dict(max_batch=8, max_delay_ms=5.0,
                     max_px_per_launch=5_000_000)
SERVE_MIX = (("raw", 8, 32), ("png", 4, 8), ("seq", 2, 4))
SERVE_SEQ = 4
SERVE_PNG_RAW_LEVELS = 2
# The serve CLI's own server: frame size and requests.
CLI_H, CLI_W, CLI_REQUESTS = 480, 640, 2
# The video phase: source frames, their rate (pick_interpolation_factor:
# 3, two bisection levels), pairs a batch; frames of the reference_compat
# pass.
VIDEO_FRAMES, VIDEO_FPS, VIDEO_BATCH = 9, 15.0, 8
VIDEO_COMPAT_FRAMES = 3
# The videos phase: clips, frames a clip, their rate (factor 1), and the
# shared batcher (launch size, wait for batch-mates), as the JAX CLI's
# defaults.
VIDEOS_CLIPS, VIDEOS_FRAMES, VIDEOS_FPS = 2, 5, 30.0
VIDEOS_BATCHER = dict(batch_pairs=8, max_delay_ms=50.0)
# The infer_cli phase: the flagship's flags, the val pair, the resize.
INFER_FLAGS = ["--dcn_max_offset", "1", "--warp_max_flow", "16",
               "--cascade_levels", "2", "--flow_prior", "--conv_kernel",
               "pallas"]
INFER_PAIR = ("Urban", "frame10.png", "frame11.png")
INFER_SIZE = (360, 640)
# The kernel tools' runs in the tools phase: few iterations each.
TOOL_RUNS = (
    (bench_conv, ["--shapes", "all", "--kernels", "xla,im2col,direct,v2,plain",
                  "--iters", "3"]),
    (bench_kernels, ["--size", "vga", "--kernels", "xla,pallas,v4,v5",
                     "--iters", "3"]),
    (bench_kernels, ["--warp", "--iters", "3"]),
)
# Library calls the tools time beside the kernels (not checked).
TOOL_LIBRARY = ("xla", "xla-shifts", "plain", "grid_sample")
# The user_tools phase: the five user tools in-process at full width.
# profile_forward: the qocc forward chained twice at 4x720x1280 on the
# kernels (conv_kernel "pallas"); its timeline rows less the overlap
# between categories plus the idle gaps must make the trace's span within
# USER_SPAN_TOL of it, and the port's kernels must hold device time.
USER_PROFILE = ["--ckpt", CKPT + ".npz", "--radius", "1", "--conv_kernel",
                "pallas", "--b", "4", "--iters", "2"]
USER_SPAN_TOL = 0.01
# dump_offsets: qocc's planes on Urban at 720p, R=1, in float32, through
# the kernels against the same dump through their plain versions: float32
# end to end, sums in other orders through ~15 layers, within
# USER_DUMP_TOL * max|plain| (a wrong tap or channel moves the offsets by
# far more). bench_kernels then times the DCN on those planes (qocc's
# C=64, R=1).
USER_DUMP = ["--ckpt", CKPT + ".npz", "--scene", "Urban", "--size", "720p",
             "--radius", "1"]
USER_DUMP_TOL = 2.0 ** -12
USER_OFFSETS = ["--size", "720p", "--channels", "64", "--radius", "1",
                "--kernels", "xla,pallas", "--iters", "3"]
USER_STATS = ["--ckpt", CKPT + ".npz", "--scene", "Urban", "--radius", "1"]
USER_FLOWPRIOR = ["--iters", "3"]
# bench_train_step at its defaults (crop 256, batch 16, 8 microbatches)
# on the kernels path and the hand-written DCN backward: one forward
# function, so the first step's loss is the same number on both; the
# backward differs in arithmetic (float32 hand-written sums against
# autograd of the bf16 plain version) and at integer offsets (the fresh
# model's offset conv starts at zero: ROADMAP.md section 3 item 2), so the
# gradients' cosine must be at least USER_GRAD_COS.
USER_TRAIN = ["--paths", "kernels,handbwd", "--iters", "2"]
USER_TRAIN_CROP = bench_train_step.parse_args([]).crop
USER_GRAD_COS = 0.9999
# The train phase: the qocc fine-tune that made the flagship checkpoint
# (tools/queueAC.sh:109-121), at full width, warm-started from it, with
# random-feature VGG (no pretrained weights in the repository), one epoch
# on the tracked Middlebury frames: 66 train triplets make 4 optimizer
# steps of 8 microbatches of 2 at 320x320 (remat: each microbatch's
# forward runs twice, so every DCN and warp kernel launches twice), 66 val
# triplets 5 batches of 16, the last padded; the sample dump is 1 pair.
TRAIN_DATA = os.path.join(ROOT, "data", "processed", "train")
TRAIN_RECIPE = dict(
    batch_size=16, accum_steps=8, remat=True, random_rotation=False,
    consistent_jitter=True, crop_size=(320, 320), target_unit_range=True,
    best_metric="val_psnr", warp_max_flow=16, use_pallas=True,
    ema_decay=0.998, flow_prior=True, flow_photo_pyramid=True,
    fuse_project=True, lr_schedule="cosine", learning_rate=5e-5,
    cosine_min_lr=5e-6, dcn_max_offset=1, cascade_levels=2,
    flow_photo_occlusion=True, vgg_weight=0.15, num_epochs=1)
# The train phase's launch shapes, by batch, each counted on its own path.
TRAIN_PATHS = {TRAIN_RECIPE["batch_size"] // TRAIN_RECIPE["accum_steps"]:
               "train", TRAIN_RECIPE["batch_size"]: "train_val",
               1: "train_sample"}
# One microbatch's loss and gradient through the kernels against the same
# through their plain versions, from one set of params: bf16 activations
# on both routes, rounded in other orders through ~25 layers, the VGG
# term and the backward. A wrong tap, channel or gradient moves the loss
# by far more than 1% and turns the gradient away from the plain one.
TRAIN_LOSS_RTOL = 0.01
TRAIN_GRAD_COS = 0.99
# Optimizer steps each route times in the turns (plain, kernel, kernel,
# plain).
TRAIN_TURNS = ("plain", "kernel", "kernel", "plain")
# Flow EPE of the qocc checkpoint's estimator against the Middlebury GT
# flows (artifacts/qocc_epe.json, made on the TPU in bf16): the card's
# bf16 rounds in other orders; a wrong level, sign or scale moves the mean
# by tenths of a pixel.
GT_FLOW = os.path.join(ROOT, "data", "processed", "other-gt-flow")
EPE_TOL_PX = 0.02
# The native phase: a val frame (480x640) and windows of it: the whole
# frame, a 1x1 window at its far corner, a 320x320 window inside it.
NATIVE_FRAME = os.path.join(VAL, "Urban", "frame10.png")
NATIVE_WINDOWS = ((0, 0, (EH, EW)), (EH - 1, EW - 1, (1, 1)),
                  (37, 101, (320, 320)))
# The multi-device phases. Two ranks (or replicas): on two cards when
# there are two, else both on card 0 (the ranks then take turns on it).
# dp_engine: the flagship over a 'data' mesh of two replicas, an odd batch
# of 720p pairs (padded to 4: two replica launches of b=2).
DP_RANKS = 2
DP_ENGINE_BATCH = 3
# spatial: the qocc checkpoint without the flow prior (the JAX engine
# refuses the prior with spatial sharding) at the flagship's other
# settings, one 1080p pair: H pads to 1088 (a multiple of 8 x 2 ranks),
# halo required_halo(3, 1, 16) = 32, each rank's slab 544 + 64 = 608
# rows; the cascade's coarse pass runs on the gathered 1088x1920 pair at
# 544x960. The gathered midpoint against the one-process engine on the
# same edge-padded frames (the pipeline's own semantics; bf16 rounds the
# context pool's sum in another order) within SPATIAL_PADDED_TOL
# everywhere, and against the one-process engine on the 1080-row frames
# (whose context pool and coarse pass see 1080 rows, not 1088) within
# PSNR_FLOOR_DB and, on the rows more than a halo above the padding,
# SPATIAL_NATIVE_TOL. Launches per rank and midpoint: each trunk layer one
# conv-kernel launch (6 on the coarse pass, 12 on the slab), 3 DCN, 1 warp.
SP_H, SP_W = 1080, 1920
SPATIAL_PADDED_TOL = 2.0 ** -5
SPATIAL_NATIVE_TOL = 2.0 ** -3
SPATIAL_PER_RANK = {"conv_chain": 18, "deform_conv2d_bounded": 3,
                    "bounded_warp": 1, "conv2d": 0, "conv_chain_fused": 0}
SPATIAL_TURNS = ("spatial", "one", "one", "spatial")
# dp_train: one optimizer step of TRAIN_RECIPE (batch 16, 8 microbatches of
# 2 at 320x320) over two ranks, each one pair a microbatch, from
# train_fidelity's params; its batch is train_fidelity's pairs and the 14
# after them. Held to the one-process step on the same batch with
# TRAIN_LOSS_RTOL and TRAIN_GRAD_COS.
RANK_TIMEOUT_S = 600
# Gradients through a kernel wrapper against those through its plain
# version. The DCN, warp and chain backward is autograd of the plain
# version itself, so their gradients differ only where the inputs'
# atomics add in another order; the conv's is closed-form float32 with the
# ReLU mask read off the kernel's bf16 output, which can flip where the
# kernel and the plain version round a value near 0 apart. Tolerance: as
# the forward, 2**-7 * max|plain gradient|.
GRAD_SHAPE = (2, 24, 40)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def median_ms(fn, n: int = N_TIMED, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, n: int = N_BACK_TO_BACK, warmup: int = 3) -> float:
    """Device time per launch of `n` back-to-back launches between two
    events, as tools/conv_turns.py times them: the launches are queued
    behind a spin of the card (`torch.cuda._sleep`), so the host's launch
    path does not pace a launch shorter than itself; the spin doubles
    until every launch was queued before the first event ran. A call of
    many kernels (a sequence of library calls) can fill the card's launch
    queue, which then blocks the host until the spin ends: past a spin of
    2^26 cycles the launch count halves instead."""
    for _ in range(warmup):
        fn()
    spin = 1 << 22
    while True:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        queued_first = not a.query()
        b.synchronize()
        if queued_first or n == 1:
            return a.elapsed_time(b) / n
        if spin < 1 << 26:
            spin *= 2
        else:
            n //= 2


def bound(nbytes: float, flops_bf16: float, flops_f32: float = 0.0,
          flops_tf32x3: float = 0.0):
    """Least time in ms: the largest of the bytes over the memory rate and
    each type's operations over its own peak (the tensor cores and the
    float32 units run at once): bf16 products on the tensor cores,
    float32-accurate products (`flops_tf32x3`) as three TF32 passes on
    them, other float32 arithmetic (a blend, a warp) on the float32
    units."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(flops_bf16 / PEAK_BF16, 3.0 * flops_tf32x3 / PEAK_TF32,
                flops_f32 / PEAK_F32)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor,
                exact: bool = False, rel_tol: float = REL_TOL) -> dict:
    """Max abs error of `got` against `ref`, within rel_tol * max|ref| (0
    where `exact`)."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{ref.shape}/{ref.dtype}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - ref.float()).abs().max().item()
    tol = 0.0 if exact else rel_tol * ref.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err} > tol {tol}")
    return {"max_abs_err": err, "tol": tol}


def smooth_frames(gen: np.random.Generator, b: int, h: int = H,
                  w: int = W) -> tuple:
    """A smooth random texture (sum of random sinusoids) and a copy
    shifted by a few pixels, float32 [0, 1], (b, h, w, 3)."""
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    frames = np.zeros((b, h, w, 3), np.float32)
    for i in range(b):
        for c in range(3):
            acc = np.zeros((h, w), np.float32)
            for _ in range(8):
                fy, fx = gen.uniform(0.005, 0.06, 2) * gen.choice([-1, 1], 2)
                acc += np.sin(fy * yy + fx * xx + gen.uniform(0, 2 * np.pi))
            frames[i, ..., c] = 0.5 + 0.06 * acc
    frames = np.clip(frames, 0.0, 1.0)
    shifted = np.roll(frames, shift=(3, 6), axis=(1, 2))
    return frames, shifted


# The float32 conv and DCN kernels: each must run its products on the
# tensor cores (TF32 HMMA in its SASS) and keep nothing in local memory.
TF32_KERNELS = re.compile(r"(conv2d_f32|dcn_tile_tf32|dcn_stream_tf32)_kernel")


def short_name(mangled: str) -> str:
    """`conv2d_f32_kernel<4,4,0>` for the mangled name of an instance."""
    m = re.search(TF32_KERNELS.pattern + r"I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
    return f"{m.group(1)}_kernel<{args}>"


def tf32_kernels(log: str, lib: str) -> dict:
    """Per float32 conv / DCN kernel instance: its registers, its stack
    frame and spilled bytes (ptxas's report in the build log) and its TF32
    MMAs (`HMMA ... TF32` in `cuobjdump -sass` of the library). Fails if an
    instance spills, keeps anything in local memory (a stack frame) or has
    no TF32 MMA."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = short_name(m.group(1)) if TF32_KERNELS.search(m.group(1)) \
                else None
            continue
        m = re.search(r"(\d+) bytes stack frame", ln)
        if fn and m:
            out.setdefault(fn, {})["stack_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if fn and m:
            out.setdefault(fn, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if fn and m:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    fn = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = short_name(m.group(1)) if TF32_KERNELS.search(m.group(1)) \
                else None
            if fn:
                out.setdefault(fn, {})["tf32_hmma"] = 0
        elif fn and re.search(r"HMMA\.\w+\.F32\.TF32", ln):
            out[fn]["tf32_hmma"] += 1
    bad = {k: v for k, v in out.items()
           if v.get("spill_bytes", 0) or v.get("stack_bytes", 0)
           or not v.get("tf32_hmma")}
    if not out or bad:
        raise AssertionError(f"float32 kernels spilling or off the tensor "
                             f"cores: {bad or 'none found'}")
    return out


def phase_build() -> dict:
    t0 = time.perf_counter()
    build.load()
    info = dict(build.build_info)
    # A cached build kept its compiler report beside the library.
    log = info.pop("log", "") or open(os.path.join(os.path.dirname(
        info["path"]), "nvcc.log")).read()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    t1 = time.perf_counter()
    native.load()               # the PNG codec, before any route is timed
    t2 = time.perf_counter()
    tf32 = tf32_kernels(log, info["path"])
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "nvcc_seconds": info["seconds"], "cached": info["cached"],
            "png_codec_seconds": t2 - t1, "ptxas": ptxas,
            "tf32_kernels": tf32,
            "tf32_check_seconds": time.perf_counter() - t2}


def native_numpy(img: np.ndarray, top: int, left: int, crop: tuple,
                 hflip: bool, norm: bool) -> np.ndarray:
    """`native.crop_flip_normalize`'s arithmetic in numpy: s * float32(1 /
    255), or float32(s * float64(float32(1 / 255)) - mean) / std (its
    fused multiply-add: the float64 sum is exact)."""
    ch, cw = crop
    win = img[top:top + ch, left:left + cw]
    win = win[:, ::-1] if hflip else win
    inv = np.float32(1.0) / np.float32(255.0)
    if not norm:
        return win.astype(np.float32) * inv
    mean = np.asarray(IMAGENET_MEAN, np.float32).astype(np.float64)
    fused = (win.astype(np.float64) * np.float64(inv) - mean)
    return fused.astype(np.float32) / np.asarray(IMAGENET_STD, np.float32)


def phase_native() -> dict:
    """The port's C++ library (`native/png.cpp`, built by this machine's
    compiler in `phase_build`): NATIVE_FRAME decoded by the port, then the
    crop core at NATIVE_WINDOWS x hflip x ImageNet normalization, each bit
    for bit against `native_numpy` on the same window; a window one row
    past the image must raise ValueError."""
    t0 = time.perf_counter()
    with open(NATIVE_FRAME, "rb") as f:
        img = native.decode_png_rgb(f.read())
    n = 0
    for top, left, crop in NATIVE_WINDOWS:
        for hflip in (False, True):
            for norm in (False, True):
                got = native.crop_flip_normalize(img, top, left, crop, hflip,
                                                 norm)
                want = native_numpy(img, top, left, crop, hflip, norm)
                if got.shape != want.shape or not np.array_equal(got, want):
                    raise AssertionError(
                        f"native: crop {crop} at ({top}, {left}), hflip "
                        f"{hflip}, norm {norm} differs from numpy")
                n += 1
    try:
        native.crop_flip_normalize(img, 1, 0, img.shape[:2], False, False)
    except ValueError:
        pass
    else:
        raise AssertionError("native: a window past the image was taken")
    return {"phase": "native", "seconds": time.perf_counter() - t0,
            "available": native.available(), "frame": list(img.shape),
            "windows_bit_equal": n, "outside_refused": True}


def row_name(base: str, b: int, h: int, w: int) -> str:
    """`base@HxW` for a b=1 shape (the flagship rows' names, kept stable
    so runs compare), else `base@BxHxW`."""
    return f"{base}@{h}x{w}" if b == 1 else f"{base}@{b}x{h}x{w}"


def kernel_row(name, source, replaces, key, kernel, plain, library,
               io_bytes, flops_bf16, flops_f32=0.0, ref=None, plain_ms=None,
               exact=False, rel_tol=REL_TOL, flops_tf32x3=0.0,
               **extra) -> dict:
    """Check one kernel call against its plain version, then time the
    kernel, the plain version and (where one exists) a library call.
    `key` = (paths, wrapper name, launch shape): the paths whose runs
    launch the wrapper at this shape (their counts are this row's
    launches), or () for a shape no path of this run takes. `ref` and
    `plain_ms`, where given, are the plain version's result and time on
    these inputs, shared by two rows; `exact`: the kernel must equal its
    plain version bit for bit, else within rel_tol * max|plain|. A row
    with float32-accurate products (`flops_tf32x3`) also has
    `ffma_bound_ms`: its bound with them on the float32 units instead, as
    the FFMA designs' float32 rows were bounded. `extra` fields go into the
    row as they are."""
    got = kernel()
    if ref is None:
        ref = plain()
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, **extra,
           **check_close(name, got, ref, exact, rel_tol),
           "bit_exact": bool(torch.equal(got, ref))}
    row["ms"] = median_ms(kernel)
    row["device_ms"] = device_ms(kernel)
    row["plain_ms"] = median_ms(plain) if plain_ms is None else plain_ms
    row["library_ms"] = None if library is None else median_ms(library)
    row["library_device_ms"] = (None if library is None
                                else device_ms(library))
    row["bound_ms"], row["bound_by"] = bound(io_bytes + nbytes(got),
                                             flops_bf16, flops_f32,
                                             flops_tf32x3)
    row["x_bound"] = row["device_ms"] / row["bound_ms"]
    if flops_tf32x3:
        row["ffma_bound_ms"] = bound(io_bytes + nbytes(got), flops_bf16,
                                     flops_f32 + flops_tf32x3)[0]
        row["x_ffma_bound"] = row["device_ms"] / row["ffma_bound_ms"]
    emit({"phase": "kernel", **row})
    row["_key"] = key
    return row


def dtype_rows(dt) -> dict:
    """What a kernel row of dtype `dt` sets: its name's suffix, its
    tolerance, its dtype tag and whether its products are float32-accurate
    (`bound` counts the bf16 instances' at the bf16 tensor-core peak, the
    float32 instances' as three TF32 passes)."""
    if dt == torch.float32:
        return {"suffix": "_f32", "rel_tol": F32_REL_TOL, "tag": "f32",
                "f32_products": True}
    return {"suffix": "", "rel_tol": REL_TOL, "tag": "bf16",
            "f32_products": False}


def chain_rows(rnd, sd, tag, cin, names, acts, b, h, w, paths,
               dt=torch.bfloat16) -> list:
    """The chain at one shape with the checkpoint's weights, packed once as
    the engine does: one row a wrapper (`chain_route` "fused":
    `conv_chain_fused`, the chain kernel, on no path; "layers":
    `conv_chain`, one conv-kernel launch a layer, whose launches the paths
    count; a chain of one layer has only the latter), in bf16 or float32
    (`dt`: each kernel's instance of that type), all checked against one
    plain result. `plan`: `chain_fused_plan`, or `chain_plan`'s layers.
    Library: cuDNN layer by layer (`F.conv2d` in the chain's dtype, TF32
    off, then `relu` where the layer has one), the "xla" route's trunk: a
    sequence of calls where the chain has more than one layer."""
    d = dtype_rows(dt)
    ws = [sd[f"{n}.weight"].cuda() for n in names]
    bs = [sd[f"{n}.bias"].cuda() for n in names]
    acts = tuple(bool(a) for a in acts)
    x = rnd(b, h, w, cin, dtype=dt)
    wb = [t.to(dt) for t in ws + bs]

    def library():
        y = x.permute(0, 3, 1, 2)
        for wt, bt, a in zip(wb[:len(ws)], wb[len(ws):], acts):
            y = F.conv2d(y, wt, bt, padding=1)
            y = torch.relu(y) if a else y
        return y

    chans = tuple([cin] + [wt.shape[0] for wt in ws])
    pk = pack_conv_chain(ws, bs, dt)
    smem = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    plain = lambda: conv_chain_plain(x, ws, bs, acts)  # noqa: E731
    ref, plain_ms = plain(), median_ms(plain)
    calls = " -> ".join(f"F.conv2d{'+relu' if a else ''}" for a in acts)
    flops = sum(2.0 * b * h * w * 9 * wt.shape[1] * wt.shape[0] for wt in ws)
    wrappers = [("layers", conv_chain, "conv2d.cu", paths, chain_plan(
        chans, acts, b, h, w, smem, x.element_size()))]
    if len(ws) > 1:
        wrappers.insert(0, ("fused", conv_chain_fused, "conv_chain.cu", (),
                            chain_fused_plan(chans, smem, x.element_size())))
    rows = []
    for route, fn, src, on, plan in wrappers:
        suffix = "/layers" if len(wrappers) > 1 and route == "layers" else ""
        rows.append(kernel_row(
            row_name(f"conv_chain/{tag}{suffix}{d['suffix']}", b, h, w),
            "vfi_tpu_torch/csrc/" + src, CHAIN_TPU,
            (on, fn.__name__, (chans, h, w, d["tag"])),
            lambda fn=fn: fn(x, ws, bs, acts, packed=pk),
            plain, library,
            nbytes(x) + nbytes(*ws) * x.element_size() // 4 + nbytes(*bs),
            0.0 if d["f32_products"] else flops, ref=ref, plain_ms=plain_ms,
            flops_tf32x3=flops if d["f32_products"] else 0.0,
            rel_tol=d["rel_tol"], dtype=d["tag"], chain_route=route,
            library_call=calls, plan=plan))
    return rows


def conv2d_row(rnd, gen, cin, cout, k, b, h, w, variant, replaces,
               paths, act=True, dt=torch.bfloat16) -> dict:
    """The single conv at one shape, random weights (no checkpoint holds
    these convs); library: F.conv2d in the row's dtype (TF32 off) with the
    bias, then the ReLU where the row fuses it (two calls)."""
    d = dtype_rows(dt)
    dev = gen.device
    x = rnd(b, h, w, cin, dtype=dt)
    wt = torch.randn(cout, cin, k, k, generator=gen, device=dev) / (
        k * k * cin) ** 0.5
    bt = torch.randn(cout, generator=gen, device=dev) * 0.1
    xn, wb, bb = x.permute(0, 3, 1, 2), wt.to(dt), bt.to(dt)

    def library():
        y = F.conv2d(xn, wb, bb, padding=k // 2)
        return torch.relu(y) if act else y

    pk = pack_conv2d(wt, bt, dt)
    tag = f"conv2d{'/v2' if variant == 'v2' else ''}/{cin}x{cout}k{k}"
    flops = 2.0 * b * h * w * k * k * cin * cout
    return kernel_row(
        row_name(tag + d["suffix"], b, h, w), "vfi_tpu_torch/csrc/conv2d.cu",
        replaces, (paths, "conv2d", (cin, cout, k, h, w, d["tag"])),
        lambda: conv2d(x, wt, bt, act, variant, packed=pk),
        lambda: conv2d_plain(x, wt, bt, act), library,
        nbytes(x) + nbytes(wt) * x.element_size() // 4 + nbytes(bt),
        0.0 if d["f32_products"] else flops, rel_tol=d["rel_tol"],
        flops_tf32x3=flops if d["f32_products"] else 0.0,
        dtype=d["tag"], library_call="F.conv2d+relu" if act else "F.conv2d",
        plan=conv2d_plan(cin, cout, k, itemsize=x.element_size()))


def vs_cat(name: str, got: torch.Tensor, cat: torch.Tensor) -> dict:
    """A kernel on parts or a view (`got`) against the same kernel on their
    zero-padded concatenation (`cat`): bit for bit, or the row fails."""
    torch.cuda.synchronize()
    if not torch.equal(got, cat):
        raise AssertionError(f"{name}: the kernel on parts or a view differs "
                             f"from it on their concatenation")
    return {"vs_cat_bit_exact": True}


def fuse_row(rnd, sd, b, h, w, paths) -> dict:
    """The fuse projection (1x1, 67 -> 64, no ReLU) as the bf16 flagship
    runs it, with the checkpoint's weights: the conv kernel reading two
    parts, the features and the [..., :3] view of the bounded warp's 8-wide
    buffer, held against its plain version on the parts, and bit for bit
    against the kernel on their zero-padded concatenation
    (`vs_cat_bit_exact`). Library: the concatenating forward's cat, cuDNN
    conv and bias add (bf16, three calls)."""
    dev = rnd(1).device
    feat = rnd(b, h, w, 64)
    rgb8 = torch.zeros(b, h, w, 8, dtype=torch.bfloat16, device=dev)
    rgb8[..., :3] = rnd(b, h, w, 3)
    rgb = rgb8[..., :3]
    wt = sd["fuse_proj.conv.weight"].cuda()
    bt = sd["fuse_proj.conv.bias"].cuda()
    pk = pack_conv2d(wt, bt)
    wb, bb = wt.to(torch.bfloat16), bt.to(torch.bfloat16)
    ref = conv2d(torch.cat([feat, rgb], dim=-1), wt, bt, packed=pk)
    name = row_name("conv2d/fuse_proj67x64k1/parts", b, h, w)
    same = vs_cat(name, conv2d((feat, rgb), wt, bt, packed=pk), ref)

    def library():
        x = torch.cat([feat, rgb], dim=-1).permute(0, 3, 1, 2)
        return F.conv2d(x, wb) + bb[:, None, None]

    # The kernel's one rounding against the library's two: how far the
    # bf16 flagship's fuse projection moved.
    twice = library().permute(0, 2, 3, 1)
    return kernel_row(
        name, "vfi_tpu_torch/csrc/conv2d.cu", CONV_TPU,
        (paths, "conv2d", (67, 64, 1, h, w, "bf16")),
        lambda: conv2d((feat, rgb), wt, bt, packed=pk),
        lambda: conv2d_plain((feat, rgb), wt, bt), library,
        nbytes(feat, rgb, bt) + nbytes(wt) // 2, 2.0 * b * h * w * 67 * 64,
        library_call="cat+F.conv2d+bias", **same,
        vs_library_max_abs=(ref.float() - twice.float()).abs().max().item(),
        vs_library_max_rel=((ref.float() - twice.float()).abs().max()
                            / twice.float().abs().max()).item())


def parts_rows(rnd, sd, sd12, dcn12, shapes) -> list:
    """The main path's inputs in parts and views, with the checkpoints'
    weights, each held against its plain version and bit for bit against
    the kernel on the zero-padded concatenation (`vs_cat_bit_exact`): the
    flagship's motion chain on (features, the context vector broadcast
    over the pixels: a stride-0 part read through L1) at `shapes` ((b, h,
    w) each: 720p and its cascade level); and on q12's batch the first DCN
    on (features, the [..., :3] view of the warp's 8-wide buffer), the
    later DCNs on the [..., :67] view of a 72-wide buffer, both into a
    padded output (`padded=True`), and the reconstruction chain on that
    view. Their launch keys have no path: the whole-input rows of the same
    shapes carry the paths' launches. No library call."""
    rows = []
    names = [f"motion_conv{i}.conv" for i in (1, 2, 3)]
    ws = [sd[f"{n}.weight"].cuda() for n in names]
    bs = [sd[f"{n}.bias"].cuda() for n in names]
    acts = (True, True, False)
    pk = pack_conv_chain(ws, bs)
    for b, h, w in shapes:
        feat = rnd(b, h, w, 64)
        x = (feat, rnd(b, 64)[:, None, None, :].expand(b, h, w, 64))
        name = row_name("conv_chain/motion/parts", b, h, w)
        same = vs_cat(name, conv_chain(x, ws, bs, acts, packed=pk),
                      conv_chain(torch.cat(x, -1), ws, bs, acts, packed=pk))
        rows.append(kernel_row(
            name, "vfi_tpu_torch/csrc/conv2d.cu", CHAIN_TPU,
            ((), "conv_chain", ((128, 64, 64, 2), h, w, "bf16")),
            lambda x=x: conv_chain(x, ws, bs, acts, packed=pk),
            lambda x=x: conv_chain_plain(x, ws, bs, acts), None,
            nbytes(feat) + b * 128 + nbytes(*ws) // 2 + nbytes(*bs),
            sum(2.0 * b * h * w * 9 * t.shape[1] * t.shape[0] for t in ws),
            dtype="bf16", **same))
    b, h, w, R = EB, EH, EW, 2
    wt, bt = dcn12
    pk = pack_dcn(wt, bt)
    off = rnd(b, h, w, 18, scale=0.8 * R)
    mask = torch.sigmoid(rnd(b, h, w, 9, scale=2.0).float()).to(torch.bfloat16)
    rgb8, wide = rnd(b, h, w, 8), rnd(b, h, w, 72)
    n = b * h * w
    for tag, x in (("parts", (rnd(b, h, w, 64), rgb8[..., :3])),
                   ("view", wide[..., :67])):
        name = row_name(f"deform_conv2d_bounded/C67R{R}/{tag}", b, h, w)
        got = deform_conv2d_bounded(x, off, mask, wt, bt, R, packed=pk,
                                    padded=True)
        if got.stride(2) != 72:
            raise AssertionError(f"{name}: output pixel stride "
                                 f"{got.stride(2)}, not the padded 72")
        same = vs_cat(name, got, deform_conv2d_bounded(
            torch.cat(as_parts(x), -1), off, mask, wt, bt, R, packed=pk))
        rows.append(kernel_row(
            name, "vfi_tpu_torch/csrc/dcn_bounded.cu", DCN_V4_TPU,
            ((), "deform_conv2d_bounded", (67, 67, h, w, R, "bf16")),
            lambda x=x: deform_conv2d_bounded(x, off, mask, wt, bt, R,
                                              packed=pk, padded=True),
            lambda x=x: deform_conv2d_bounded_plain(x, off, mask, wt, bt, R),
            None, nbytes(*as_parts(x), off, mask) + nbytes(wt) // 2
            + nbytes(bt), 2.0 * n * 9 * 67 * 67, 8.0 * n * 9 * 67,
            dtype="bf16", **same))
    names = [f"rec_conv{i}.conv" for i in (1, 2, 3)]
    ws = [sd12[f"{nm}.weight"].cuda() for nm in names]
    bs = [sd12[f"{nm}.bias"].cuda() for nm in names]
    pk = pack_conv_chain(ws, bs)
    x = wide[..., :67]
    name = row_name("conv_chain/rec67/view", b, h, w)
    same = vs_cat(name, conv_chain(x, ws, bs, acts, packed=pk),
                  conv_chain(x.contiguous(), ws, bs, acts, packed=pk))
    rows.append(kernel_row(
        name, "vfi_tpu_torch/csrc/conv2d.cu", CHAIN_TPU,
        ((), "conv_chain", ((67, 64, 64, 3), h, w, "bf16")),
        lambda: conv_chain(x, ws, bs, acts, packed=pk),
        lambda: conv_chain_plain(x, ws, bs, acts), None,
        nbytes(x) + nbytes(*ws) // 2 + nbytes(*bs),
        sum(2.0 * n * 9 * t.shape[1] * t.shape[0] for t in ws), dtype="bf16",
        **same))
    return rows


def dcn_row(rnd, wt, bt, b, h, w, R, replaces, paths,
            dt=torch.bfloat16) -> dict:
    """Bounded DCN at a fusion stack's shape with weights `wt`, `bt`;
    offsets reach past R so the clamp is exercised. No single PyTorch call
    computes it (torchvision is absent), so no library time. The row names
    the plan the launch runs: its design ("tile", the weight-stationary
    GEMM, or "stream", the same core with the weights streamed, where no
    tile plan fits) and tiles."""
    d = dtype_rows(dt)
    c = wt.shape[1]
    x = rnd(b, h, w, c, dtype=dt)
    off = rnd(b, h, w, 18, scale=0.8 * R, dtype=dt)
    mask = torch.sigmoid(rnd(b, h, w, 9, scale=2.0).float()).to(dt)
    pk = pack_dcn(wt, bt, dt)
    n = b * h * w
    plan = dcn_plan(c, wt.shape[0], R, torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin, x.element_size())
    gemm, blend = 2.0 * n * 9 * c * wt.shape[0], 8.0 * n * 9 * c
    return kernel_row(
        row_name(("deform_conv2d_bounded" if b == 1 and c == 64 and R == 1
                  else f"deform_conv2d_bounded/C{c}R{R}") + d["suffix"],
                 b, h, w),
        "vfi_tpu_torch/csrc/dcn_bounded.cu", replaces,
        (paths, "deform_conv2d_bounded", (c, wt.shape[0], h, w, R, d["tag"])),
        lambda: deform_conv2d_bounded(x, off, mask, wt, bt, R, packed=pk),
        lambda: deform_conv2d_bounded_plain(x, off, mask, wt, bt, R), None,
        nbytes(x, off, mask) + nbytes(wt) * x.element_size() // 4
        + nbytes(bt), 0.0 if d["f32_products"] else gemm, blend,
        flops_tf32x3=gemm if d["f32_products"] else 0.0, rel_tol=d["rel_tol"],
        dtype=d["tag"], design=plan["design"], plan=plan)


def warp_row(rnd, b, h, w, paths, dev, c=3, R=16, replaces=WARP_TPU,
             dt=torch.bfloat16) -> dict:
    """The bounded warp at one shape: bf16 bit for bit against its plain
    version, float32 within F32_WARP_TOL (bit-exact expected: the row's
    `bit_exact`)."""
    d = dtype_rows(dt)
    img = rnd(b, h, w, c, dtype=dt)
    flow = rnd(b, h, w, 2, scale=10.0 * R / 16, dtype=dt)
    fc = flow.float().clamp(-R, R)
    gx = (torch.arange(w, device=dev).float() + fc[..., 0]) * (2 / (w - 1)) - 1
    gy = (torch.arange(h, device=dev).float()[:, None] + fc[..., 1]) * (
        2 / (h - 1)) - 1
    grid = torch.stack([gx, gy], dim=-1).to(dt)
    imn = img.permute(0, 3, 1, 2)
    return kernel_row(
        row_name(("bounded_warp" if c == 3 else f"bounded_warp/C{c}R{R}")
                 + d["suffix"], b, h, w),
        "vfi_tpu_torch/csrc/warp_bounded.cu", replaces,
        (paths, "bounded_warp", (c, h, w, R, d["tag"])),
        lambda: bounded_warp(img, flow, R),
        lambda: bounded_warp_plain(img, flow, R),
        lambda: F.grid_sample(imn, grid, mode="bilinear",
                              padding_mode="zeros", align_corners=True),
        nbytes(img, flow), 0.0, (16.0 + 8.0 * c) * b * h * w,
        exact=dt == torch.bfloat16, rel_tol=F32_WARP_TOL, dtype=d["tag"],
        design=warp_instance(img))


def warp_instance(img: torch.Tensor) -> str:
    """The instance of csrc/warp_bounded.cu a warp of `img` runs (the C
    entry picks it by the same test; the output is a fresh, aligned
    tensor): "wide16" reads 16-byte groups (8 bf16 or 4 float32
    channels), "wide2b" one element at a time."""
    if img.shape[-1] <= 4:
        return "rgb"
    aligned = (img.shape[-1] % (16 // img.element_size()) == 0
               and img.data_ptr() % 16 == 0)
    return "wide16" if aligned else "wide2b"


def phase_kernels(sd: dict, sd12: dict, dev) -> list:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    rows = []
    chains = [
        ("feat", 64, [f"feat_ext_block{i}.conv" for i in range(3)],
         (1, 1, 1)),
        ("motion", 128, [f"motion_conv{i}.conv" for i in (1, 2, 3)],
         (1, 1, 0)),
        ("offset", 64, ["fusion_dcn0.offset_conv"], (0,)),
        ("rec", 64, [f"rec_conv{i}.conv" for i in (1, 2, 3)], (1, 1, 0)),
    ]
    # The serve, video and videos phases' engine is the flagship at 720p,
    # as is the train phase's export check (train_export): the same shapes
    # (the launch keys hold no batch size). The infer_cli
    # phase runs the flagship on a 480x640 val pair and at 360x640, whose
    # cascade level is the 720p request's.
    main, q12, ev = (("main", "serve", "video", "videos", "train_export",
                      "dp_engine"), ("q12",), ("eval",))
    cli = ("infer_cli",)
    # The user tools' 720p shapes: profile_forward's qocc forwards (no
    # cascade), bench_kernels on dump_offsets' 720p planes.
    ut = ("user_tools",)
    q12s = q12 + ("q12_r8",)    # both q12 requests' chains and warp
    for h, w, chain in [(H, W, c) for c in chains]:
        rows += chain_rows(rnd, sd, *chain, 1, h, w, main + ut)
    for chain in chains[:2]:
        rows += chain_rows(rnd, sd, *chain, 1, H // 2, W // 2, main + cli)
    # The infer_cli phase's other shapes: the offset and reconstruction
    # chains at both sizes, the trunk chains at 360x640's cascade level.
    ih, iw = INFER_SIZE
    for h, w in ((EH, EW), (ih, iw)):
        for chain in (chains[2], chains[3]):
            rows += chain_rows(rnd, sd, *chain, 1, h, w, cli)
    for chain in chains[:2]:
        rows += chain_rows(rnd, sd, *chain, 1, ih // 2, iw // 2, cli)
    # The q12 phase's chains on its batch of val frames: the 64-wide trunk
    # chains at native and cascade resolution (infer_cli's val pair's
    # too), and the reference topology's 67-wide offset and reconstruction
    # chains.
    for h, w in ((EH, EW), (EH // 2, EW // 2)):
        for chain in chains[:2]:
            rows += chain_rows(rnd, sd12, *chain, EB, h, w, q12s + cli)
    rows += chain_rows(rnd, sd12, "offset67", 67,
                       ["fusion_dcn0.offset_conv"], (0,), EB, EH, EW, q12s)
    rows += chain_rows(rnd, sd12, "rec67", 67,
                       [f"rec_conv{i}.conv" for i in (1, 2, 3)],
                       (1, 1, 0), EB, EH, EW, q12s)

    dcn, dcn12 = [(d["fusion_dcn0.weight"].cuda(), d["fusion_dcn0.bias"].cuda())
                  for d in (sd, sd12)]
    rows.append(dcn_row(rnd, *dcn, 1, H, W, 1, DCN_TPU, main + ut))
    rows.append(dcn_row(rnd, *dcn, 1, ih, iw, 1, DCN_TPU, cli))
    # The flagship's fuse projection on the conv kernel, at its paths'
    # shapes.
    for h, w, paths in ((H, W, main + ut), (EH, EW, cli), (ih, iw, cli)):
        rows.append(fuse_row(rnd, sd, 1, h, w, paths))
    rows += parts_rows(rnd, sd, sd12, dcn12, ((1, H, W), (1, H // 2, W // 2)))
    # The v4 route's shapes on the eval path: qocc (C=64, R=1) at native
    # (infer_cli's val pair's too) and auto_scale's half resolution, q12
    # (C=67, R=2, also the q12 phase's); C=67 at R=4 (the training
    # config's radius), which no path of this run takes; and at R=8, the
    # q12_r8 request's (stream design).
    rows.append(dcn_row(rnd, *dcn, EB, EH, EW, 1, DCN_V4_TPU, ev + cli))
    rows.append(dcn_row(rnd, *dcn, EB, EH // 2, EW // 2, 1, DCN_V4_TPU, ev))
    rows.append(dcn_row(rnd, *dcn12, EB, EH, EW, 2, DCN_V4_TPU, q12 + ev))
    rows.append(dcn_row(rnd, *dcn12, EB, EH, EW, 4, DCN_V4_TPU, ()))
    rows.append(dcn_row(rnd, *dcn12, EB, EH, EW, Q12_R8, DCN_V4_TPU,
                        ("q12_r8",)))

    # Bounded warp of the RGB frame; flows reach past R = 16. The library
    # call is grid_sample on the clamped flow's normalized grid.
    for b, h, w, paths in ((1, H, W, main + ut),
                           (EB, EH, EW, q12s + ev + cli),
                           (EB, EH // 2, EW // 2, ev), (1, ih, iw, cli)):
        rows.append(warp_row(rnd, b, h, w, paths, dev))
    # The train phase's DCN (C=64, R=1, the v4 route the JAX trainer takes)
    # and RGB warp at its three shapes: the microbatches, the val batches,
    # the sample dump.
    th, tw = TRAIN_RECIPE["crop_size"]
    for b, path in TRAIN_PATHS.items():
        # (dp_train's ranks run one pair of each microbatch: b=1)
        paths = (path, "dp_train") if b == 1 else (path,)
        rows.append(dcn_row(rnd, *dcn, b, th, tw, 1, DCN_V4_TPU, paths))
        rows.append(warp_row(rnd, b, th, tw, paths, dev))
    return (rows + spatial_rows(rnd, sd, dcn, dev)
            + tool_rows(rnd, gen, dcn12, dev)
            + user_tool_rows(rnd, dcn, dcn12, dev)
            + f32_rows(rnd, gen, sd, chains, dcn, dcn12, dev))


def f32_rows(rnd, gen, sd, chains, dcn, dcn12, dev) -> list:
    """The float32 instances (rows named `..._f32`): each of the eight
    TPU kernels' rows at its bf16 row's shape (PERF.md section 6), and
    every shape the float32 phases launch: the flagship's chains, DCN and
    warp at 720p and its cascade's 360x640 (`fp32`, whose CLI request
    runs at 720p too), the eval sweep's DCN and warp at 4x480x640
    (`eval_fp32`), the training microbatch's at 2x320x320 (`train_fp32`);
    the DCN at C=67 R=2 and R=8 (both on the stream design in float32),
    the wide warp's two instances at C=64 and C=67, the single conv's
    im2col and v2 rows."""
    f32 = torch.float32
    fp, ev, tr = ("fp32",), ("eval_fp32",), ("train_fp32",)
    # dump_offsets (720p) and offset_stats (480x640) run the model in
    # float32.
    ut = ("user_tools",)
    eh, ew = bench_kernels.SIZES["vga"]
    th, tw = TRAIN_RECIPE["crop_size"]
    rows = []
    for chain in chains:
        rows += chain_rows(rnd, sd, *chain, 1, H, W, fp, dt=f32)
    for chain in chains[:2]:
        rows += chain_rows(rnd, sd, *chain, 1, H // 2, W // 2, fp, dt=f32)
    rows.append(conv2d_row(rnd, gen, 64, 64, 3, 1, H, W, "im2col", CONV_TPU,
                           (), dt=f32))
    rows.append(conv2d_row(rnd, gen, 64, 64, 3, 1, H, W, "v2", CONV_V2_TPU,
                           (), dt=f32))
    for b, h, w, paths, tpu in ((1, H, W, fp + ut, DCN_TPU),
                                (EB, EH, EW, ev + ut, DCN_V4_TPU),
                                (2, th, tw, tr, DCN_V4_TPU)):
        rows.append(dcn_row(rnd, *dcn, b, h, w, 1, tpu, paths, dt=f32))
        rows.append(warp_row(rnd, b, h, w, paths, dev, dt=f32))
    for R in (2, Q12_R8):
        rows.append(dcn_row(rnd, *dcn12, 1, eh, ew, R, DCN_V3_TPU, (),
                            dt=f32))
    for c in (64, 67):
        rows.append(warp_row(rnd, 1, eh, ew, (), dev, c,
                             bench_kernels.WARP_R, WARP_V1_TPU, dt=f32))
    return rows


def spatial_rows(rnd, sd, dcn, dev) -> list:
    """The spatial phase's shapes: each trunk layer as a one-layer chain
    (the conv kernel) at the rank's slab (608x1920) and, for the motion
    stages, at the coarse pass (544x960); the DCN and the RGB warp at the
    slab. One row a layer shape (the keys hold the channels, not the
    layer)."""
    hl = (SP_H + (-SP_H) % (8 * DP_RANKS)) // DP_RANKS
    slab = hl + 2 * required_halo(3, 1, 16)
    coarse = (hl * DP_RANKS // 2, SP_W // 2)
    sp = ("spatial",)
    motion = [("layer64x64", 64, ["feat_ext_block0.conv"], (1,)),
              ("layer128x64", 128, ["motion_conv1.conv"], (1,)),
              ("layer64x2", 64, ["motion_conv3.conv"], (0,))]
    fine = motion + [("offset", 64, ["fusion_dcn0.offset_conv"], (0,)),
                     ("layer64x32", 64, ["rec_conv2.conv"], (1,)),
                     ("layer32x3", 32, ["rec_conv3.conv"], (0,))]
    rows = []
    for layer in fine:
        rows += chain_rows(rnd, sd, *layer, 1, slab, SP_W, sp)
    for layer in motion:
        rows += chain_rows(rnd, sd, *layer, 1, *coarse, sp)
    rows.append(dcn_row(rnd, *dcn, 1, slab, SP_W, 1, DCN_TPU, sp))
    rows.append(warp_row(rnd, 1, slab, SP_W, sp, dev))
    return rows


def tool_rows(rnd, gen, dcn12, dev) -> list:
    """The kernels the tools phase launches, at the tools' shapes (key
    paths ("tools",)), and the shapes of the contracts this slice added
    that no path takes (key paths ()): the conv at k = 1 and 5, the DCN at
    radii that need smaller tiles or channel chunks, the wide warp at
    R = 4 and, on its 2-byte instance, at C = 67."""
    tools = ("tools",)
    rows = [conv2d_row(rnd, gen, cin, cout, 3, 1, H, W, "im2col", CONV_TPU,
                       tools) for cin, cout in bench_conv.ALL_SHAPES]
    rows += [conv2d_row(rnd, gen, cin, 64, 3, 1, H, W, "v2", CONV_V2_TPU,
                        tools) for cin in (64, 128)]
    rows.append(conv2d_row(rnd, gen, 64, 32, 1, 1, EH, EW, "im2col",
                           CONV_TPU, (), act=False))
    rows.append(conv2d_row(rnd, gen, 64, 64, 5, 1, EH, EW, "im2col",
                           CONV_TPU, ()))
    # bench_kernels' defaults (vga, C=67, R=2) with q12's weights, then
    # C=67 R=8 and C=128 at R=4 and 8 with random ones.
    eh, ew = bench_kernels.SIZES["vga"]
    rows.append(dcn_row(rnd, *dcn12, 1, eh, ew, 2, DCN_V3_TPU, tools))
    rows.append(dcn_row(rnd, *dcn12, 1, eh, ew, 8, DCN_V3_TPU, ()))
    w128 = torch.randn(128, 128, 3, 3, generator=gen, device=dev) / 34.0
    b128 = torch.randn(128, generator=gen, device=dev) * 0.1
    for R in (4, 8):
        rows.append(dcn_row(rnd, w128, b128, 1, eh, ew, R, DCN_V3_TPU, ()))
    for c, R, paths in ((3, bench_kernels.WARP_R, tools),
                        (64, bench_kernels.WARP_R, tools), (64, 4, ()),
                        (67, bench_kernels.WARP_R, ())):
        rows.append(warp_row(rnd, 1, eh, ew, paths, dev, c, R,
                             WARP_TPU if c == 3 else WARP_V1_TPU))
    return rows


def user_tool_rows(rnd, dcn, dcn12, dev) -> list:
    """The user tools' shapes no other path launches: bench_flowprior's
    DCN on q3ft (C=67, R=2) at its 4x720x1280 batch, and
    bench_train_step's DCN (C=64, R=2) and RGB warp on its 2x256x256
    microbatches. Their JAX routes ran the v4 DCN."""
    ut = ("user_tools",)
    crop = USER_TRAIN_CROP
    return [dcn_row(rnd, *dcn12, EB, H, W, 2, DCN_V4_TPU, ut),
            dcn_row(rnd, *dcn, 2, crop, crop, 2, DCN_V4_TPU, ut),
            warp_row(rnd, 2, crop, crop, ut, dev)]


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = (a.float() - b.float()).pow(2).mean().item()
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def port_kernels_of(fn) -> dict:
    """The port's kernels that ran in `fn()`, by name, read off the
    profiler's device trace: a CUDA graph's replayed kernels show there
    one by one, where the wrappers' counters see none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(port_kernel_counts(prof.events()))


def cat_kernels_of(fn) -> int:
    """How many concatenation kernels (PyTorch's CatArrayBatchedCopy) ran
    in `fn()`, read off the profiler's device trace (a replay's too)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for ev in prof.events()
               if ev.device_type == cuda and "CatArrayBatchedCopy" in ev.name)


def kernel_family_failures(tag: str, ran: dict) -> list:
    """One engine launch's port kernels (`port_kernels_of`) against
    PER_LAUNCH: 3 DCN and 1 warp kernels, and a conv kernel at least for
    each chain (`conv_chain` runs one a layer)."""
    fam = Counter()
    for name, n in ran.items():
        fam["deform_conv2d_bounded" if name.startswith("dcn_") else
            "bounded_warp" if name.startswith("warp_") else "conv_chain"] += n
    if (fam["deform_conv2d_bounded"] != PER_LAUNCH["deform_conv2d_bounded"]
            or fam["bounded_warp"] != PER_LAUNCH["bounded_warp"]
            or fam["conv_chain"] < PER_LAUNCH["conv_chain"]):
        return [f"{tag}: device kernels {ran}"]
    return []


def phase_main(params, flow_params) -> dict:
    gen = np.random.default_rng(SEED)
    f0, f1 = smooth_frames(gen, 2)
    requests = [(f0[:1], f1[:1]), (f1[:1], f0[:1]), (f0[1:], f1[1:]),
                (f0, f1)]
    eng = FrameInterpolator(params, flow_params=flow_params, device=CARD0,
                            **FLAGSHIP)
    for a, b in requests[-2:]:             # warm-up: allocator, cuDNN plans,
        eng.midpoints(a, b)                # for both request shapes
    # The b=1 key's second launch, under a profiler: eager (a capture is
    # never profiled). Its port kernels, read off the device trace.
    eager_kernels = port_kernels_of(lambda: eng.midpoints(*requests[0]))

    reset_launch_counts()
    g0 = dict(eng.graph_stats)
    outs, times = [], []
    for a, b in requests:
        t0 = time.perf_counter()
        out = eng.midpoints(a, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    counts, forms = launch_counts(), input_form_counts()
    by_shape = shapes_now()
    graphs = graph_delta(eng, g0)
    # Each key's next launch is captured, the b=1 key's later ones replay;
    # a replay's kernels, read off the device trace, are the eager run's.
    replay_kernels = port_kernels_of(lambda: eng.midpoints(*requests[0]))
    # A replayed launch's concatenation kernels against an eager launch of
    # the forward that concatenates (a twin whose every launch runs eager).
    cat_eng = FrameInterpolator(params, flow_params=flow_params,
                                device=CARD0, **FLAGSHIP)
    cat_eng.model._reads_parts = lambda x: False
    cat_eng._graph_key = lambda *args: None
    cat_eng.midpoints(*requests[0])
    cats = {"replayed": cat_kernels_of(lambda: eng.midpoints(*requests[0])),
            "concatenating": cat_kernels_of(
                lambda: cat_eng.midpoints(*requests[0]))}

    failures = launch_failures("main", counts, body_runs(graphs))
    if forms["copied"] != 0:
        failures.append(f"main: launches by input form {forms}: a wrapper "
                        f"copied an input")
    if cats["replayed"] != cats["concatenating"] - CAT_KERNELS_GONE:
        failures.append(f"main: concatenation kernels {cats}, expected "
                        f"{CAT_KERNELS_GONE} fewer in the replay")
    if graphs != {"captured": 2, "replayed": 2, "eager": 0, "evicted": 0}:
        failures.append(f"main: graph_stats moved by {graphs}")
    failures += kernel_family_failures("main eager", eager_kernels)
    if replay_kernels != eager_kernels:
        failures.append(f"main: a replay ran the device kernels "
                        f"{replay_kernels}, the eager launch {eager_kernels}")
    if failures:
        raise AssertionError("; ".join(failures))
    for (a, _), out in zip(requests, outs):
        if tuple(out.shape) != a.shape:
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError("non-finite output")
        if out.min().item() < 0.0 or out.max().item() > 1.0:
            raise AssertionError("output outside [0, 1]")

    plain = FrameInterpolator(params, flow_params=flow_params,
                              device=CARD0, use_kernels=False, **FLAGSHIP)
    psnrs = [psnr(out, plain.midpoints(a, b))
             for (a, b), out in zip(requests, outs)]
    if not min(psnrs) >= PSNR_FLOOR_DB:
        raise AssertionError(f"PSNR vs plain engine {psnrs} below "
                             f"{PSNR_FLOOR_DB} dB")
    pairs = sum(a.shape[0] for a, _ in requests)
    return {"phase": "main", "requests": [a.shape[0] for a, _ in requests],
            "request_seconds": times, "launches": counts, "graphs": graphs,
            "launches_by_input": forms, "cat_kernels": cats,
            "device_kernels_eager": eager_kernels,
            "device_kernels_replayed": replay_kernels,
            "frames_per_s_b1": 1.0 / float(np.median(times[:3])),
            "frames_per_s_b2": 2.0 / times[3],
            "pairs": pairs, "psnr_vs_plain_db": psnrs,
            "psnr_floor_db": PSNR_FLOOR_DB, "_by_shape": by_shape,
            "_engine": eng, "_request": requests[0]}


def u8(frames: np.ndarray) -> np.ndarray:
    """float32 [0, 1] -> uint8 as the server rounds: x * 255 + 0.5."""
    return np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean(((a.astype(np.float64) - b.astype(np.float64)) / 255.0)
                  ** 2)
    return float("inf") if mse == 0 else float(10.0 * np.log10(1.0 / mse))


def phase_serve(params, flow_params) -> dict:
    """(a) The flagship engine (io_uint8) behind the HTTP server under
    SERVE_MIX; (b) the serve CLI's own server at its defaults. Emits a
    line per route (with what the engine's CUDA graphs did in it: the
    launches captured, replayed and run eager, the share replayed, and
    the worker's launches by kind) and returns the phase's summary."""
    t0 = time.perf_counter()
    f0, f1 = smooth_frames(np.random.default_rng(SEED), 2)
    a, b = u8(f0), u8(f1)
    pairs = [(a[0], b[0]), (b[0], a[0]), (a[1], b[1]), (b[1], a[1])]
    # Five consecutive frames of a steady motion, from each texture.
    seqs = [np.stack([np.roll(a[i], (3 * k, 6 * k), axis=(0, 1))
                      for k in range(SERVE_SEQ + 1)]) for i in range(2)]
    bodies = {"raw": [encode_raw_body(x, y) for x, y in pairs],
              "png": [encode_pair_body(native.encode_png_rgb(x),
                                       native.encode_png_rgb(y))
                      for x, y in pairs],
              "seq": [encode_seq_body(fr) for fr in seqs]}

    eng = FrameInterpolator(params, flow_params=flow_params, device=CARD0,
                            io_uint8=True, **FLAGSHIP)
    server = InterpolationServer(eng, port=0, **SERVE_BATCHER)
    # The batcher worker's launches: (seconds, the engine's graph_stats
    # moved by it); one worker thread, so no two overlap.
    worker = []
    for name in ("_launch", "_launch_seq"):
        def timed(*args, _launch=getattr(server.batcher, name)):
            g0, t = dict(eng.graph_stats), time.perf_counter()
            try:
                return _launch(*args)
            finally:
                worker.append((time.perf_counter() - t,
                               graph_delta(eng, g0)))
        setattr(server.batcher, name, timed)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    routes, by_shape = [], {fn.__name__: Counter() for fn in WRAPPERS}
    try:
        reset_launch_counts()
        g0, t1 = dict(eng.graph_stats), time.perf_counter()
        server.warmup([(H, W), (SERVE_SEQ + 1, H, W)])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
        warm_graphs = graph_delta(eng, g0)
        add_shapes(by_shape, shapes_now())  # the kernels of its captures
        for route, clients, total in SERVE_MIX:
            server.batcher.stats = BatcherStats()
            g0, n0 = dict(eng.graph_stats), len(worker)
            reset_launch_counts()
            res = run_load(url, bodies[route], clients, total, 120.0,
                           raw=route == "raw",
                           seq=SERVE_SEQ if route == "seq" else 0, keep=True)
            counts = launch_counts()
            add_shapes(by_shape, shapes_now())
            graphs = graph_delta(eng, g0)
            launches = sum(graphs[k] for k in ("eager", "captured",
                                                "replayed"))
            busy = sum(sec for sec, _ in worker[n0:])
            res.update(route=route, requests=total,
                       engine_launches=launches, launches=counts,
                       graphs=graphs, body_runs=body_runs(graphs),
                       graph_hit_pct=(100.0 * graphs["replayed"] / launches
                                      if launches else None),
                       worker_launch_ms=worker_launch_ms(worker[n0:]),
                       worker_busy_s=busy,
                       worker_busy_share=busy / res["wall_s"])
            routes.append(res)
    finally:
        server.shutdown()

    plain = FrameInterpolator(params, flow_params=flow_params, device=CARD0,
                              io_uint8=True, use_kernels=False, **FLAGSHIP)
    ref_pairs = plain.midpoints(np.stack([x for x, _ in pairs]),
                                np.stack([y for _, y in pairs])).cpu().numpy()
    ref_seqs = [plain.midpoints_sequence(fr).cpu().numpy() for fr in seqs]

    failures = []
    for res in routes:
        route, responses = res["route"], res.pop("responses")
        bad = [(st, data) for st, data in responses if st != 200]
        if bad or res["errors"]:
            failures.append(f"{route}: statuses "
                            f"{sorted({st for st, _ in bad})}, the first "
                            f"answer {bad[0][1][:300]!r}")
            continue
        failures += launch_failures(route, res["launches"],
                                    res["body_runs"])
        outs, psnrs = [], []
        for i, (_, data) in enumerate(responses):
            if route == "seq":
                got = np.frombuffer(data, np.uint8).reshape(SERVE_SEQ, H, W, 3)
                psnrs += [psnr_u8(g, r) for g, r in
                          zip(got, ref_seqs[i % len(seqs)])]
            else:
                got = (native.decode_png_rgb(data) if route == "png" else
                       np.frombuffer(data, np.uint8).reshape(H, W, 3))
                psnrs.append(psnr_u8(got, ref_pairs[i % len(pairs)]))
            outs.append(got)
        res["psnr_vs_plain_db_min"] = min(psnrs)
        res["midpoints_checked"] = len(psnrs)
        if not min(psnrs) >= PSNR_FLOOR_DB:
            failures.append(f"{route}: PSNR vs plain engine {min(psnrs)} "
                            f"below {PSNR_FLOOR_DB} dB")
        res["_outs"] = outs
    by_route = {r["route"]: r for r in routes}
    png_raw = None
    if "_outs" in by_route["png"] and "_outs" in by_route["raw"]:
        png_raw = max(int(np.abs(p.astype(np.int16) - r.astype(np.int16))
                          .max()) for p, r in zip(by_route["png"]["_outs"],
                                                  by_route["raw"]["_outs"]))
        if png_raw > SERVE_PNG_RAW_LEVELS:
            failures.append(f"PNG vs raw responses differ by {png_raw} "
                            f"levels, more than {SERVE_PNG_RAW_LEVELS}")
    for res in routes:
        res.pop("_outs", None)
        emit({"phase": "serve_route", **res})

    cli = phase_serve_cli()
    emit(cli)
    if cli["failures"]:
        failures += cli["failures"]
    if failures:
        raise AssertionError("serve: " + "; ".join(failures))
    return {"phase": "serve", "seconds": time.perf_counter() - t0,
            "warmup_seconds": warm_s, "warmup_graphs": warm_graphs,
            "batcher": SERVE_BATCHER, "png_vs_raw_max_levels": png_raw,
            "routes": {r["route"]: {k: r[k] for k in (
                "requests_per_s", "midpoints_per_s", "latency_ms_p50",
                "latency_ms_p99", "engine_launches", "graphs",
                "graph_hit_pct", "worker_launch_ms", "worker_busy_share",
                "wall_s")}
                for r in routes},
            "_by_shape": by_shape}


def worker_launch_ms(worker: list) -> dict:
    """The batcher worker's launches by what the engine did in them (one
    a batch: "captured" where one of its engine launches was captured,
    else "eager" where one ran eager, else "replayed"): their number and
    median milliseconds. A capture adds its eager run and its recording
    to the requests of its batch."""
    kinds = {"replayed": [], "captured": [], "eager": []}
    for sec, d in worker:
        kinds["captured" if d["captured"] else "eager" if d["eager"]
              else "replayed"].append(sec)
    return {k: {"n": len(v), "median_ms": float(np.median(v)) * 1e3
                if v else None} for k, v in kinds.items()}


def phase_serve_cli() -> dict:
    """The serve CLI's own server at the JAX CLI's defaults (exact DCN,
    unbounded warp, io_uint8, no kernel): CLI_REQUESTS raw requests at
    CLI_H x CLI_W, answered 200 with uint8 midpoints of that shape, and
    no kernel launched."""
    t0 = time.perf_counter()
    server = serve_cli.build_server(["--model_path", CKPT + ".npz",
                                     "--flow_prior", "--port", "0"]).start()
    gen = np.random.default_rng(SEED + 2)
    body = encode_raw_body(*(gen.integers(0, 256, (CLI_H, CLI_W, 3))
                             .astype(np.uint8) for _ in range(2)))
    try:
        reset_launch_counts()
        res = run_load(f"http://127.0.0.1:{server.port}", body, CLI_REQUESTS,
                       CLI_REQUESTS, 300.0, raw=True, keep=True)
        counts = launch_counts()
    finally:
        server.shutdown()
    failures = []
    for status, data in res.pop("responses"):
        if status != 200 or len(data) != CLI_H * CLI_W * 3:
            failures.append(f"cli: status {status}, {len(data)} bytes")
    if any(counts.values()):
        failures.append(f"cli: kernels launched {counts}")
    return {"phase": "serve_cli", "seconds": time.perf_counter() - t0,
            "size": [CLI_H, CLI_W], "launches": counts,
            "engine": "exact DCN, unbounded warp, io_uint8, bf16",
            "failures": failures, **res}


class MemorySource:
    """An open capture over BGR uint8 frames held in memory: the methods
    `interpolate_video` calls on a `cv2.VideoCapture`."""

    def __init__(self, frames, fps: float):
        self.frames, self.fps, self.i = frames, fps, 0

    def isOpened(self) -> bool:
        return True

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1]

    def get(self, prop):
        h, w = self.frames[0].shape[:2]
        return {CAP_PROP_FPS: self.fps, CAP_PROP_FRAME_WIDTH: w,
                CAP_PROP_FRAME_HEIGHT: h,
                CAP_PROP_FRAME_COUNT: len(self.frames)}[prop]

    def release(self) -> None:
        pass


class MemorySink:
    """An open writer that keeps the frames written, in order."""

    def __init__(self):
        self.frames = []

    def isOpened(self) -> bool:
        return True

    def write(self, frame) -> None:
        self.frames.append(frame)

    def release(self) -> None:
        pass


class TimedGraph:
    """A captured launch's CUDA graph whose replays a tap times: CUDA
    events around the replay, then a copy of the static output, into the
    tap's list."""

    def __init__(self, graph, g, outs):
        self.graph, self.g, self.outs = graph, g, outs

    def replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        self.outs.append((self.g.out.clone(), a, b))


def tap_forwards(eng) -> list:
    """Keeps each of `eng`'s engine launches (the guard splits a call into
    several) in the returned list, from now until the next tap of `eng`:
    its output and the device time from its first kernel to its last
    (CUDA events around the launch's work, no synchronisation): the
    launch body where it runs eager (a captured launch's eager run; its
    recording runs nothing), the graph where it replays. The engine takes
    the route a user's engine takes."""
    outs = []
    body = FrameInterpolator._launch_body.__get__(eng)
    capture = FrameInterpolator._capture.__get__(eng)

    def tapped(x, y, scaled):
        if torch.cuda.is_current_stream_capturing():
            return body(x, y, scaled)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = body(x, y, scaled)
        b.record()
        outs.append((out, a, b))
        return out

    def tap(g):
        if isinstance(g, pair._Graph):
            g.graph = TimedGraph(getattr(g.graph, "graph", g.graph), g, outs)
        return g

    def tapped_capture(key, f0, f1):
        out, g = capture(key, f0, f1)
        return out, tap(g)

    for g in list(eng._graphs.values()):
        tap(g)
    eng._launch_body, eng._capture = tapped, tapped_capture
    return outs


def engine_device_s(outs: list) -> float:
    """Seconds of device time the tapped forwards spanned (synchronised
    first)."""
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for _, a, b in outs) / 1e3


def moving_frames(gen: np.random.Generator, n: int) -> list:
    """n (H, W, 3) uint8 frames of one smooth texture in a steady shift of
    (3, 6) pixels a frame, as the serve phase's sequences; read as BGR."""
    base = u8(smooth_frames(gen, 1)[0][0])
    return [np.ascontiguousarray(np.roll(base, (3 * k, 6 * k), axis=(0, 1)))
            for k in range(n)]


def launch_failures(tag: str, counts: dict, runs: int,
                    per: dict = PER_LAUNCH) -> list:
    """Wrappers whose launches are not `per`'s (PER_LAUNCH, or
    PER_LAUNCH_CAT) for `runs` runs of the engine's launch body
    (`body_runs`)."""
    return [f"{tag}: {k} {v} launches over {runs} runs of the launch body"
            for k, v in counts.items() if v != per[k] * runs]


def graph_delta(eng, since: dict) -> dict:
    """`eng.graph_stats` less `since`, a copy of it taken before."""
    return {k: v - since[k] for k, v in eng.graph_stats.items()}


def body_runs(d: dict) -> int:
    """How often the engine launches of the `graph_stats` difference `d`
    ran their kernels through the wrappers, which count a kernel where
    they launch it: once an eager launch, twice a captured one (its eager
    run, then its recording), never a replay (`port_kernels_of` reads a
    replay's kernels off the device trace)."""
    return d["eager"] + 2 * d["captured"]


def phase_video(eng, plain) -> dict:
    """The single-clip pipeline over frames in memory: VIDEO_FRAMES at
    VIDEO_FPS (factor 3) through `eng` (the flagship, float io), held
    against the same pipeline through `plain` (its plain-version twin);
    then a reference_compat pass over VIDEO_COMPAT_FRAMES."""
    t0 = time.perf_counter()
    frames = moving_frames(np.random.default_rng(SEED + 3), VIDEO_FRAMES)
    kw = dict(scale=1.0, batch_pairs=VIDEO_BATCH)
    x = np.stack([to_float(f, (W, H), True) for f in frames])
    eng.midpoints(x[:4], x[1:5])            # warm-up: the b=4 launch
    torch.cuda.synchronize()
    outs = tap_forwards(eng)
    reset_launch_counts()
    g0 = dict(eng.graph_stats)
    sink = MemorySink()
    t1 = time.perf_counter()
    stats = interpolate_video(MemorySource(frames, VIDEO_FPS), sink, eng,
                              **kw)
    wall = time.perf_counter() - t1
    counts, by_shape = launch_counts(), shapes_now()
    graphs = graph_delta(eng, g0)
    launches, engine_s = len(outs), engine_device_s(outs)
    ref = MemorySink()
    interpolate_video(MemorySource(frames, VIDEO_FPS), ref, plain, **kw)

    failures = launch_failures("video", counts, body_runs(graphs))
    factor = stats["factor"]
    n_out = VIDEO_FRAMES + (VIDEO_FRAMES - 1) * factor
    # one batch of VIDEO_BATCH pairs; three `midpoints` calls (the
    # midpoint, then both quarter points), each split by the engine's
    # pixel guard
    want_launches = 3 * math.ceil(
        VIDEO_BATCH / (eng.max_px_per_launch // (H * W)))
    if factor != 3 or stats["frames_written"] != n_out or len(
            sink.frames) != n_out or launches != want_launches:
        failures.append(f"video: factor {factor}, {len(sink.frames)} frames "
                        f"written of {n_out}, {launches} engine launches of "
                        f"{want_launches}")
    if not all(torch.isfinite(o).all().item() for o, _, _ in outs):
        failures.append("video: non-finite engine output")
    psnrs = []
    for i, (got, want) in enumerate(zip(sink.frames, ref.frames)):
        if i % (factor + 1) == 0:           # a source frame, then factor
            if not np.array_equal(got, frames[i // (factor + 1)]):
                failures.append(f"video: source frame {i} changed")
        else:
            psnrs.append(psnr_u8(got, want))
    if not psnrs or min(psnrs) < PSNR_FLOOR_DB:
        failures.append(f"video: PSNR vs plain pipeline {min(psnrs or [0])}"
                        f" below {PSNR_FLOOR_DB} dB")

    # reference_compat: per pair the shifted midpoint `factor` times, then
    # the pair's first frame unshifted; BGR frames straight to the engine
    few = frames[:VIDEO_COMPAT_FRAMES]
    compat = MemorySink()
    interpolate_video(MemorySource(few, VIDEO_FPS), compat, eng,
                      reference_compat=True, **kw)
    xb = np.stack([to_float(f, (W, H), False) for f in few])
    mids = eng.midpoints(xb[:-1], xb[1:]).cpu().numpy()
    want = []
    for i in range(len(few) - 1):
        want += [to_u8(mids[i], False, True)] * factor + [few[i]]
    want.append(few[-1])
    compat_levels = None
    if len(compat.frames) != len(want):
        failures.append(f"video compat: {len(compat.frames)} frames, "
                        f"expected {len(want)}")
    else:
        compat_levels = max(int(np.abs(g.astype(np.int16) - w.astype(
            np.int16)).max()) for g, w in zip(compat.frames, want))
        shift = float(np.mean(np.abs(to_u8(mids[0], False, True).astype(
            np.int16) - to_u8(mids[0], False, False).astype(np.int16))))
        dup = compat.frames[:factor]
        if (compat_levels > 1 or shift < 1.0
                or not all(np.array_equal(d, dup[0]) for d in dup)):
            failures.append(f"video compat: {compat_levels} levels from the "
                            f"expected frames, shift {shift} levels")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "video", "seconds": time.perf_counter() - t0,
            "size": [H, W], "source_fps": VIDEO_FPS, "stats": stats,
            "pipeline_seconds": wall,
            "frames_written_per_s": stats["frames_written"] / wall,
            "midpoints_per_s": (stats["frames_written"] - VIDEO_FRAMES)
            / wall,
            "engine_launches": launches, "launches": counts,
            "graphs": graphs,
            "engine_device_s": engine_s, "engine_share": engine_s / wall,
            "psnr_vs_plain_db_min": min(psnrs),
            "compat_frames": len(compat.frames),
            "compat_max_levels": compat_levels, "_by_shape": by_shape}


def phase_videos(eng, plain) -> dict:
    """VIDEOS_CLIPS clips in memory through `interpolate_videos` and one
    shared MicroBatcher over `eng`; each inserted frame against `plain`'s
    midpoint of its pair. A clip has one pair in flight at a time (its
    pipeline waits on each), so a launch of more than one pair holds pairs
    of both clips: the batcher made fewer launches than it took pairs."""
    t0 = time.perf_counter()
    gen = np.random.default_rng(SEED + 4)
    clips = [moving_frames(gen, VIDEOS_FRAMES) for _ in range(VIDEOS_CLIPS)]
    outs = tap_forwards(eng)
    reset_launch_counts()
    g0 = dict(eng.graph_stats)
    sinks = [MemorySink() for _ in clips]
    t1 = time.perf_counter()
    stats = interpolate_videos([MemorySource(c, VIDEOS_FPS) for c in clips],
                               sinks, eng, scale=1.0, **VIDEOS_BATCHER)
    wall = time.perf_counter() - t1
    counts, by_shape = launch_counts(), shapes_now()
    graphs = graph_delta(eng, g0)
    launches, engine_s = len(outs), engine_device_s(outs)
    snap = stats[0]["batcher"]
    pairs = VIDEOS_CLIPS * (VIDEOS_FRAMES - 1)
    failures = launch_failures("videos", counts, body_runs(graphs))
    if launches != sum(graphs[k] for k in ("eager", "captured", "replayed")):
        failures.append(f"videos: {launches} launches timed, graph_stats "
                        f"moved by {graphs}")
    if not snap["requests"] == pairs > snap["batches"]:
        failures.append(f"videos: {snap['requests']} pairs in "
                        f"{snap['batches']} launches: no launch held both "
                        f"clips")
    psnrs = []
    for frames, sink, st in zip(clips, sinks, stats):
        x = np.stack([to_float(f, (W, H), True) for f in frames])
        ref = plain.midpoints(x[:-1], x[1:]).cpu().numpy()
        if st["factor"] != 1 or len(sink.frames) != 2 * len(frames) - 1:
            failures.append(f"videos: factor {st['factor']}, "
                            f"{len(sink.frames)} frames written")
            continue
        for i, got in enumerate(sink.frames):
            if i % 2 == 0:
                if not np.array_equal(got, frames[i // 2]):
                    failures.append(f"videos: source frame {i} changed")
            else:
                psnrs.append(psnr_u8(got, to_u8(ref[i // 2], True, False)))
    if not psnrs or min(psnrs) < PSNR_FLOOR_DB:
        failures.append(f"videos: PSNR vs plain engine {min(psnrs or [0])} "
                        f"below {PSNR_FLOOR_DB} dB")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "videos", "seconds": time.perf_counter() - t0,
            "clips": VIDEOS_CLIPS, "frames_per_clip": VIDEOS_FRAMES,
            "batcher": snap, "pipeline_seconds": wall,
            "midpoints_per_s": pairs / wall, "engine_launches": launches,
            "graphs": graphs,
            "engine_device_s": engine_s, "engine_share": engine_s / wall,
            "launches": counts, "psnr_vs_plain_db_min": min(psnrs),
            "_by_shape": by_shape}


def infer_cli_request(argv: list, tag: str, failures: list) -> tuple:
    """`cli.infer.main(argv)` (a `two-frame` request) with a tap on the
    engine class: the PNG it writes, decoded again, must equal the
    engine's own midpoint truncated to uint8, bit for bit, from one engine
    launch with 8 / 3 / 1 kernel launches (failures appended). Returns
    (the request's summary, its launches by shape)."""
    mids, fwds = [], []
    real_mid, real_fwd = FrameInterpolator.midpoints, FrameInterpolator._forward

    def mid(self, f0, f1):
        out = real_mid(self, f0, f1)
        mids.append(out)
        return out

    def fwd(self, x, y):
        fwds.append(1)
        return real_fwd(self, x, y)

    out = argv[argv.index("--output") + 1]
    reset_launch_counts()
    FrameInterpolator.midpoints, FrameInterpolator._forward = mid, fwd
    t1 = time.perf_counter()
    try:
        rc = infer_cli.main(argv)
    finally:
        FrameInterpolator.midpoints = real_mid
        FrameInterpolator._forward = real_fwd
    secs = time.perf_counter() - t1
    counts, by_shape = launch_counts(), shapes_now()
    with open(out, "rb") as f:
        got = native.decode_png_rgb(f.read())
    want = (np.clip(mids[0][0].float().cpu().numpy(), 0, 1)
            * 255).astype(np.uint8)
    failures += launch_failures(
        tag, counts, len(fwds),
        PER_LAUNCH_CAT if "--fp32" in argv else PER_LAUNCH)
    if rc != 0 or len(mids) != 1 or len(fwds) != 1 or not (
            np.array_equal(got, want)):
        failures.append(f"{tag}: rc {rc}, {len(fwds)} engine "
                        f"launches, PNG {got.shape} vs the engine's "
                        f"midpoint {want.shape}")
    return ({"size": list(got.shape[:2]), "seconds": secs,
             "launches": counts,
             "png_equals_midpoint": bool(np.array_equal(got, want))},
            by_shape)


def infer_cli_argv(out: str, *extra) -> list:
    """`two-frame` on INFER_PAIR with the flagship flags on card 0."""
    scene, a, b = INFER_PAIR
    return ["two-frame", "--frame0", os.path.join(VAL, scene, a),
            "--frame1", os.path.join(VAL, scene, b), "--output", out,
            "--model_path", CKPT + ".npz", *INFER_FLAGS, "--device", CARD0,
            *extra]


def phase_infer_cli() -> dict:
    """`cli.infer.main(["two-frame", ...])` with the flagship flags on a
    val pair, natively and with `--size` (`infer_cli_request`)."""
    t0 = time.perf_counter()
    requests, failures = [], []
    by_shape = {fn.__name__: Counter() for fn in WRAPPERS}
    with tempfile.TemporaryDirectory() as tmp:
        for size in (None, INFER_SIZE):
            extra = ["--size", str(size[0]), str(size[1])] if size else []
            req, shapes = infer_cli_request(
                infer_cli_argv(os.path.join(tmp, f"mid{len(requests)}.png"),
                               *extra),
                f"infer_cli {size or 'native'}", failures)
            for fn, c in shapes.items():
                by_shape[fn].update(c)
            requests.append(req)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "infer_cli", "seconds": time.perf_counter() - t0,
            "pair": list(INFER_PAIR), "flags": INFER_FLAGS,
            "requests": requests, "_by_shape": by_shape}


def dtype_failures(tag: str, by_shape: dict, want: str) -> list:
    """Launch keys of another instance than `want` ("f32" or "bf16")."""
    other = sorted({key[-1] for c in by_shape.values() for key in c
                    if key[-1] != want})
    return [f"{tag}: launches of the {o} instances" for o in other]


def add_shapes(acc: dict, shapes: dict) -> None:
    for fn, c in shapes.items():
        acc.setdefault(fn, Counter()).update(c)


def phase_fp32(params, flow_params, eng16) -> dict:
    """The flagship in float32 (FLAGSHIP_F32: `bf16=False`, the kernels'
    float32 instances) on card 0 at 720p: one b=1 and one b=2 request
    through the kernels against the float32 plain-version engine (max abs
    error F32_ENGINE_ABS, PSNR F32_PSNR_DB), 8 / 3 / 1 launches per engine
    launch, every one a float32 instance; frames/s at b=1 and b=2 in
    turns with the bf16 flagship engine `eng16` (F32_TURNS: 3 b=1 requests
    and one b=2 a turn); the float32 and bf16 midpoints' PSNR against each
    other; then one `infer two-frame --fp32` request on card 0
    (`infer_cli_request`, the val pair resized to 720p: the flagship's
    shapes)."""
    t0 = time.perf_counter()
    f0, f1 = smooth_frames(np.random.default_rng(SEED), 2)
    requests = [(f0[:1], f1[:1]), (f0, f1)]
    eng = FrameInterpolator(params, flow_params=flow_params, device=CARD0,
                            **FLAGSHIP_F32)
    plain = FrameInterpolator(params, flow_params=flow_params, device=CARD0,
                              use_kernels=False, **FLAGSHIP_F32)
    for a, b in requests:                  # warm-up: both shapes
        eng.midpoints(a, b)
    torch.cuda.synchronize()
    by_shape, failures = {}, []
    reset_launch_counts()
    g0 = dict(eng.graph_stats)
    outs = [eng.midpoints(a, b) for a, b in requests]
    torch.cuda.synchronize()
    counts = launch_counts()
    add_shapes(by_shape, shapes_now())
    failures += launch_failures("fp32", counts,
                                body_runs(graph_delta(eng, g0)),
                                PER_LAUNCH_CAT)
    failures += dtype_failures("fp32", by_shape, "f32")
    refs = [plain.midpoints(a, b) for a, b in requests]
    errs = [(o - r).abs().max().item() for o, r in zip(outs, refs)]
    psnrs = [psnr(o, r) for o, r in zip(outs, refs)]
    if not (max(errs) <= F32_ENGINE_ABS and min(psnrs) >= F32_PSNR_DB):
        failures.append(f"fp32 vs its plain engine: max abs {errs} (limit "
                        f"{F32_ENGINE_ABS}), PSNR {psnrs} (floor "
                        f"{F32_PSNR_DB})")
    if not all(torch.isfinite(o).all() and o.dtype == torch.float32
               for o in outs):
        failures.append("fp32: non-finite or non-float32 midpoints")
    bf16_out = [eng16.midpoints(a, b) for a, b in requests]
    times = {"bf16": {"b1": [], "b2": []}, "f32": {"b1": [], "b2": []}}
    engines = {"bf16": eng16, "f32": eng}
    for prec in F32_TURNS:
        if prec == "f32":
            reset_launch_counts()
            g0 = dict(eng.graph_stats)
        for (a, b), key in ([(requests[0], "b1")] * 3
                            + [(requests[1], "b2")]):
            t1 = time.perf_counter()
            engines[prec].midpoints(a, b)
            torch.cuda.synchronize()
            times[prec][key].append(time.perf_counter() - t1)
        if prec == "f32":
            add_shapes(by_shape, shapes_now())
            failures += launch_failures("fp32 turns", launch_counts(),
                                        body_runs(graph_delta(eng, g0)),
                                        PER_LAUNCH_CAT)
    fps = {p: {"b1": 1.0 / float(np.median(t["b1"])),
               "b2": 2.0 / float(np.median(t["b2"]))}
           for p, t in times.items()}
    with tempfile.TemporaryDirectory() as tmp:
        cli, shapes = infer_cli_request(
            infer_cli_argv(os.path.join(tmp, "mid.png"), "--fp32",
                           "--size", str(H), str(W)),
            "fp32 infer_cli", failures)
    add_shapes(by_shape, shapes)
    failures += dtype_failures("fp32 infer_cli", shapes, "f32")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "fp32", "seconds": time.perf_counter() - t0,
            "card": card_line(), "requests": [a.shape[0] for a, _ in requests],
            "launches": counts, "max_abs_err_vs_plain": errs,
            "abs_limit": F32_ENGINE_ABS, "psnr_vs_plain_db": psnrs,
            "psnr_floor_db": F32_PSNR_DB,
            "psnr_f32_vs_bf16_db": [psnr(o, r) for o, r in
                                    zip(outs, bf16_out)],
            "order": list(F32_TURNS), "request_seconds": times,
            "frames_per_s": fps,
            "f32_over_bf16_b1": fps["f32"]["b1"] / fps["bf16"]["b1"],
            "infer_cli": cli, "_by_shape": by_shape}


def phase_eval_fp32(frames: dict) -> dict:
    """The qocc record sweep (SWEEPS[0]) at the records' route in float32
    (EVAL_ENGINE with bf16=False) through the eval entry point, on the
    kernels and on the plain versions: the kernel route's mean PSNR within
    F32_EVAL_TOL_DB of the plain route's, 3 DCN and 1 warp launches a
    forward, all float32 instances; mean PSNR / SSIM, pairs/s of each
    route, and the gap to the record (bf16 on a TPU: no limit here)."""
    t0 = time.perf_counter()
    name, ckpt, kw, record_file = SWEEPS[0]
    record = json.load(open(os.path.join(ROOT, "artifacts", record_file)))
    p, fp = (load_params_npz(ckpt + ".npz"),
             load_params_npz(ckpt + ".flow.npz"))
    warm = val_batch(frames, "Army")
    res, failures = {}, []
    for route, kernels in (("kernel", True), ("plain", False)):
        eng = FrameInterpolator(p, flow_params=fp, device=CARD0,
                                use_kernels=kernels,
                                **dict(EVAL_ENGINE, bf16=False), **kw)
        eng.midpoints(warm[0], warm[2])    # warm-up (not counted)
        torch.cuda.synchronize()
        reset_launch_counts()
        g0 = dict(eng.graph_stats)
        t1 = time.perf_counter()
        report, batches = sweep(eng, VAL, 1, EB, load=frames.__getitem__)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        pairs = sum(bt["n"] for bt in batches)
        res[route] = {"mean_psnr": report["mean_psnr"],
                      "mean_ssim": report["mean_ssim"], "seconds": secs,
                      "pairs": pairs, "pairs_per_s": pairs / secs,
                      "launches": launch_counts(),
                      "scenes": {sc: r["psnr"] for sc, r in
                                 report["scenes"].items()}}
        if kernels:
            by_shape = shapes_now()
            forwards = body_runs(graph_delta(eng, g0))
            want = {"conv_chain": 0, "deform_conv2d_bounded": 3 * forwards,
                    "bounded_warp": forwards, "conv2d": 0,
                    "conv_chain_fused": 0}
            if launch_counts() != want:
                failures.append(f"eval_fp32: launches {launch_counts()}, "
                                f"expected {want}")
            failures += dtype_failures("eval_fp32", by_shape, "f32")
        del eng
    diff = res["kernel"]["mean_psnr"] - res["plain"]["mean_psnr"]
    if not abs(diff) <= F32_EVAL_TOL_DB:
        failures.append(f"eval_fp32: kernel route {diff:+.6f} dB from the "
                        f"plain route (limit {F32_EVAL_TOL_DB})")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "eval_fp32", "sweep": name,
            "seconds": time.perf_counter() - t0, **res,
            "kernel_vs_plain_db": diff, "tol_db": F32_EVAL_TOL_DB,
            "record_psnr": record["mean_psnr"],
            "record_ssim": record["mean_ssim"],
            "kernel_vs_record_db": res["kernel"]["mean_psnr"]
            - record["mean_psnr"], "_by_shape": by_shape}


def shapes_now() -> dict:
    """Launches by wrapper and shape since the last reset."""
    return {fn.__name__: Counter(fn.launches_by_shape) for fn in WRAPPERS}


def decode_val() -> dict:
    """Every PNG of the val set, decoded once by the port's decoder."""
    paths = sorted(glob.glob(os.path.join(VAL, "*", "*.png")))
    if not paths:
        raise AssertionError(f"no val frames under {VAL}")
    return {p: load_image(p) for p in paths}


def val_batch(frames: dict, scene: str) -> tuple:
    """The first EB triplets of one val scene: (f0, gt, f1) stacks."""
    paths = sorted(p for p in frames if os.path.basename(
        os.path.dirname(p)) == scene)
    trip = [paths[i:i + 3] for i in range(EB)]
    return tuple(np.stack([frames[t[k]] for t in trip]) for k in range(3))


def phase_q12(frames: dict, R: int = 2) -> dict:
    """q12, the 67-channel reference topology, with conv_kernel="pallas"
    on one b=4 val batch: the 67-wide offset and reconstruction chains and
    the 67-channel DCN at radius R run in the kernels. At R = Q12_R8 its
    three DCNs must run the stream design."""
    params = load_params_npz(Q12 + ".npz")
    flow = load_params_npz(Q12 + ".flow.npz")
    f0, gt, f1 = val_batch(frames, "Urban")
    kw = dict(Q12_ENGINE, dcn_max_offset=R)
    eng = FrameInterpolator(params, flow_params=flow, device=CARD0,
                            conv_kernel="pallas", **kw)
    eng.midpoints(f0, f1)                  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    g0 = dict(eng.graph_stats)
    t0 = time.perf_counter()
    out = eng.midpoints(f0, f1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, by_shape = launch_counts(), shapes_now()
    runs = body_runs(graph_delta(eng, g0))
    if launch_failures("q12", counts, runs, PER_LAUNCH_CAT):
        raise AssertionError(f"q12 R={R} launches {counts} over {runs} "
                             f"runs of the launch body, expected "
                             f"{PER_LAUNCH_CAT} each")
    dcn_key = (67, 67, EH, EW, R, "bf16")
    design = dcn_plan(67, 67, R, torch.cuda.get_device_properties(
        0).shared_memory_per_block_optin)["design"]
    if by_shape["deform_conv2d_bounded"][dcn_key] != 3 * runs or (
            R == Q12_R8 and design != "stream"):
        raise AssertionError(f"q12 R={R}: DCN launches "
                             f"{dict(by_shape['deform_conv2d_bounded'])} on "
                             f"the {design} design, expected {3 * runs} at "
                             f"{dcn_key}")
    if tuple(out.shape) != f0.shape or not torch.isfinite(out).all():
        raise AssertionError(f"q12 R={R}: bad output")
    plain = FrameInterpolator(params, flow_params=flow, device=CARD0,
                              conv_kernel="pallas", use_kernels=False,
                              **kw).midpoints(f0, f1)
    vs_plain = psnr(out, plain)
    if not vs_plain >= PSNR_FLOOR_DB:
        raise AssertionError(f"q12 R={R} PSNR vs plain engine {vs_plain} "
                             f"below {PSNR_FLOOR_DB} dB")
    return {"phase": "q12" if R == 2 else f"q12_r{R}", "batch": list(f0.shape),
            "dcn_max_offset": R, "dcn_design": design, "launches": counts,
            "request_seconds": secs, "psnr_vs_plain_db": vs_plain,
            "psnr_vs_gt_db": psnr(out, torch.from_numpy(gt).cuda()),
            "_by_shape": by_shape}


def phase_eval(frames: dict) -> dict:
    """The three record sweeps through the eval entry point. Runs all
    three, then fails if any missed its record or its launch counts."""
    warm = val_batch(frames, "Army")
    results, failures = [], []
    by_shape = {fn.__name__: Counter() for fn in WRAPPERS}
    for name, ckpt, kw, record_file in SWEEPS:
        record = json.load(open(os.path.join(ROOT, "artifacts",
                                             record_file)))
        eng = FrameInterpolator(load_params_npz(ckpt + ".npz"),
                                flow_params=load_params_npz(
                                    ckpt + ".flow.npz"),
                                device=CARD0, **EVAL_ENGINE, **kw)
        eng.midpoints(warm[0], warm[2])    # warm-up (not counted)
        torch.cuda.synchronize()
        reset_launch_counts()
        g0 = dict(eng.graph_stats)
        t0 = time.perf_counter()
        report, batches = sweep(eng, VAL, 1, EB, load=frames.__getitem__)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        for fn, c in shapes_now().items():
            by_shape[fn].update(c)
        graphs = graph_delta(eng, g0)
        forwards = len(batches) * (4 if kw.get("tta") else 1)
        runs = body_runs(graphs) * (4 if kw.get("tta") else 1)
        want = {"conv_chain": 0, "deform_conv2d_bounded": 3 * runs,
                "bounded_warp": runs, "conv2d": 0, "conv_chain_fused": 0}
        pairs = sum(bt["n"] for bt in batches)
        quality, missed = sweep_quality(name, report, record)
        scenes = {sc: {"psnr": r["psnr"], "ssim": r["ssim"],
                       "record_psnr": record["scenes"][sc]["psnr"],
                       **({"auto_scaled": r["auto_scaled"],
                           "record_auto_scaled":
                               record["scenes"][sc]["auto_scaled"]}
                          if "auto_scaled" in r else {})}
                  for sc, r in report["scenes"].items()}
        res = {"phase": "eval", "sweep": name, "seconds": secs,
               "pairs": pairs, "pairs_per_s": pairs / secs, **quality,
               "excluded_scenes": report["excluded_scenes"],
               "forwards": forwards, "launches": counts, "graphs": graphs,
               "scenes": scenes,
               "probes": [[bt["scene"], bt["probe"], bt["scaled"]]
                          for bt in batches if bt["probe"] is not None]}
        emit(res)
        results.append(res)
        if counts != want:
            failures.append(f"{name}: launches {counts}, expected {want}")
        failures += missed
    if failures:
        raise AssertionError("eval: " + "; ".join(failures))
    return {"phase": "eval_done", "sweeps": [r["sweep"] for r in results],
            "seconds": sum(r["seconds"] for r in results),
            "_by_shape": by_shape}


def sweep_quality(name: str, report: dict, record: dict) -> tuple:
    """(fields, failures) of one sweep's means against its record."""
    d_psnr = report["mean_psnr"] - record["mean_psnr"]
    d_ssim = report["mean_ssim"] - record["mean_ssim"]
    failures = []
    if not abs(d_psnr) <= PSNR_TOL_DB:
        failures.append(f"{name}: mean PSNR {report['mean_psnr']:.4f} is "
                        f"{d_psnr:+.4f} dB from its record")
    if not abs(d_ssim) <= SSIM_TOL:
        failures.append(f"{name}: mean SSIM {report['mean_ssim']:.5f} is "
                        f"{d_ssim:+.5f} from its record")
    return ({"mean_psnr": report["mean_psnr"],
             "record_psnr": record["mean_psnr"], "diff_psnr": d_psnr,
             "mean_ssim": report["mean_ssim"],
             "record_ssim": record["mean_ssim"], "diff_ssim": d_ssim},
            failures)


def phase_epe() -> dict:
    """The eval CLI's flow-EPE mode (`cli.eval.main`, bf16 on the card) on
    the qocc checkpoint's estimator over the Middlebury GT scenes, its mean
    within EPE_TOL_PX of artifacts/qocc_epe.json. No kernel runs (the
    estimator is plain convs and the plain warp)."""
    t0 = time.perf_counter()
    record = json.load(open(os.path.join(ROOT, "artifacts",
                                         "qocc_epe.json")))
    reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = eval_cli.main(["--data-dir", TRAIN_DATA, "--flow_model",
                            CKPT + ".flow.npz", "--gt_flow_dir", GT_FLOW,
                            "--json"])
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    diff = report["mean_epe"] - record["mean_epe"]
    res = {"phase": "eval_epe", "seconds": time.perf_counter() - t0,
           "mean_epe": report["mean_epe"], "record_epe": record["mean_epe"],
           "diff_px": diff, "tol_px": EPE_TOL_PX,
           "scenes": {k: [v, record["scenes"].get(k)]
                      for k, v in report["scenes"].items()},
           "launches": launch_counts()}
    if rc != 0 or sorted(report["scenes"]) != sorted(record["scenes"]) \
            or not abs(diff) <= EPE_TOL_PX:
        raise AssertionError(f"eval_epe: rc {rc}, mean EPE "
                             f"{report['mean_epe']:.4f} px is {diff:+.4f} px "
                             f"from its record (tol {EPE_TOL_PX})")
    res["flo_round_trip"] = flo_round_trip(sorted(report["scenes"])[0],
                                           report["scenes"])
    return res


def flo_round_trip(scene: str, cli_epe: dict) -> dict:
    """The qocc estimator's flow on `scene` (bf16 on card 0, resized to
    the GT flow's size, as the eval CLI scores it) through `write_flo` and
    `read_flo`: the file holds 12 header bytes and 8 a pixel, its flow
    reads back bit for bit, and its EPE against the scene's GT is the
    CLI's within EPE_TOL_PX."""
    net = SimpleFlowNet(dtype=torch.bfloat16)
    net.load_state_dict(params_from_jax(load_params_npz(CKPT + ".flow.npz")))
    net.to(CARD0).eval()
    mean = torch.tensor(IMAGENET_MEAN, device=CARD0)
    std = torch.tensor(IMAGENET_STD, device=CARD0)
    f0, f1 = (torch.from_numpy(load_image(os.path.join(
        TRAIN_DATA, scene, f"frame{i}.png"))[None]).to(CARD0)
        for i in (10, 11))
    gt = read_flo(os.path.join(GT_FLOW, scene, "flow10.flo"))
    (gh, gw), (h, w) = gt.shape[:2], f0.shape[1:3]
    with torch.inference_mode():
        flow = net((f0 - mean) / std, (f1 - mean) / std).float()
        flow = resize_bilinear(flow, (gh, gw)) * torch.tensor(
            [gw / w, gh / h], device=flow.device)
    flow = flow[0].cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flow10.flo")
        write_flo(path, flow)
        size = os.path.getsize(path)
        back = read_flo(path)
    epe = endpoint_error(back, gt)
    out = {"scene": scene, "shape": list(flow.shape), "bytes": size,
           "bit_equal": bool(np.array_equal(back, flow)), "epe": epe,
           "cli_epe": cli_epe[scene]}
    if size != 12 + flow.size * 4 or not out["bit_equal"] \
            or not abs(epe - cli_epe[scene]) <= EPE_TOL_PX:
        raise AssertionError(f"eval_epe: the .flo round trip failed: {out}")
    return out


def flat_grads(params) -> torch.Tensor:
    return torch.cat([p.grad.float().flatten() for p in params.parameters()])


def train_fidelity(trainer, rtol: float = TRAIN_LOSS_RTOL,
                   cos_min: float = TRAIN_GRAD_COS, phase: str =
                   "train_fidelity", first: int = 0,
                   hold: bool = True) -> dict:
    """One microbatch (2 samples of the train set from item `first` on)
    through the trainer's step on the kernel route and on the plain route,
    from the trainer's initial params: the loss within `rtol`, the
    flattened gradient's cosine similarity at least `cos_min`, every
    gradient float32 and finite, the DCN and warp launched in the instances
    of the trainer's activation dtype (`hold=False`: the limits reported,
    not held). `color_quanta`: the colour term's difference in units of one
    pixel value crossing a bin edge (2 / (H W B) of the exact 256-bin
    histogram term); `other_rel`: the weighted difference of every other
    term over the plain loss. `_by_shape`: the kernel route's launches."""
    cfg = trainer.cfg
    n = cfg.batch_size // cfg.accum_steps
    items = [trainer.train_data.get(i, np.random.default_rng(i))
             for i in range(first, first + n)]
    batch = [torch.from_numpy(np.stack([it[k] for it in items])).cuda()
             for k in range(3)]
    out = {}
    for route in ("kernel", "plain"):
        params = copy.deepcopy(trainer.state.params)
        if route == "plain":
            params["model"].ops = PLAIN
        st = TrainState(params, torch.optim.SGD(params.parameters(), lr=0.0),
                        grad_clip_norm=float("inf"))
        step = make_train_step(
            trainer.vgg_module, trainer.vgg_layer_index, trainer.weights,
            remat=cfg.remat, joint_flow=True,
            target_unit_range=cfg.target_unit_range, flow_prior=True,
            flow_photo_pyramid=cfg.flow_photo_pyramid,
            flow_photo_occlusion=cfg.flow_photo_occlusion)
        reset_launch_counts()
        met = step(st, *batch)
        torch.cuda.synchronize()
        launches = launch_counts()
        if route == "kernel":
            by_shape = shapes_now()
        grads = flat_grads(params)
        if not all(p.grad.dtype == torch.float32
                   for p in params.parameters()) \
                or not torch.isfinite(grads).all():
            raise AssertionError(f"train fidelity {route}: gradients not all "
                                 f"finite float32")
        out[route] = (float(met["loss"]), grads, launches,
                      {k: float(v) for k, v in met.items()})
    (lk, gk, nk, mk), (lp, gp, _, mp) = out["kernel"], out["plain"]
    cos = float(torch.nn.functional.cosine_similarity(gk, gp, dim=0))
    rel = abs(lk - lp) / abs(lp)
    bsz, h, w = batch[0].shape[:3]
    dcolor = mk["color"] - mp["color"]
    quanta = dcolor / (2.0 / (h * w * bsz))
    other = abs((lk - lp) - trainer.weights.color * dcolor) / abs(lp)
    if hold and not (rel <= rtol and cos >= cos_min):
        raise AssertionError(f"{phase}: loss {lk} vs plain {lp} "
                             f"({rel:.2e} relative, limit {rtol}),"
                             f" gradient cosine {cos} (limit {cos_min})")
    tag = "bf16" if cfg.bf16 else "f32"
    if nk["deform_conv2d_bounded"] != 2 * trainer.model.num_blocks \
            or nk["bounded_warp"] != 2 or dtype_failures(phase, by_shape,
                                                        tag):
        raise AssertionError(f"{phase}: kernel route launches {nk}, "
                             f"{ {k: dict(c) for k, c in by_shape.items()} }")
    return {"phase": phase, "microbatch": list(batch[0].shape),
            "first_item": first, "held": hold,
            "loss_kernel": lk, "loss_plain": lp, "loss_rel_diff": rel,
            "loss_rtol": rtol, "grad_cosine": cos, "grad_cos_min": cos_min,
            "color_quanta": quanta, "other_rel": other,
            "grad_norm_kernel": float(gk.norm()),
            "grad_norm_plain": float(gp.norm()), "terms_kernel": mk,
            "terms_plain": mp, "kernel_launches": nk, "_by_shape": by_shape}


def train_turns(trainer, batch) -> dict:
    """One optimizer step on one batch of 16 for each route in turns
    (TRAIN_TURNS), each from a copy of the trainer's params with its own
    optimizer: ms per step (synchronised), the median per route."""
    cfg = trainer.cfg
    routes = {}
    for route in ("plain", "kernel"):
        params = copy.deepcopy(trainer.state.params)
        if route == "plain":
            params["model"].ops = PLAIN
        routes[route] = (create_train_state(params, cfg.learning_rate),
                         make_train_step(
                             trainer.vgg_module, trainer.vgg_layer_index,
                             trainer.weights, remat=cfg.remat,
                             joint_flow=True,
                             target_unit_range=cfg.target_unit_range,
                             flow_prior=True, accum_steps=cfg.accum_steps,
                             flow_photo_pyramid=cfg.flow_photo_pyramid,
                             flow_photo_occlusion=cfg.flow_photo_occlusion))
    for route in routes:                   # warm-up (allocator, cuDNN)
        st, step = routes[route]
        step(st, *batch)
    times = {"plain": [], "kernel": []}
    for route in TRAIN_TURNS:
        st, step = routes[route]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(st, *batch)["loss"])
        torch.cuda.synchronize()
        times[route].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    res = {"phase": "train_turns", "order": list(TRAIN_TURNS),
           "batch": list(batch[0].shape), "step_ms": times,
           "median_step_ms": med, "faster": min(med, key=med.get),
           "kernel_over_plain": med["kernel"] / med["plain"]}
    if "--profile" in sys.argv[1:]:     # one more kernel-route step
        st, step = routes["kernel"]
        res["profile_kernel_step"] = device_profile(
            lambda: float(step(st, *batch)["loss"]), CARD0)
    return res


def phase_train() -> dict:
    """The qocc fine-tune recipe (TRAIN_RECIPE) through the port's Trainer
    on the card for one epoch, into a temporary directory. Launches are
    counted per sub-path (TRAIN_PATHS) by taps on the trainer's step, val
    step and sample forward. Then: the fidelity of the kernel route, the
    export served at the flagship settings (720p), the routes' turns."""
    t0 = time.perf_counter()
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(
            **TRAIN_RECIPE, train_data_dir=TRAIN_DATA, val_data_dir=VAL,
            init_model_path=CKPT + ".npz",
            init_flow_path=CKPT + ".flow.npz",
            checkpoint_path=os.path.join(tmp, "ckpt"),
            best_model_path=os.path.join(tmp, "best"),
            output_image_path=os.path.join(tmp, "imgs"))
        trainer = Trainer(cfg, device="cuda")
        init = {k: v.clone() for k, v in
                trainer.state.params.state_dict().items()}
        results.append(train_fidelity(trainer))
        results[-1].pop("_by_shape")

        by_path = {p: {fn.__name__: Counter() for fn in WRAPPERS}
                   for p in TRAIN_PATHS.values()}
        last = {}

        def tap(fn, path):
            def counted(*a, **k):
                before = shapes_now()
                out = fn(*a, **k)
                for name, c in shapes_now().items():
                    by_path[path][name].update(c - before[name])
                if path == "train":
                    last.update(out)
                return out
            return counted

        micro = cfg.batch_size // cfg.accum_steps
        trainer.train_step = tap(trainer.train_step, TRAIN_PATHS[micro])
        trainer.eval_step = tap(trainer.eval_step,
                                TRAIN_PATHS[cfg.batch_size])
        trainer._sample_fwd = tap(trainer._sample_fwd, TRAIN_PATHS[1])
        logs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t1 = time.perf_counter()
        history = trainer.run(log=logs.append)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        st = trainer.epoch_stats[0]

        failures = []
        steps = st["train_samples"] // cfg.batch_size
        for path, per in ((TRAIN_PATHS[micro], 2 * cfg.accum_steps * steps),
                          (TRAIN_PATHS[cfg.batch_size],
                           len(trainer.val_loader)),
                          (TRAIN_PATHS[1], 1)):
            want = {"deform_conv2d_bounded": trainer.model.num_blocks * per,
                    "bounded_warp": per, "conv_chain": 0, "conv2d": 0,
                    "conv_chain_fused": 0}
            got = {k: sum(c.values()) for k, c in by_path[path].items()}
            if got != want:
                failures.append(f"{path}: launches {got}, expected {want}")
        moved = max((trainer.state.params.state_dict()[k] - v).abs().max()
                    .item() for k, v in init.items())
        terms = {k: float(v) for k, v in last.items()}
        if not moved > 0 or not all(math.isfinite(v) for v in
                                    terms.values()):
            failures.append(f"the epoch moved the params by {moved}; "
                            f"terms {terms}")
        wall = st["train_seconds"]
        results.insert(0, {
            "phase": "train", "seconds": run_s, "card": card_line(),
            "recipe": {k: list(v) if isinstance(v, tuple) else v
                       for k, v in TRAIN_RECIPE.items()},
            "train_samples": st["train_samples"],
            "train_seconds": wall,
            "samples_per_s": st["train_samples"] / wall,
            "optimizer_steps": steps,
            "median_step_ms": float(np.median(st["step_ms"])),
            "step_ms": st["step_ms"],
            "host_wait_seconds": st["host_wait_seconds"],
            "host_wait_share": st["host_wait_seconds"] / wall,
            "val_seconds": st["val_seconds"],
            "val_samples": st["val_samples"],
            "val_psnr": history["psnr"][0], "val_ssim": history["ssim"][0],
            "val_loss": history["val_loss"][0],
            "train_loss": history["train_loss"][0],
            "export_seconds": st["export_seconds"],
            "checkpoint_seconds": st["checkpoint_seconds"],
            "peak_memory_gb": peak_gb, "params_moved_max_abs": moved,
            "last_step_terms": terms,
            "launches": {p: {k: sum(c.values()) for k, c in v.items()}
                         for p, v in by_path.items()},
            "log": logs})

        # The export serves: the best .npz pair at the flagship settings.
        eng = FrameInterpolator(load_params_npz(cfg.best_model_path + ".npz"),
                                flow_params=load_params_npz(
                                    cfg.best_model_path + ".flow.npz"),
                                device=CARD0, **FLAGSHIP)
        f0, f1 = smooth_frames(np.random.default_rng(SEED + 3), 1)
        eng.midpoints(f0, f1)              # warm-up (not counted)
        torch.cuda.synchronize()
        reset_launch_counts()
        g0 = dict(eng.graph_stats)
        out = eng.midpoints(f0, f1)
        torch.cuda.synchronize()
        by_path["train_export"] = shapes_now()
        counts = launch_counts()
        failures += launch_failures("train_export", counts,
                                    body_runs(graph_delta(eng, g0)))
        if tuple(out.shape) != f0.shape or not torch.isfinite(out).all() \
                or out.min().item() < 0.0 or out.max().item() > 1.0:
            failures.append("train_export: bad midpoint")
        results.append({"phase": "train_export", "shape": list(f0.shape),
                        "launches": counts,
                        "psnr_vs_frame0_db": psnr(
                            out, torch.from_numpy(f0).cuda())})
        del eng

        rng = np.random.default_rng(SEED + 4)
        items = [trainer.train_data.get(i, rng)
                 for i in range(cfg.batch_size)]
        batch = [torch.from_numpy(np.stack([it[k] for it in items])).cuda()
                 for k in range(3)]
        results.append(train_turns(trainer, batch))
        if failures:
            raise AssertionError("train: " + "; ".join(failures))
    results[0]["phase_seconds"] = time.perf_counter() - t0
    results[0]["_by_shape"] = by_path
    return results


def recipe_step(trainer):
    """A fresh optimizer step of the trainer's recipe (as `train_turns`
    builds it) on a copy of its params: (state, step)."""
    cfg = trainer.cfg
    params = copy.deepcopy(trainer.state.params)
    return (create_train_state(params, cfg.learning_rate),
            make_train_step(trainer.vgg_module, trainer.vgg_layer_index,
                            trainer.weights, remat=cfg.remat, joint_flow=True,
                            target_unit_range=cfg.target_unit_range,
                            flow_prior=True, accum_steps=cfg.accum_steps,
                            flow_photo_pyramid=cfg.flow_photo_pyramid,
                            flow_photo_occlusion=cfg.flow_photo_occlusion))


def phase_train_fp32() -> list:
    """The qocc recipe (TRAIN_RECIPE) with `bf16: false` on card 0, as the
    train phase builds it: `train_fidelity` on one microbatch with the
    float32 limits (F32_TRAIN_LOSS_RTOL, F32_TRAIN_GRAD_COS; the DCN and
    warp in their float32 instances), the same reported on the microbatches
    from F32_TRAIN_SPREAD_FROM (`train_fp32_spread`), then one optimizer
    step of 16 a
    turn against the bf16 recipe's step on one batch (F32_TURNS): median
    step ms of each and the float32 steps' peak memory. The launches of
    the fidelity's kernel route and of the float32 steps count on the
    path `train_fp32`."""
    t0 = time.perf_counter()
    results, by_shape, failures = [], {}, []
    with tempfile.TemporaryDirectory() as tmp:
        trainers = {}
        for prec in ("f32", "bf16"):
            cfg = TrainConfig(
                **dict(TRAIN_RECIPE, bf16=prec == "bf16"),
                train_data_dir=TRAIN_DATA, val_data_dir=VAL,
                init_model_path=CKPT + ".npz",
                init_flow_path=CKPT + ".flow.npz",
                checkpoint_path=os.path.join(tmp, prec, "ckpt"),
                best_model_path=os.path.join(tmp, prec, "best"),
                output_image_path=os.path.join(tmp, prec, "imgs"))
            trainers[prec] = Trainer(cfg, device=CARD0)
        fid = train_fidelity(trainers["f32"], F32_TRAIN_LOSS_RTOL,
                             F32_TRAIN_GRAD_COS, "train_fp32_fidelity")
        add_shapes(by_shape, fid.pop("_by_shape"))
        results.append(fid)
        spread = [fid]
        for first in F32_TRAIN_SPREAD_FROM:
            f = train_fidelity(trainers["f32"], F32_TRAIN_LOSS_RTOL,
                               F32_TRAIN_GRAD_COS, "train_fp32_spread",
                               first, hold=False)
            add_shapes(by_shape, f.pop("_by_shape"))
            spread.append(f)
        results.append({
            "phase": "train_fp32_spread", "held": False,
            "first_items": [f["first_item"] for f in spread],
            "loss_rel_diff": [f["loss_rel_diff"] for f in spread],
            "grad_cosine": [f["grad_cosine"] for f in spread],
            "color_quanta": [f["color_quanta"] for f in spread],
            "other_rel": [f["other_rel"] for f in spread]})

        cfg = trainers["f32"].cfg
        rng = np.random.default_rng(SEED + 4)
        items = [trainers["f32"].train_data.get(i, rng)
                 for i in range(cfg.batch_size)]
        batch = [torch.from_numpy(np.stack([it[k] for it in items])).cuda()
                 for k in range(3)]
        steps = {prec: recipe_step(t) for prec, t in trainers.items()}
        for st, step in steps.values():    # warm-up (allocator, cuDNN)
            step(st, *batch)
        times, peak = {"bf16": [], "f32": []}, 0.0
        for prec in F32_TURNS:
            st, step = steps[prec]
            torch.cuda.synchronize()
            if prec == "f32":
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
            t1 = time.perf_counter()
            loss = float(step(st, *batch)["loss"])
            torch.cuda.synchronize()
            times[prec].append((time.perf_counter() - t1) * 1e3)
            if prec == "f32":
                peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
                shapes = shapes_now()
                add_shapes(by_shape, shapes)
                failures += dtype_failures("train_fp32 step", shapes, "f32")
                want = 2 * cfg.accum_steps * trainers["f32"].model.num_blocks
                if launch_counts()["deform_conv2d_bounded"] != want:
                    failures.append(f"train_fp32 step: launches "
                                    f"{launch_counts()}")
            if not math.isfinite(loss):
                failures.append(f"train_fp32 {prec}: loss {loss}")
        med = {k: float(np.median(v)) for k, v in times.items()}
        results.insert(0, {
            "phase": "train_fp32", "card": card_line(),
            "batch": list(batch[0].shape), "order": list(F32_TURNS),
            "step_ms": times, "median_step_ms": med,
            "f32_over_bf16": med["f32"] / med["bf16"],
            "peak_memory_gb_f32_step": peak})
    if failures:
        raise AssertionError("train_fp32: " + "; ".join(failures))
    results[0]["seconds"] = time.perf_counter() - t0
    results[0]["_by_shape"] = by_shape
    return results


def rank_layout(world: int) -> tuple:
    """(backend, card of each rank): NCCL with a card a rank where there
    are that many cards, else gloo with every rank on card 0."""
    if torch.cuda.device_count() >= world:
        return "nccl", list(range(world))
    return "gloo", [0] * world


def _rank_entry(rank, world, port, backend, cards, fn_name, args, out):
    import datetime

    import torch.distributed as dist

    dev = torch.device("cuda", cards[rank])
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        build.load()            # built by phase_build: loads, never builds
        res = globals()[fn_name](rank, dev, *args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn_name: str, world: int, *args) -> tuple:
    """`fn_name(rank, device, *args)` in `world` spawned ranks of one
    process group (`rank_layout`), each returning what it saved; fails
    when a rank fails or the ranks outlast RANK_TIMEOUT_S (then every
    rank is stopped)."""
    import torch.multiprocessing as mp

    backend, cards = rank_layout(world)
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(
            _rank_entry, args=(world, free_port(), backend, cards, fn_name,
                               args, out), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"{fn_name}: ranks still running "
                                         f"after {RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        res = [torch.load(os.path.join(out, f"rank{r}.pt"),
                          weights_only=False) for r in range(world)]
    return backend, cards, res


def merge_shapes(results: list) -> dict:
    """The ranks' launches by wrapper and shape, summed."""
    out = {fn.__name__: Counter() for fn in WRAPPERS}
    for r in results:
        for name, c in r["by_shape"].items():
            out[name].update(c)
    return out


def phase_dp_engine(params, flow_params) -> dict:
    """The flagship engine over a 'data' mesh of DP_RANKS replicas (two
    cards, or card 0 twice): an odd batch of 720p pairs, padded and split,
    held to the one-device engine; 8 / 3 / 1 launches a replica launch."""
    t0 = time.perf_counter()
    _, cards = rank_layout(DP_RANKS)
    mesh = make_mesh(DP_RANKS, devices=[torch.device("cuda", c)
                                        for c in cards])
    f0, f1 = smooth_frames(np.random.default_rng(SEED + 5), DP_ENGINE_BATCH)
    eng = FrameInterpolator(params, flow_params=flow_params, mesh=mesh,
                            **FLAGSHIP)
    one = FrameInterpolator(params, flow_params=flow_params, device=CARD0,
                            **FLAGSHIP)
    eng.midpoints(f0, f1)                  # warm-up
    one.midpoints(f0, f1)
    torch.cuda.synchronize()
    reset_launch_counts()
    t1 = time.perf_counter()
    out = eng.midpoints(f0, f1)
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t1
    counts, by_shape = launch_counts(), shapes_now()
    t1 = time.perf_counter()
    ref = one.midpoints(f0, f1)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    # The padded batch fits the pixel guard: one engine launch, one
    # launch of each replica.
    if eng._guard_cap(f0) < DP_ENGINE_BATCH + 1:
        raise AssertionError("dp_engine: the batch splits in the guard")
    replica_launches = DP_RANKS
    failures = launch_failures("dp_engine", counts, replica_launches)
    if tuple(out.shape) != f0.shape or out.device != ref.device \
            or not torch.isfinite(out).all():
        failures.append(f"dp_engine: output {tuple(out.shape)} on "
                        f"{out.device}")
    psnrs = [psnr(out[i], ref[i]) for i in range(DP_ENGINE_BATCH)]
    if not min(psnrs) >= PSNR_FLOOR_DB:
        failures.append(f"dp_engine: PSNR vs the one-device engine {psnrs} "
                        f"below {PSNR_FLOOR_DB} dB")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "dp_engine", "seconds": time.perf_counter() - t0,
            "card": card_line(), "mesh": dict(mesh.shape),
            "devices": [str(d) for d in mesh.data_devices],
            "layout": "two cards" if len(set(cards)) > 1
            else "one card, two replicas",
            "batch": DP_ENGINE_BATCH, "size": [H, W],
            "replica_launches": replica_launches, "launches": counts,
            "dp_seconds": dp_s, "one_device_seconds": one_s,
            "psnr_vs_one_device_db": psnrs, "psnr_floor_db": PSNR_FLOOR_DB,
            "_by_shape": by_shape}


def spatial_rank(rank, dev, layout):
    """One rank of the spatial phase: the counted spatial midpoint, the
    turns, and on rank 0 the checks against the one-process engine."""
    import torch.distributed as dist

    params = load_params_npz(CKPT + ".npz")
    f0, f1 = smooth_frames(np.random.default_rng(SEED + 6), 1, SP_H, SP_W)
    eng = FrameInterpolator(params, device=dev, spatial=True, **FLAGSHIP)
    one = (FrameInterpolator(params, device=dev, **FLAGSHIP) if rank == 0
           else None)
    eng.midpoints(f0, f1)                  # warm-up
    if one is not None:
        one.midpoints(f0, f1)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launch_counts()
    out = eng.midpoints(f0, f1)
    torch.cuda.synchronize()
    res = {"counts": launch_counts(), "by_shape": shapes_now()}
    times = {"spatial": [], "one": []}
    for turn in SPATIAL_TURNS:
        dist.barrier()
        t0 = time.perf_counter()
        if turn == "spatial":
            eng.midpoints(f0, f1)
        elif one is not None:
            one.midpoints(f0, f1)
        torch.cuda.synchronize()
        times[turn].append(time.perf_counter() - t0)
    dist.barrier()
    res["turn_seconds"] = times
    if one is None:
        return res
    fn = eng._spatial_fwd_cache[SP_H + (-SP_H) % (8 * DP_RANKS)]
    pad = fn.h_local * DP_RANKS - SP_H
    padded = [np.concatenate([f, np.repeat(f[:, -1:], pad, axis=1)], axis=1)
              for f in (f0, f1)]
    ref_pad = one.midpoints(*padded)[:, :SP_H]
    ref = one.midpoints(f0, f1)
    keep = SP_H - fn.halo
    res.update({
        "shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
        "halo": fn.halo, "h_local": fn.h_local, "padded_h": SP_H + pad,
        "slab": fn.h_local + 2 * fn.halo,
        "padded_max_abs_err": (out.float() - ref_pad.float()).abs().max()
        .item(),
        "padded_psnr_db": psnr(out, ref_pad),
        "native_psnr_db": psnr(out, ref),
        "native_rows_checked": keep,
        "native_max_abs_err": (out[:, :keep].float() - ref[:, :keep].float())
        .abs().max().item()})
    return res


def phase_spatial() -> dict:
    """The exact halo pipeline over DP_RANKS ranks on one 1080p pair: the
    engine's spatial route, counted per rank, held to the one-process
    engine; seconds a midpoint of both, in turns."""
    t0 = time.perf_counter()
    backend, cards, res = run_ranks("spatial_rank", DP_RANKS, None)
    r0 = res[0]
    failures = []
    for r, rr in enumerate(res):
        if rr["counts"] != SPATIAL_PER_RANK:
            failures.append(f"spatial rank {r}: launches {rr['counts']}, "
                            f"expected {SPATIAL_PER_RANK}")
    if r0["shape"] != [1, SP_H, SP_W, 3] or not r0["finite"]:
        failures.append(f"spatial: output {r0['shape']}, finite "
                        f"{r0['finite']}")
    if not r0["padded_max_abs_err"] <= SPATIAL_PADDED_TOL:
        failures.append(f"spatial: max abs err {r0['padded_max_abs_err']} "
                        f"vs the padded one-process engine > "
                        f"{SPATIAL_PADDED_TOL}")
    if not (r0["native_psnr_db"] >= PSNR_FLOOR_DB
            and r0["native_max_abs_err"] <= SPATIAL_NATIVE_TOL):
        failures.append(f"spatial: vs the one-process engine PSNR "
                        f"{r0['native_psnr_db']} dB (floor {PSNR_FLOOR_DB}),"
                        f" max abs err {r0['native_max_abs_err']} on rows "
                        f"< {r0['native_rows_checked']} (tol "
                        f"{SPATIAL_NATIVE_TOL})")
    if failures:
        raise AssertionError("; ".join(failures))
    times = r0.pop("turn_seconds")
    by_shape = merge_shapes(res)
    r0.pop("by_shape")
    return {"phase": "spatial", "seconds": time.perf_counter() - t0,
            "card": card_line(), "backend": backend,
            "rank_cards": cards,
            "layout": "two cards" if len(set(cards)) > 1
            else "one card shared by both ranks", "size": [SP_H, SP_W],
            **{k: v for k, v in r0.items() if k != "counts"},
            "launches_per_rank": [rr["counts"] for rr in res],
            "padded_tol": SPATIAL_PADDED_TOL,
            "native_tol": SPATIAL_NATIVE_TOL,
            "psnr_floor_db": PSNR_FLOOR_DB, "turns": list(SPATIAL_TURNS),
            "turn_seconds": times,
            "spatial_s_per_midpoint": float(np.median(times["spatial"])),
            "one_process_s_per_midpoint": float(np.median(times["one"])),
            "_by_shape": by_shape}


def dp_train_config(tmp: str, data: int = 1) -> TrainConfig:
    return TrainConfig(
        **TRAIN_RECIPE, train_data_dir=TRAIN_DATA, val_data_dir=VAL,
        init_model_path=CKPT + ".npz", init_flow_path=CKPT + ".flow.npz",
        checkpoint_path=os.path.join(tmp, "ckpt"),
        best_model_path=os.path.join(tmp, "best"),
        output_image_path=os.path.join(tmp, "imgs"),
        mesh=MeshConfig(data=data))


def dp_train_batch(trainer) -> list:
    """train_fidelity's pairs and the next ones: a batch of batch_size."""
    items = [trainer.train_data.get(i, np.random.default_rng(i))
             for i in range(trainer.cfg.batch_size)]
    return [np.stack([it[k] for it in items]) for k in range(3)]


def dp_train_rank(rank, dev, _):
    """One rank of the dp_train phase: the trainer over the group, this
    rank's rows of the batch, one optimizer step, counted."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(dp_train_config(tmp, DP_RANKS), device=dev,
                          data_group=dist.group.WORLD)
        cfg = trainer.cfg
        rows = data_rows(cfg.batch_size, cfg.accum_steps, rank, DP_RANKS)
        batch = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
                 for a in dp_train_batch(trainer)]
        torch.cuda.synchronize()
        dist.barrier()
        reset_launch_counts()
        t0 = time.perf_counter()
        met = trainer.train_step(trainer.state, *batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        res = {"counts": launch_counts(), "by_shape": shapes_now(),
               "step_seconds": step_s, "loss": loss,
               "local_batch": list(batch[0].shape)}
        if rank == 0:
            params = trainer.state.params
            res["grads"] = flat_grads(params).cpu()
            res["params"] = torch.cat([p.detach().float().flatten()
                                       for p in params.parameters()]).cpu()
            res["terms"] = {k: float(v) for k, v in met.items()}
    return res


def phase_dp_train() -> dict:
    """One optimizer step of TRAIN_RECIPE over DP_RANKS ranks against the
    one-process step from the same params on the same batch."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(dp_train_config(tmp), device="cuda")
        init = torch.cat([p.detach().float().flatten()
                          for p in trainer.state.params.parameters()])
        batch = [torch.from_numpy(a).cuda()
                 for a in dp_train_batch(trainer)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        met = trainer.train_step(trainer.state, *batch)
        loss1 = float(met["loss"])
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t1
        g1 = flat_grads(trainer.state.params)
        p1 = torch.cat([p.detach().float().flatten()
                        for p in trainer.state.params.parameters()])
        lr = trainer.cfg.learning_rate
        del trainer, batch
    backend, cards, res = run_ranks("dp_train_rank", DP_RANKS, None)
    r0 = res[0]
    g2, p2 = r0["grads"].cuda(), r0["params"].cuda()
    rel = abs(r0["loss"] - loss1) / abs(loss1)
    cos = float(torch.nn.functional.cosine_similarity(g1, g2, dim=0))
    dp = (p2 - p1).abs()
    step = (p1 - init.cuda()).norm().item()
    per_rank = {"deform_conv2d_bounded": 3 * 2 * TRAIN_RECIPE["accum_steps"],
                "bounded_warp": 2 * TRAIN_RECIPE["accum_steps"],
                "conv_chain": 0, "conv2d": 0, "conv_chain_fused": 0}
    failures = [f"dp_train rank {r}: launches {rr['counts']}, expected "
                f"{per_rank}" for r, rr in enumerate(res)
                if rr["counts"] != per_rank]
    if not (rel <= TRAIN_LOSS_RTOL and cos >= TRAIN_GRAD_COS):
        failures.append(f"dp_train: loss {r0['loss']} vs one process "
                        f"{loss1} ({rel:.2e} relative, limit "
                        f"{TRAIN_LOSS_RTOL}), gradient cosine {cos} (limit "
                        f"{TRAIN_GRAD_COS})")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"phase": "dp_train", "seconds": time.perf_counter() - t0,
            "card": card_line(), "backend": backend, "rank_cards": cards,
            "layout": "two cards" if len(set(cards)) > 1
            else "one card shared by both ranks",
            "batch": TRAIN_RECIPE["batch_size"],
            "microbatches": TRAIN_RECIPE["accum_steps"],
            "local_batch": r0["local_batch"],
            "loss_dp": r0["loss"], "loss_one_process": loss1,
            "loss_rel_diff": rel, "loss_rtol": TRAIN_LOSS_RTOL,
            "grad_cosine": cos, "grad_cos_min": TRAIN_GRAD_COS,
            "params_max_abs_diff": dp.max().item(),
            "params_max_abs_diff_over_lr": dp.max().item() / lr,
            "params_diff_over_step": (p2 - p1).norm().item() / step,
            "params_max_rel_diff": (dp / p1.abs().clamp_min(1e-12)).max()
            .item(),
            "step_seconds_dp": [rr["step_seconds"] for rr in res],
            "step_seconds_one_process": one_s,
            "launches_per_rank": [rr["counts"] for rr in res],
            "terms_dp": r0["terms"], "_by_shape": merge_shapes(res)}


def phase_conv_compare(frames: dict, params, flow_params) -> list:
    """conv_kernel="xla" (the trunk on cuDNN convs) against "pallas" (the
    conv-chain kernels) on both workloads, inside one call: the flagship's
    b=1 720p requests, and the three eval sweeps. The two engines take
    turns, xla / pallas / pallas / xla; each reports its median seconds.
    Launches per forward are checked (0 or 8 chains, 3 DCN, 1 warp), the
    flagship's two outputs are held to each other (PSNR floor), and each
    sweep under "pallas" is held to its record as the eval phase holds
    "xla"."""
    order = ("xla", "pallas", "pallas", "xla")
    chains = {"xla": 0, "pallas": PER_LAUNCH["conv_chain"]}
    results, failures = [], []

    def want(ck, runs, eng):   # `runs` of the launch body (`body_runs`)
        fuse = ck == "pallas" and eng.model.fuse_project
        return {"conv_chain": chains[ck] * runs,
                "deform_conv2d_bounded": 3 * runs,
                "bounded_warp": runs, "conv2d": runs if fuse else 0,
                "conv_chain_fused": 0}

    t0 = time.perf_counter()
    f0, f1 = smooth_frames(np.random.default_rng(SEED), 1)
    kw = {k: v for k, v in FLAGSHIP.items() if k != "conv_kernel"}
    engs = {ck: FrameInterpolator(params, flow_params=flow_params,
                                  device=CARD0, conv_kernel=ck, **kw)
            for ck in chains}
    outs = {ck: e.midpoints(f0, f1) for ck, e in engs.items()}  # warm-up
    times = {ck: [] for ck in chains}
    for ck in order:
        reset_launch_counts()
        g0 = dict(engs[ck].graph_stats)
        for _ in range(5):
            t1 = time.perf_counter()
            engs[ck].midpoints(f0, f1)
            torch.cuda.synchronize()
            times[ck].append(time.perf_counter() - t1)
        runs = body_runs(graph_delta(engs[ck], g0))
        if launch_counts() != want(ck, runs, engs[ck]):
            failures.append(f"flagship {ck}: launches {launch_counts()} "
                            f"over {runs} runs of the launch body")
    agree = psnr(outs["xla"], outs["pallas"])
    if not agree >= PSNR_FLOOR_DB:
        failures.append(f"flagship: xla vs pallas {agree} dB")
    med = {ck: float(np.median(t)) for ck, t in times.items()}
    results.append({"phase": "conv_compare", "workload": "flagship_720p_b1",
                    "seconds": time.perf_counter() - t0,
                    "request_seconds": times,
                    "frames_per_s": {ck: 1.0 / m for ck, m in med.items()},
                    "psnr_xla_vs_pallas_db": agree,
                    "faster": min(med, key=med.get)})
    emit(results[-1])

    warm = val_batch(frames, "Army")
    for name, ckpt, skw, record_file in SWEEPS:
        t0 = time.perf_counter()
        record = json.load(open(os.path.join(ROOT, "artifacts",
                                             record_file)))
        p, fp = (load_params_npz(ckpt + ".npz"),
                 load_params_npz(ckpt + ".flow.npz"))
        ekw = {k: v for k, v in EVAL_ENGINE.items() if k != "conv_kernel"}
        engs = {ck: FrameInterpolator(p, flow_params=fp, device=CARD0,
                                      conv_kernel=ck, **ekw, **skw)
                for ck in chains}
        for e in engs.values():
            e.midpoints(warm[0], warm[2])
        times, reports = {ck: [] for ck in chains}, {}
        for ck in order:
            torch.cuda.synchronize()
            reset_launch_counts()
            g0 = dict(engs[ck].graph_stats)
            t1 = time.perf_counter()
            reports[ck], batches = sweep(engs[ck], VAL, 1, EB,
                                         load=frames.__getitem__)
            torch.cuda.synchronize()
            times[ck].append(time.perf_counter() - t1)
            runs = (body_runs(graph_delta(engs[ck], g0))
                    * (4 if skw.get("tta") else 1))
            if launch_counts() != want(ck, runs, engs[ck]):
                failures.append(f"{name} {ck}: launches {launch_counts()} "
                                f"over {runs} runs of the model")
        pairs = sum(bt["n"] for bt in batches)
        med = {ck: float(np.median(t)) for ck, t in times.items()}
        quality, missed = sweep_quality(f"{name} pallas", reports["pallas"],
                                        record)
        failures += missed
        results.append({
            "phase": "conv_compare", "workload": f"eval_{name}",
            "seconds": time.perf_counter() - t0, "sweep_seconds": times,
            "pairs_per_s": {ck: pairs / m for ck, m in med.items()},
            "faster": min(med, key=med.get),
            "xla_mean_psnr": reports["xla"]["mean_psnr"],
            "pallas": quality})
        emit(results[-1])
    if failures:
        raise AssertionError("conv_compare: " + "; ".join(failures))
    return results


def phase_tools() -> dict:
    """The two ported kernel tools, in-process on the card at a few
    iterations (`TOOL_RUNS`): every kernel row of their output within the
    tolerance of its plain version, and each of the conv, DCN and warp
    kernels launched. The shapes they launch are the `tools` path's."""
    t0 = time.perf_counter()
    reset_launch_counts()
    results, failures = [], []
    for tool, argv in TOOL_RUNS:
        t1 = time.perf_counter()
        res = tool.main(argv)
        checked = 0
        for row in res["rows"]:
            if "refused" in row or row["kernel"] in TOOL_LIBRARY:
                continue
            checked += 1
            if not row["max_abs_err"] <= REL_TOL * row["ref_max_abs"]:
                failures.append(f"{res['tool']} {row}")
        results.append({"tool": res["tool"], "argv": argv,
                        "seconds": time.perf_counter() - t1,
                        "kernel_rows_checked": checked, "rows": res["rows"]})
    counts = launch_counts()
    for k in ("conv2d", "deform_conv2d_bounded", "bounded_warp"):
        if counts[k] == 0:
            failures.append(f"the tools launched no {k}")
    if failures:
        raise AssertionError("tools: " + "; ".join(failures))
    return {"phase": "tools", "seconds": time.perf_counter() - t0,
            "launches": counts, "runs": results, "_by_shape": shapes_now()}


def phase_user_tools() -> dict:
    """The five user tools in-process on the card at full width (the
    USER_* flags): profile_forward, dump_offsets (and bench_kernels on its
    planes), offset_stats, bench_flowprior and bench_train_step, each with
    the checks stated beside its flags; the conv, DCN and warp kernels
    each launched. The shapes they launch are the `user_tools` path's."""
    t0 = time.perf_counter()
    reset_launch_counts()
    failures, seconds = [], {}

    def run(tool, argv):
        t1 = time.perf_counter()
        res = tool.main(argv)
        seconds[tool.__name__.rsplit(".", 1)[-1]] = time.perf_counter() - t1
        return res

    prof = run(profile_forward, USER_PROFILE)
    span = prof["trace_span_ms"]
    rows = (sum(prof["timeline_ms"].values())
            - prof["cross_category_overlap_ms"] + prof["idle_ms"])
    if not abs(rows - span) <= USER_SPAN_TOL * span:
        failures.append(f"profile_forward: timeline rows {rows} ms against "
                        f"the span {span} ms")
    if not prof["category_ms"]["port-kernels"] > 0:
        failures.append("profile_forward: no device time in the port's "
                        "kernels")
    frames = prof["frames"]
    profile = {k: prof[k] for k in (
        "card", "b", "h", "w", "iters", "frames", "wall_ms", "trace_span_ms",
        "device_busy_ms", "device_busy_share", "idle_ms", "idle_share",
        "device_kernel_ms", "kernel_launches", "category_ms", "timeline_ms",
        "cross_category_overlap_ms", "top_kernels_ms")}
    profile.update(device_ms_per_frame=prof["device_kernel_ms"] / frames,
                   device_ops_per_frame=prof["kernel_launches"] / frames,
                   wall_ms_per_frame=prof["wall_ms"] / frames,
                   rows_ms=rows)

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{n}.npz") for n in ("kernels", "plain")]
        dumps = [run(dump_offsets, USER_DUMP + ["--out", paths[0]]),
                 run(dump_offsets, USER_DUMP + ["--plain", "--out",
                                                paths[1]])]
        dump_err = {}
        for key, ref in dumps[1]["planes"].items():
            got = dumps[0]["planes"][key]
            err = float(np.abs(got - ref).max())
            tol = USER_DUMP_TOL * float(np.abs(ref).max())
            dump_err[key] = {"max_abs_err": err, "tol": tol,
                             "shape": list(got.shape)}
            if not (np.isfinite(got).all() and err <= tol):
                failures.append(f"dump_offsets {key}: {err} > {tol}")
        bench = run(bench_kernels, ["--offsets", paths[0]] + USER_OFFSETS)
    for row in bench["rows"]:
        if (row["kernel"] not in TOOL_LIBRARY
                and not row["max_abs_err"] <= REL_TOL * row["ref_max_abs"]):
            failures.append(f"bench_kernels --offsets {row}")

    stats = run(offset_stats, USER_STATS)
    most = 9 * (2 * stats["radius"] + 1)
    for row in stats["layers"]:
        if not 9 <= row["pairs_wchunk"] <= row["pairs_full_w"] <= most:
            failures.append(f"offset_stats {row}")

    prior = run(bench_flowprior, USER_FLOWPRIOR)
    if not (prior["plain_fps"] > 0 and prior["flow_prior_fps"] > 0):
        failures.append(f"bench_flowprior {prior}")

    step = run(bench_train_step, USER_TRAIN)
    res = step["results"]
    cos = float(F.cosine_similarity(step["grads"]["kernels"],
                                    step["grads"]["handbwd"], dim=0))
    if res["handbwd"]["first_loss"] != res["kernels"]["first_loss"]:
        failures.append(f"bench_train_step: handbwd's first loss "
                        f"{res['handbwd']['first_loss']} against kernels' "
                        f"{res['kernels']['first_loss']}")
    if not cos >= USER_GRAD_COS:
        failures.append(f"bench_train_step: handbwd's gradient at cosine "
                        f"{cos} of kernels'")

    counts = launch_counts()
    for k in ("conv_chain", "deform_conv2d_bounded", "bounded_warp"):
        if counts[k] == 0:
            failures.append(f"the user tools launched no {k}")
    if failures:
        raise AssertionError("user_tools: " + "; ".join(failures))
    return {"phase": "user_tools", "seconds": time.perf_counter() - t0,
            "tool_seconds": seconds, "launches": counts,
            "profile_forward": profile,
            "dump_offsets": {"dx_p99": dumps[0]["dx_p99"],
                             "kernel_vs_plain": dump_err,
                             "tol": USER_DUMP_TOL},
            "bench_kernels_offsets": bench["rows"],
            "offset_stats": stats["layers"],
            "bench_flowprior": prior,
            "bench_train_step": {**{k: step[k] for k in (
                "crop", "batch", "accum", "iters")}, "results": res,
                "handbwd_vs_kernels_ms": res["handbwd"]["ms_per_step"]
                / res["kernels"]["ms_per_step"],
                "grad_cosine": cos, "grad_cos_floor": USER_GRAD_COS},
            "_by_shape": shapes_now()}


def grad_case(name, kernel, plain, inputs) -> dict:
    """Gradients of sum(out * cot) through `kernel` and through `plain`
    with respect to every floating input: the kernel's output carries a
    grad_fn, each gradient is within 2**-7 * max|plain gradient| and
    non-zero wherever the plain one is."""
    grads, launches = {}, None
    for tag, fn in (("kernel", kernel), ("plain", plain)):
        leaves = [None if t is None else t.detach().clone().requires_grad_()
                  for t in inputs]
        reset_launch_counts()
        out = fn(*leaves)
        if tag == "kernel":
            launches = sum(launch_counts().values())
            if out.grad_fn is None or launches != 1:
                raise AssertionError(f"grad {name}: grad_fn {out.grad_fn}, "
                                     f"{launches} launches")
        cot = torch.randn(out.shape, device=out.device,
                          generator=torch.Generator(out.device).manual_seed(1))
        (out.float() * cot).sum().backward()
        grads[tag] = [None if t is None else t.grad for t in leaves]
    errs = []
    for i, (gk, gp) in enumerate(zip(grads["kernel"], grads["plain"])):
        if gp is None:
            continue
        res = check_close(f"grad {name} input {i}", gk, gp)
        lost = int(((gk == 0) & (gp != 0)).sum().item())
        if lost:
            raise AssertionError(f"grad {name} input {i}: {lost} entries "
                                 f"zero where the plain gradient is not")
        errs.append(res["max_abs_err"] / max(res["tol"] * 2 ** 7, 1e-30))
    return {"name": name, "max_rel_err": max(errs), "inputs": len(errs)}


def phase_grad(dev) -> dict:
    """Gradients through each kernel wrapper against those through its
    plain version at GRAD_SHAPE: bf16 activations, float32 weights (as
    the model holds its parameters)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    b, h, w = GRAD_SHAPE

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    x = rnd(b, h, w, 64)
    w3 = [rnd(co, ci, 3, 3, scale=(9 * ci) ** -0.5, dtype=torch.float32)
          for ci, co in ((64, 64), (64, 32), (32, 8))]
    b3 = [rnd(co, scale=0.1, dtype=torch.float32) for co in (64, 32, 8)]
    w27 = rnd(27, 64, 3, 3, scale=1 / 24, dtype=torch.float32)
    b27 = rnd(27, scale=0.1, dtype=torch.float32)
    off = rnd(b, h, w, 18, scale=1.5)
    mask = torch.sigmoid(rnd(b, h, w, 9, scale=2.0).float()).to(
        torch.bfloat16)
    img3, img64 = rnd(b, h, w, 3), rnd(b, h, w, 64)
    flow = rnd(b, h, w, 2, scale=3.0)
    # The stream design's width (no tile plan holds C=128).
    x128 = rnd(b, h, w, 128)
    w128 = rnd(128, 128, 3, 3, scale=1 / 34, dtype=torch.float32)
    b128 = rnd(128, scale=0.1, dtype=torch.float32)
    acts = (True, True, False)
    cases = [
        grad_case("conv2d", lambda x, wt, bt: conv2d(x, wt, bt, True),
                  lambda x, wt, bt: conv2d_plain(x, wt, bt, True),
                  [x, w3[1], b3[1]]),
        grad_case("conv_chain",
                  lambda x, *p: conv_chain(x, p[:3], p[3:], acts),
                  lambda x, *p: conv_chain_plain(x, p[:3], p[3:], acts),
                  [x, *w3, *b3]),
        grad_case("conv_chain/fused",
                  lambda x, *p: conv_chain_fused(x, p[:3], p[3:], acts),
                  lambda x, *p: conv_chain_plain(x, p[:3], p[3:], acts),
                  [x, *w3, *b3]),
        grad_case("conv_chain/L1",
                  lambda x, w, b: conv_chain(x, [w], [b], (False,)),
                  lambda x, w, b: conv_chain_plain(x, [w], [b], (False,)),
                  [x, w27, b27]),
        grad_case("deform_conv2d_bounded",
                  lambda *a: deform_conv2d_bounded(*a, 2),
                  lambda *a: deform_conv2d_bounded_plain(*a, 2),
                  [x, off, mask, w3[0], b3[0]]),
        grad_case("deform_conv2d_bounded/stream C128R4",
                  lambda *a: deform_conv2d_bounded(*a, 4),
                  lambda *a: deform_conv2d_bounded_plain(*a, 4),
                  [x128, off, mask, w128, b128]),
        grad_case("bounded_warp/C3", lambda i, f: bounded_warp(i, f, 4),
                  lambda i, f: bounded_warp_plain(i, f, 4), [img3, flow]),
        grad_case("bounded_warp/C64", lambda i, f: bounded_warp(i, f, 4),
                  lambda i, f: bounded_warp_plain(i, f, 4), [img64, flow]),
    ]
    return {"phase": "grad", "seconds": time.perf_counter() - t0,
            "shape": list(GRAD_SHAPE), "rel_tol": REL_TOL, "cases": cases}


def kernel_launches(rows: list, by_path: dict) -> list:
    """Each row's launches, summed over its paths' runs (null for a shape
    no path takes). Fails when a row's path never launched its shape, and
    when a path launched a (wrapper, shape) that no row of that path
    checks and times."""
    kernels, covered = [], set()
    for row in rows:
        paths, fn_name, key = row.pop("_key")
        per_path = {p: by_path[p][fn_name].get(key, 0) for p in paths}
        for p, n in per_path.items():
            if n == 0:
                raise AssertionError(f"{row['name']}: never launched on the "
                                     f"{p} path")
            covered.add((p, fn_name, key))
        row["launches"] = sum(per_path.values()) if paths else None
        row["launches_by_path"] = per_path
        row.pop("tol")
        kernels.append(row)
    unchecked = [(p, fn_name, key) for p, shapes in by_path.items()
                 for fn_name, counts in shapes.items()
                 for key, n in counts.items()
                 if n and (p, fn_name, key) not in covered]
    if unchecked:
        raise AssertionError(f"launched at shapes no kernel row checks: "
                             f"{unchecked}")
    return kernels


def phase_profile(eng, request) -> dict:
    """Device time of one b=1 request by kernel, and the device's busy
    share of the request's wall time."""
    t0 = time.perf_counter()

    def run():
        eng.midpoints(*request)
        torch.cuda.synchronize()

    res = device_profile(run, CARD0)
    return {"phase": "profile", "seconds": time.perf_counter() - t0, **res}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    card = card_line()
    emit({"phase": "card", "seconds": time.perf_counter() - t0,
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    emit(phase_build())
    emit(phase_native())

    params = load_params_npz(CKPT + ".npz")
    flow_params = load_params_npz(CKPT + ".flow.npz")
    sd = params_from_jax(params)
    sd12 = params_from_jax(load_params_npz(Q12 + ".npz"))

    t0 = time.perf_counter()
    rows = phase_kernels(sd, sd12, dev)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})

    by_path = {}
    t0 = time.perf_counter()
    main_res = phase_main(params, flow_params)
    by_path["main"] = main_res.pop("_by_shape")
    eng, request = main_res.pop("_engine"), main_res.pop("_request")
    main_res["seconds"] = time.perf_counter() - t0
    main_res["card"] = card
    emit(main_res)

    serve_res = phase_serve(params, flow_params)
    by_path["serve"] = serve_res.pop("_by_shape")
    emit(serve_res)

    vplain = FrameInterpolator(params, flow_params=flow_params,
                               device=CARD0, use_kernels=False, **FLAGSHIP)
    for path, phase in (("video", phase_video), ("videos", phase_videos)):
        # an engine of its own, as a user's pipeline starts with: a shape
        # the other phase captured would only replay here, and a replay
        # launches through no wrapper
        veng = FrameInterpolator(params, flow_params=flow_params,
                                 device=CARD0, **FLAGSHIP)
        res = phase(veng, vplain)
        by_path[path] = res.pop("_by_shape")
        emit(res)
    del veng, vplain
    infer_res = phase_infer_cli()
    by_path["infer_cli"] = infer_res.pop("_by_shape")
    emit(infer_res)

    t0 = time.perf_counter()
    frames = decode_val()
    emit({"phase": "decode", "seconds": time.perf_counter() - t0,
          "pngs": len(frames)})
    for R, path in ((2, "q12"), (Q12_R8, "q12_r8")):
        t0 = time.perf_counter()
        q12_res = phase_q12(frames, R)
        by_path[path] = q12_res.pop("_by_shape")
        q12_res["seconds"] = time.perf_counter() - t0
        emit(q12_res)
    eval_res = phase_eval(frames)
    by_path["eval"] = eval_res.pop("_by_shape")
    emit(eval_res)
    emit(phase_epe())
    train_res = phase_train()
    by_path.update(train_res[0].pop("_by_shape"))
    for res in train_res:
        emit(res)
    for path, phase in (("fp32", lambda: [phase_fp32(params, flow_params,
                                                     eng)]),
                        ("eval_fp32", lambda: [phase_eval_fp32(frames)]),
                        ("train_fp32", phase_train_fp32)):
        res = phase()
        by_path[path] = res[0].pop("_by_shape")
        for r in res:
            emit(r)
    for path, phase in (("dp_engine", lambda: phase_dp_engine(params,
                                                              flow_params)),
                        ("spatial", phase_spatial),
                        ("dp_train", phase_dp_train)):
        res = phase()
        by_path[path] = res.pop("_by_shape")
        emit(res)
    phase_conv_compare(frames, params, flow_params)
    tools_res = phase_tools()
    by_path["tools"] = tools_res.pop("_by_shape")
    emit(tools_res)
    user_res = phase_user_tools()
    by_path["user_tools"] = user_res.pop("_by_shape")
    emit(user_res)
    emit(phase_grad(dev))
    if "--profile" in sys.argv[1:]:
        emit(phase_profile(eng, request))

    emit({"kernels": kernel_launches(rows, by_path)})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
