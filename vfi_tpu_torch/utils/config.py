"""Typed training configuration, the port of `vfi_tpu/utils/config.py`:
the same dataclasses, keys and defaults, so one YAML file (the reference's
`config/train_config.yaml`) loads into both packages to equal values, and
unknown keys fail loudly. Any field can be overridden as `--key value`
(nested: `--color_jitter.hue 0.3`).

PyYAML is imported only inside `load_train_config`, for a YAML file: the
card's machine need not have it. The `--key value` overrides go through
`parse_scalar`, the port's own reader of the YAML 1.1 plain and flow
scalars these values use; it gives what `yaml.safe_load` gives for them
(`2e-5`, with no dot, is a string there, which `_coerce_scalar` then
makes a float, as in the JAX package).

`mesh` lays the trainer's ranks out as the JAX package's does: `mesh.data`
data-parallel ranks (-1: every rank `mesh.spatial` leaves) times
`mesh.spatial` ranks that repeat their data row's rows; `python -m
vfi_tpu_torch.cli.train` starts them (`train/loop.py`, `Trainer`).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ColorJitterConfig:
    """Augmentation jitter ranges (reference: train_config.yaml:29-33)."""

    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (TPU addition; the reference is single-device).

    axis sizes of -1 mean "all remaining devices on that axis".
    """

    data: int = -1      # data-parallel axis
    spatial: int = 1    # spatial (H) sharding axis for huge frames


@dataclass(frozen=True)
class TrainConfig:
    # Optimization (reference: train_config.yaml:1-3, train.py:82,128)
    batch_size: int = 4
    learning_rate: float = 5e-4
    num_epochs: int = 100
    weight_decay: float = 1e-5
    grad_clip_norm: float = 0.1
    # ReduceLROnPlateau equivalents (reference: train.py:84)
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    # Floor for the plateau schedule (torch default 0). The reference's
    # patience=5 with a noisy 7-step/epoch val loss halves the lr every
    # ~12 epochs — long runs need a floor to keep learning.
    plateau_min_lr: float = 0.0
    # Schedule family: "plateau" (reference semantics, train.py:84) or
    # "cosine" (TPU-side quality lever; epoch-clocked cosine decay to
    # cosine_min_lr, with warm restarts every cosine_restart_period epochs
    # when > 0).
    lr_schedule: str = "plateau"
    cosine_restart_period: int = 0
    cosine_min_lr: float = 1e-5

    # Data (reference: train_config.yaml:4-5, 36-39)
    train_data_dir: str = "data/processed/train"
    val_data_dir: str = "data/processed/val"
    crop_size: Tuple[int, int] = (256, 256)
    random_rotation: bool = True
    horizontal_flip: bool = True
    random_grayscale: float = 0.2
    color_jitter: Optional[ColorJitterConfig] = field(default_factory=ColorJitterConfig)
    frame_interval: int = 1
    # Fix for the reference's per-frame-independent jitter bug
    # (data_utils.py:72-76): True = one jitter draw shared by the triplet.
    consistent_jitter: bool = False

    # Loss weights (reference: train_config.yaml:14-18)
    charbonnier_weight: float = 0.5
    vgg_weight: float = 0.15
    color_weight: float = 0.3
    gradient_weight: float = 0.1
    temporal_weight: float = 0.15
    vgg_layer: str = "relu2_2"  # reference: train.py:85
    soft_histogram: bool = False  # differentiable histogram variant
    # With temporal_weight > 0: jointly train a SimpleFlowNet so the
    # temporal-consistency term is live (the reference ships no estimator
    # and silently disables the term, train.py:72-80).
    train_flow_estimator: bool = True
    # The reference compares its [0,1] prediction against ImageNet-NORMALIZED
    # targets (SURVEY §3.1: train.py:40-43 vs ema_vfi.py:146) — the loss then
    # optimizes toward clip(normalized_gt, 0, 1), capping reconstruction
    # quality. False (default) preserves that trained behavior for
    # checkpoint parity; True un-normalizes the target to [0,1] so the loss
    # matches the model's output range (much higher PSNR).
    target_unit_range: bool = False
    flow_mid_channels: int = 32
    flow_levels: int = 3
    # Multi-scale photometric supervision for the flow estimator: in
    # addition to the full-res photometric term, supervise warp(f1, flow)
    # at 1/2 and 1/4 scale (flow magnitude rescaled per scale). Gives the
    # pyramid's coarse levels direct gradient on large displacements —
    # the round-2 estimator plateaued at 3.49 px mean EPE vs the bundled
    # GT (VERDICT r2 #5). Off by default (exactly reproduces the round-2
    # training objective).
    flow_photo_pyramid: bool = False
    # Occlusion masking (forward-backward consistency, Sundaram et al.
    # 2010) for the photometric flow supervision: pixels whose forward
    # and backward flows disagree are excluded from the photometric mean
    # (the warped frame cannot match there — occluded content supplies
    # noise, not signal). Round-5 response to the flow_levels=4 negative
    # result (EPE target <= 2.5 px, VERDICT r4 #5). Off by default.
    flow_photo_occlusion: bool = False
    # Large-motion lever (models/prior.py): pre-warp frame1 halfway along
    # the jointly-trained SimpleFlowNet flow before the main model, so the
    # stride-1 trunk only resolves the small residual. Requires
    # train_flow_estimator (the prior net IS the flow estimator). EMAVFI
    # param shapes are unchanged, so round-1 checkpoints fine-tune into
    # this mode.
    flow_prior: bool = False
    flow_prior_scale: float = 0.5
    # Exponential moving average of the parameters (0 = off). Despite the
    # reference model's NAME (EMA-VFI), no EMA mechanism exists anywhere in
    # its code (SURVEY.md intro; reference src/models/ema_vfi.py:63) — this
    # supplies the classic quality lever: validation, best-model export,
    # and snapshots all use the EMA tree when enabled. Typical: 0.999 for
    # long runs, ~0.99 for short fine-tunes.
    ema_decay: float = 0.0
    # Dead keys in the reference (train_config.yaml:24-25) — accepted and
    # ignored for YAML compatibility.
    gradient_order: int = 1
    temporal_alpha: float = 1.0

    # Checkpointing / outputs (reference: train_config.yaml:7-8, 27)
    checkpoint_path: str = "checkpoints"
    best_model_path: str = "best_ema_vfi"
    # Metric gating the best-model export: "val_loss" (reference semantics,
    # train.py:180-182) or "val_psnr". The multi-term loss on augmented val
    # crops can drift UP while PSNR/SSIM improve (observed in the round-2
    # EMA fine-tune), so quality runs should gate on "val_psnr".
    best_metric: str = "val_loss"
    output_image_path: str = "output_images"
    resume: bool = True            # addition: the reference cannot resume
    keep_checkpoints: int = 3
    # Warm-start: initialize model / flow-estimator params from npz
    # checkpoints (the trainer's own best/snapshot exports) before training.
    # Unlike `resume` this starts a FRESH run (epoch 0, fresh optimizer) —
    # the fine-tuning path, e.g. adapting a trained checkpoint to
    # flow_prior mode. Ignored when a checkpoint is resumed.
    init_model_path: Optional[str] = None
    init_flow_path: Optional[str] = None
    # > 0: additionally save a model-only npz snapshot every N epochs under
    # <checkpoint_path>/snapshots/ (cheap at 1.43M params; enables
    # budget-matched cross-framework quality comparisons at any epoch).
    snapshot_every: int = 0

    # Model
    in_channels: int = 3
    mid_channels: int = 64
    num_blocks: int = 3
    vgg_weights_path: Optional[str] = None  # npz from convert_vgg16_torch
    # Bounded-sampling fast paths (see EMAVFI docstring): offsets/flow clamp
    # radius in px; None = exact unbounded reference semantics.
    dcn_max_offset: Optional[int] = None
    warp_max_flow: Optional[int] = None
    # In the port: True runs the bounded DCN and warp (and, with
    # conv_kernel "pallas", the conv chains) through the CUDA kernels, False
    # through their plain PyTorch versions (EMAVFI.use_kernels).
    use_pallas: bool = False
    # TPU tiling knob of the JAX package; accepted, no effect in the port.
    dcn_tile_w: Optional[int] = None
    # TPU DCN kernel generation ("v4" or "v5") of the JAX package; both
    # compute one function, so it has no effect in the port.
    dcn_kernel: str = "v4"
    # Conv trunk route: "pallas" runs the stride-1 chains through the port's
    # conv-chain kernel (with use_pallas), "xla" as plain convs. See
    # EMAVFI.conv_kernel.
    conv_kernel: str = "xla"
    # Self-cascade depth (EMAVFI.cascade_levels): > 1 runs the model's own
    # motion stages coarse-to-fine on downsampled copies (shared weights —
    # checkpoint-compatible) and pre-warps frame2 by each level's upsampled
    # flow; the in-model large-motion lever. 1 = reference-parity topology.
    cascade_levels: int = 1
    # Lane-aligned fusion (EMAVFI.fuse_project): 1x1-project the 67-channel
    # fusion concat to mid_channels before the DCN stack so the deformable
    # kernels run at a power-of-two channel count. Changes the parameter
    # tree (adds fuse_proj); warm-start from a 67-channel checkpoint via
    # tools/project_checkpoint.py.
    fuse_project: bool = False

    # Execution (additions)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    bf16: bool = True              # bfloat16 activation compute
    remat: bool = False            # rematerialize fwd in backprop (save HBM)
    # Gradient accumulation: split each batch into accum_steps sequential
    # microbatches inside the jit'd step (lax.scan), average the grads, and
    # apply ONE optimizer update. Trains an effective batch of batch_size
    # with the activation memory of batch_size/accum_steps — e.g. flow-prior
    # mode at effective batch 8 despite the DCN-backward padding wall that
    # OOMs a monolithic batch-8 step (docs/PERFORMANCE.md "Flow-prior
    # training memory").
    accum_steps: int = 1
    seed: int = 0
    log_every: int = 10
    profile_dir: Optional[str] = None  # torch.profiler trace of epoch 1


@dataclass(frozen=True)
class InferConfig:
    """Video interpolation settings (reference: inference.py:23-35)."""

    input_video: str = ""
    output_video: str = ""
    model_path: str = "checkpoints/best"
    target_fps: Optional[float] = None
    max_interpolation_factor: int = 4
    frame_interval: int = 1
    codec: str = "mp4v"
    scale: float = 0.5
    batch_size: int = 8            # addition: batched pair inference
    bf16: bool = True
    # Reproduce the reference's output quirks (frame ordering, duplicated
    # midpoints for factor>1, inverse-ImageNet denormalize) exactly.
    reference_compat: bool = False


def _coerce_scalar(value, hint, path: str):
    """Coerce a YAML/CLI scalar to the declared field type.

    Needed because PyYAML follows YAML 1.1: `2e-5` (no dot before the
    exponent) parses as a *string*, and CLI `--key value` overrides go
    through yaml.safe_load — without coercion a float field can silently
    hold a str and blow up epochs later (observed: plateau_min_lr reaching
    `max(float, str)` at the first LR-reduction step)."""
    import typing

    origin = typing.get_origin(hint)
    if origin is typing.Union:  # Optional[X] and friends
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if value is None or (isinstance(value, str)
                             and value.lower() in ("none", "null")):
            return None
        for a in args:
            try:
                return _coerce_scalar(value, a, path)
            except (TypeError, ValueError):
                continue
        raise ValueError(f"Config key {path}: cannot coerce {value!r} to {hint}")
    if origin in (tuple, list):
        args = typing.get_args(hint)
        if not isinstance(value, (tuple, list)):
            raise ValueError(f"Config key {path}: expected sequence, got {value!r}")
        if args and args[-1] is not Ellipsis and len(args) == len(value):
            return tuple(_coerce_scalar(v, a, path) for v, a in zip(value, args))
        elem = args[0] if args else None
        return tuple(_coerce_scalar(v, elem, path) if elem else v for v in value)
    if hint is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "yes", "1", "on"):
                return True
            if low in ("false", "no", "0", "off"):
                return False
        if isinstance(value, int):
            return bool(value)
        raise ValueError(f"Config key {path}: expected bool, got {value!r}")
    if hint is float:
        if isinstance(value, bool):
            # bools are ints in Python: without this, `--learning_rate true`
            # would silently store True in a float field
            raise ValueError(f"Config key {path}: expected float, got bool {value!r}")
        return float(value)
    if hint is int:
        if isinstance(value, bool):
            raise ValueError(f"Config key {path}: expected int, got bool {value!r}")
        f = float(value)
        if f != int(f):
            raise ValueError(f"Config key {path}: expected int, got {value!r}")
        return int(f)
    if hint is str:
        if not isinstance(value, str):
            raise ValueError(f"Config key {path}: expected str, got {value!r}")
        return value
    return value  # dataclasses / Any: handled by the caller


def _from_dict(cls, data: dict, path: str = ""):
    """Build a (possibly nested) dataclass from a dict, failing on unknown
    keys, coercing scalars to the declared field types and list -> tuple
    where the field demands it."""
    import typing

    names = {f.name: f for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for key, value in data.items():
        if key not in names:
            raise KeyError(f"Unknown config key: {path}{key!r}")
        f = names[key]
        if f.name == "color_jitter" and isinstance(value, dict):
            value = _from_dict(ColorJitterConfig, value, path=f"{key}.")
        elif f.name == "mesh" and isinstance(value, dict):
            value = _from_dict(MeshConfig, value, path=f"{key}.")
        elif f.name in ("color_jitter", "mesh") and value is None:
            pass
        else:
            value = _coerce_scalar(value, hints.get(key, Any), f"{path}{key}")
        kwargs[key] = value
    return cls(**kwargs)


# YAML 1.1 implicit types of a plain scalar (the core resolver's rules,
# as PyYAML's `safe_load` applies them).
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                     |[-+]?0[0-7_]+
                     |[-+]?(?:0|[1-9][0-9_]*)
                     |[-+]?0x[0-9a-fA-F_]+
                     |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                       |\.[0-9_]+(?:[eE][-+][0-9]+)?
                       |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                       |[-+]?\.(?:inf|Inf|INF)
                       |\.(?:nan|NaN|NAN))$""", re.X)


def _sexagesimal(text: str, conv):
    sign = -1 if text[0] == "-" else 1
    digits = [conv(p) for p in text.lstrip("+-").split(":")]
    value = 0
    for d in digits:
        value = value * 60 + d
    return sign * value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    t = t.lstrip("+-")
    if t == "0":
        return 0
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if t[0] == "0":
        return sign * int(t, 8)
    if ":" in t:
        return sign * _sexagesimal(t, int)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t[0] == "-" else 1.0
    t = t.lstrip("+-")
    if t == ".inf":
        return sign * float("inf")
    if t == ".nan":
        return float("nan")
    if ":" in t:
        return sign * _sexagesimal(t, float)
    return sign * float(t)


def _plain(text: str):
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


def _quoted(text: str) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"unterminated quoted scalar: {text!r}")
    inner = text[1:-1]
    if q == "'":
        return inner.replace("''", "'")
    escapes = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "r": "\r",
               "0": "\0", "/": "/", " ": " "}
    out, i = [], 0
    while i < len(inner):
        ch = inner[i]
        if ch == "\\":
            nxt = inner[i + 1:i + 2]
            if nxt not in escapes:
                raise ValueError(f"unsupported escape in {text!r}")
            out.append(escapes[nxt])
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _split_flow(inner: str) -> list:
    """Split a flow sequence's body at its top-level commas."""
    items, depth, quote, cur = [], 0, None, []
    for ch in inner:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    items.append("".join(cur))
    if items and not items[-1].strip():    # a trailing comma
        items.pop()
    return items


def parse_scalar(text: str):
    """What `yaml.safe_load(text)` gives for an override value: YAML 1.1
    plain scalars (null, bools, ints, floats, strings), single- and
    double-quoted strings, and flow sequences (`[320,320]`) of them.
    Mappings, anchors, tags and block scalars raise ValueError."""
    t = text.strip()
    if t.startswith("#"):
        return None
    if t and t[0] not in "'\"" and " #" in t:     # a trailing comment
        t = t.split(" #", 1)[0].rstrip()
    if not t:
        return None
    if t[0] in "'\"":
        return _quoted(t)
    if t[0] == "[":
        if t[-1] != "]":
            raise ValueError(f"unterminated flow sequence: {text!r}")
        return [parse_scalar(s) for s in _split_flow(t[1:-1])]
    if t[0] in "{&*!|>%@`" or t.startswith(("- ", "? ")) or ": " in t \
            or t.endswith(":"):
        raise ValueError(f"override value {text!r}: only scalars and flow "
                         f"sequences are read (pass a YAML file for more)")
    return _plain(t)


def load_train_config(
    yaml_path: Optional[str | Path] = None,
    overrides: Optional[Sequence[str]] = None,
) -> TrainConfig:
    """Load a TrainConfig from YAML (optional; needs PyYAML) and `--key
    value` overrides (a flat argv-style list, e.g. ``["--batch_size",
    "16", "--color_jitter.hue", "0.3"]``; no PyYAML needed)."""
    data: dict[str, Any] = {}
    if yaml_path is not None:
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"reading the YAML config {yaml_path} needs pyyaml, which is "
                f"not installed; pass the settings as --key value overrides "
                f"instead") from e
        with open(yaml_path, "r", encoding="utf-8") as f:
            data = yaml.safe_load(f) or {}
    if overrides:
        if len(overrides) % 2 != 0:
            raise ValueError(f"Overrides must be --key value pairs, got {overrides}")
        for i in range(0, len(overrides), 2):
            key = overrides[i]
            if not key.startswith("--"):
                raise ValueError(f"Override keys must start with '--': {key}")
            node = data
            *parents, leaf = key[2:].split(".")
            for p in parents:
                node = node.setdefault(p, {})
                if not isinstance(node, dict):
                    raise ValueError(f"Cannot nest override under scalar key {p!r}")
            node[leaf] = parse_scalar(overrides[i + 1])
    return _from_dict(TrainConfig, data)
