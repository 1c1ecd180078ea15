"""Checkpoint I/O for the port.

The tracked checkpoints (`artifacts/*.npz`) are flattened Flax trees with
'/'-joined keys (`params/<module>/.../kernel`). `load_params_npz`,
`save_params_npz`, `infer_model_dims` and the reference converters are
copies of their `vfi_tpu.utils.convert` counterparts (the port keeps its
own copy and imports nothing of the JAX package):

- `convert_ema_vfi_torch` reads a reference `.pth` (`EMA_VFI.state_dict()`)
  into that nested JAX-layout tree: conv weights OIHW -> HWIO, the Linear
  (out, in) -> (in, out), the DCN's weight OIHW -> HWIO;
- `convert_vgg16_torch` does the same for torchvision `vgg16` `features`
  (the perceptual loss's VGG16Features, conv0..conv9);
- `python -m vfi_tpu_torch.utils.convert [--vgg] in.pth out.npz` writes
  the tree with `save_params_npz`, which the JAX package loads too.

`params_from_jax` maps such a tree onto the port's module state-dict
names:

- conv kernels HWIO -> OIHW (`nn.Conv2d.weight`; the CUDA wrappers repack
  to their own layouts per call);
- Dense kernels (in, out) -> Linear (out, in);
- biases unchanged; the path separators become '.', `kernel` -> `weight`.

It covers EMAVFI trees (42 keys in the qocc checkpoint), SimpleFlowNet
trees (18 keys in its `.flow.npz`) and VGG16Features trees.
`params_to_jax` is its inverse: the trainer writes its exports through
it and `save_params_npz`.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict

import numpy as np
import torch


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _conv(sd: Dict[str, np.ndarray], name: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": sd[f"{name}.weight"].transpose(2, 3, 1, 0),
        "bias": sd[f"{name}.bias"],
    }


def convert_ema_vfi_state_dict(
    sd: Dict[str, np.ndarray], num_blocks: int | None = None
) -> Dict[str, Any]:
    """Map a reference `EMA_VFI.state_dict()` onto the EMAVFI tree.

    Module names follow the reference's registration order: Sequential
    conv blocks expose their conv as `.0`, raw convs as the bare index,
    the context head's Linear is `context_encoding.5`, and each attention
    block has `offset_conv` / `dcn_v2` children."""
    if num_blocks is None:
        num_blocks = sum(1 for k in sd
                         if k.startswith("feat_ext_blocks.conv_block_")
                         and k.endswith(".weight"))
    p: Dict[str, Any] = {}
    p["feat_ext_conv1"] = {"conv": _conv(sd, "feat_ext_conv1.0")}
    for i in range(num_blocks):
        p[f"feat_ext_block{i}"] = {
            "conv": _conv(sd, f"feat_ext_blocks.conv_block_{i}.0")}
    p["ctx_conv1"] = {"conv": _conv(sd, "context_encoding.0.0")}
    p["ctx_conv2"] = {"conv": _conv(sd, "context_encoding.1.0")}
    p["ctx_conv3"] = {"conv": _conv(sd, "context_encoding.2.0")}
    p["ctx_dense"] = {
        "kernel": sd["context_encoding.5.weight"].transpose(1, 0),
        "bias": sd["context_encoding.5.bias"],
    }
    p["motion_conv1"] = {"conv": _conv(sd, "motion_estimation.0.0")}
    p["motion_conv2"] = {"conv": _conv(sd, "motion_estimation.1.0")}
    p["motion_conv3"] = {"conv": _conv(sd, "motion_estimation.2")}
    for i in range(num_blocks):
        p[f"fusion_dcn{i}"] = {
            "offset_conv": _conv(sd, f"attention_blocks.{i}.offset_conv"),
            "kernel": sd[f"attention_blocks.{i}.dcn_v2.weight"].transpose(
                2, 3, 1, 0),
            "bias": sd[f"attention_blocks.{i}.dcn_v2.bias"],
        }
    p["rec_conv1"] = {"conv": _conv(sd, "reconstruction.0.0")}
    p["rec_conv2"] = {"conv": _conv(sd, "reconstruction.1.0")}
    p["rec_conv3"] = {"conv": _conv(sd, "reconstruction.2")}
    return {"params": p}


def convert_ema_vfi_torch(pth_path: str,
                          num_blocks: int | None = None) -> Dict[str, Any]:
    """Load a reference `.pth` and return its EMAVFI tree."""
    return convert_ema_vfi_state_dict(_load_state_dict(pth_path), num_blocks)


# torchvision vgg16 `features` conv indices up to relu4_3 (cfg D).
_VGG16_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)


def convert_vgg16_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Map torchvision `vgg16().state_dict()` (or just its `features.*`
    entries, or bare `0.weight` names) onto VGG16Features (conv0..conv9)."""
    p: Dict[str, Any] = {}
    for our_idx, torch_idx in enumerate(_VGG16_TORCH_CONV_IDX):
        key = f"features.{torch_idx}.weight"
        if key not in sd:
            key = f"{torch_idx}.weight"
        p[f"conv{our_idx}"] = {
            "kernel": sd[key].transpose(2, 3, 1, 0),
            "bias": sd[key.replace("weight", "bias")],
        }
    return {"params": p}


def convert_vgg16_torch(pth_path: str) -> Dict[str, Any]:
    return convert_vgg16_state_dict(_load_state_dict(pth_path))


def save_params_npz(params: Dict[str, Any], out_path: str) -> None:
    """Flatten a nested params tree into an npz ('a/b/c' keys). The write
    is atomic (a `.tmp.npz` beside it, then `os.replace`): a reader never
    sees a half-written file."""
    flat: Dict[str, np.ndarray] = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)

    rec(params, "")
    tmp = out_path + ".tmp.npz"     # .npz, so np.savez appends nothing
    np.savez(tmp, **flat)
    os.replace(tmp, out_path)


def load_params_npz(path: str) -> Dict[str, Any]:
    """Load a flattened npz into the nested tree `save_params_npz` wrote."""
    flat = np.load(path)
    tree: Dict[str, Any] = {}
    for key in flat.files:
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = flat[key]
    return tree


def infer_model_dims(params: Dict[str, Any]) -> Dict[str, Any]:
    """Read (in_channels, mid_channels, num_blocks, fuse_project) off an
    EMAVFI tree (nested JAX layout), so loaders need no side-channel
    config."""
    p = params["params"] if "params" in params else params
    kernel = p["feat_ext_conv1"]["conv"]["kernel"]
    return {
        "in_channels": int(kernel.shape[2]) // 2,
        "mid_channels": int(kernel.shape[3]),
        "num_blocks": sum(1 for k in p if k.startswith("feat_ext_block")),
        "fuse_project": "fuse_proj" in p,
    }


def _flatten(node, prefix, out):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}.{k}" if prefix else k, out)
    else:
        out[prefix] = np.asarray(node)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested JAX param tree -> torch state dict (float32 CPU tensors)."""
    p = tree["params"] if "params" in tree else tree
    flat: Dict[str, np.ndarray] = {}
    _flatten(p, "", flat)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        head, _, leaf = key.rpartition(".")
        if leaf == "kernel":
            if arr.ndim == 4:       # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:     # Dense (in, out) -> Linear (out, in)
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at {key}")
            key = f"{head}.weight" if head else "weight"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter leaf {key!r}")
        sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `params_from_jax`: a torch state dict (EMAVFI,
    SimpleFlowNet or VGG16Features) -> the nested JAX-layout tree
    `{"params": ...}` of float32 numpy arrays that `save_params_npz`
    writes and both packages load. Conv weights OIHW -> HWIO, Linear
    (out, in) -> Dense (in, out), `weight` -> `kernel`."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        head, _, leaf = key.rpartition(".")
        if leaf == "weight":
            if arr.ndim == 4:       # OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:     # Linear (out, in) -> Dense (in, out)
                arr = arr.T
            else:
                raise ValueError(f"unexpected weight rank {arr.ndim} at "
                                 f"{key}")
            leaf = "kernel"
        elif leaf != "bias":
            raise ValueError(f"unexpected parameter {key!r}")
        node = tree
        for part in head.split(".") if head else ():
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (2, 3) or (len(argv) == 3 and argv[0] != "--vgg"):
        print("usage: python -m vfi_tpu_torch.utils.convert [--vgg] "
              "model.pth out.npz", file=sys.stderr)
        return 2
    if argv[0] == "--vgg":
        params = convert_vgg16_torch(argv[1])
        out = argv[2]
    else:
        params = convert_ema_vfi_torch(argv[0])
        out = argv[1]
    save_params_npz(params, out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
