"""Checkpoint loading for the port.

The tracked checkpoints (`artifacts/*.npz`) are flattened Flax trees with
'/'-joined keys (`params/<module>/.../kernel`). `load_params_npz` and
`infer_model_dims` are copies of their `vfi_tpu.utils.convert`
counterparts (the port keeps its own copy and imports nothing of the JAX
package). `params_from_jax` maps such a tree onto the port's module
state-dict names:

- conv kernels HWIO -> OIHW (`nn.Conv2d.weight`; the CUDA wrappers repack
  to their own layouts per call);
- Dense kernels (in, out) -> Linear (out, in);
- biases unchanged; the path separators become '.', `kernel` -> `weight`.

It covers both EMAVFI trees (42 keys in the qocc checkpoint) and
SimpleFlowNet trees (18 keys in its `.flow.npz`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


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
