"""Shared CLI plumbing of the port: parameter loading."""

from __future__ import annotations

import os
from typing import Any

from vfi_tpu_torch.utils.convert import load_params_npz


def load_model_params(path: str) -> Any:
    """Load a nested JAX-layout parameter tree from an `.npz` checkpoint
    (the format of the tracked `artifacts/*.npz`). Reference `.pth` files
    and orbax checkpoint directories are not ported yet."""
    if path.endswith(".npz"):
        return load_params_npz(path)
    if path.endswith((".pth", ".pt")) or os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: loading .pth files and orbax checkpoint directories is "
            f"not ported yet; convert to .npz with the JAX package")
    raise ValueError(f"unrecognized params path: {path}")
