"""Shared CLI plumbing of the port: parameter loading."""

from __future__ import annotations

import os
from typing import Any

from vfi_tpu_torch.utils.convert import convert_ema_vfi_torch, load_params_npz


def load_model_params(path: str) -> Any:
    """Load a nested JAX-layout parameter tree from an `.npz` checkpoint
    (the format of the tracked `artifacts/*.npz`) or a reference `.pth` /
    `.pt` state dict (converted on the fly). Orbax checkpoint directories
    are refused: orbax is not installed on the card's machine, so the port
    does not read them."""
    if path.endswith((".pth", ".pt")):
        return convert_ema_vfi_torch(path)
    if path.endswith(".npz"):
        return load_params_npz(path)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: orbax checkpoint directories are not read by the port "
            f"(orbax is not installed on the card's machine); export the "
            f"params to .npz with the JAX package")
    raise ValueError(f"unrecognized params path: {path}")
