"""Shared CLI plumbing of the port: parameter loading, and a free local
port for the rendezvous of the ranks a CLI starts."""

from __future__ import annotations

import os
import socket
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


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no one listens on now (the ranks'
    `init_process_group` rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
