"""Training checkpoints with resume, the port of
`vfi_tpu/train/checkpoints.py`, in the port's own format.

Each `save(epoch, ...)` writes one file, `<dir>/torch_epoch_<epoch>.pt`,
holding only tensors and plain Python values (the params' state dict, the
optimizer's, the step and the meta: epoch, scheduler state, val loss, the
best-model watermark and, for an interrupted epoch, the steps it had
done), so that `torch.load(weights_only=True)` reads it. The write goes to a `.tmp` file first, then `os.replace`. The `keep`
newest files stay. The names cannot collide with the JAX trainer's orbax
step directories (`<dir>/<step>/`), and `orbax_steps` lists those, so
that a resume never starts afresh over a JAX run's directory.

`save_params_npz` writes a module's parameters (or a ModuleDict of them,
as the joint {"model", "flow"} tree) as the JAX-layout `.npz` that both
packages load; `load_params_into` reads one back.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
from torch import nn

from vfi_tpu_torch.train.state import TrainState, set_learning_rate
from vfi_tpu_torch.utils import convert

_NAME = re.compile(r"^torch_epoch_(\d+)\.pt$")


def _file(path: str, epoch: int) -> str:
    return os.path.join(path, f"torch_epoch_{epoch:06d}.pt")


class CheckpointManager:
    """(state, scheduler, epoch) checkpoints under `directory`."""

    def __init__(self, directory: str, keep: int = 3):
        self.path = os.path.abspath(directory)
        self.keep = keep
        self.last_meta: dict = {}
        os.makedirs(self.path, exist_ok=True)

    def epochs(self) -> list:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.path))
                      if m)

    def orbax_steps(self) -> list:
        """The JAX trainer's orbax step directories here (integer names)."""
        return sorted(int(n) for n in os.listdir(self.path)
                      if n.isdigit() and os.path.isdir(os.path.join(self.path,
                                                                    n)))

    def save(self, epoch: int, state: TrainState, scheduler,
             extra: Optional[dict] = None) -> None:
        extra = extra or {}
        payload = {
            "params": state.params.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "meta": {
                "epoch": int(epoch),
                "scheduler": scheduler.state_dict(),
                "val_loss": float(extra.get("val_loss", float("nan"))),
                "best_val": float(extra.get("best_val", float("nan"))),
                # an interrupted epoch: its completed steps and their summed
                # train loss (-1: the epoch is complete)
                "batches_done": int(extra.get("batches_done", -1)),
                "train_running": float(extra.get("train_running", 0.0)),
            },
        }
        path = _file(self.path, epoch)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.epochs()[:-self.keep] if self.keep > 0 else ():
            os.remove(_file(self.path, old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, state: TrainState, scheduler,
                epoch: Optional[int] = None) -> tuple[TrainState, int]:
        """Restore into `state` and `scheduler` in place; returns (state,
        epoch)."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint under {self.path}")
        payload = torch.load(_file(self.path, epoch), map_location="cpu",
                             weights_only=True)
        state.params.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        meta = payload["meta"]
        scheduler.load_state_dict(meta["scheduler"])
        set_learning_rate(state, scheduler.lr)
        self.last_meta = {k: meta[k] for k in ("val_loss", "best_val",
                                               "batches_done",
                                               "train_running")}
        return state, int(meta["epoch"])

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX manager's interface."""

    def close(self) -> None:
        """Nothing to release; kept for the JAX manager's interface."""


def jax_tree(params: nn.Module) -> dict:
    """A module's parameters as the nested JAX-layout tree; a ModuleDict
    (the joint {"model", "flow"} tree) gives one such tree a key."""
    if isinstance(params, nn.ModuleDict):
        return {k: jax_tree(v) for k, v in params.items()}
    return convert.params_to_jax(params.state_dict())


def save_params_npz(params: nn.Module, out_path: str) -> None:
    """Export `params` as a JAX-layout `.npz` (atomic write)."""
    convert.save_params_npz(jax_tree(params), out_path)


def load_params_into(params: nn.Module, tree: dict) -> None:
    """Copy a JAX-layout tree (as `jax_tree` gives) into `params`."""
    if isinstance(params, nn.ModuleDict):
        for k, v in params.items():
            load_params_into(v, tree[k])
        return
    sd = convert.params_from_jax(tree)
    params.load_state_dict({k: t.to(params.state_dict()[k].dtype)
                            for k, t in sd.items()})
