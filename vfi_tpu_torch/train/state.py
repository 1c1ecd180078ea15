"""Train state, the optimizer of record and the learning-rate schedules,
the port of `vfi_tpu/train/state.py`.

The optimizer of record is global-norm gradient clipping at 0.1 followed
by AdamW (weight decay 1e-5 on every parameter, b1 0.9, b2 0.999, eps
1e-8), as `optax.chain(clip_by_global_norm, adamw)`: `torch.optim.AdamW`
computes optax's `adamw` update. The clip is optax's own arithmetic,
`g / norm * max_norm` where the norm reaches `max_norm` (not
`clip_grad_norm_`, which divides by norm + 1e-6). Parameters stay float32;
bf16 is the models' activation dtype.

The schedules are host-side and step once an epoch; `set_learning_rate`
writes the new rate into every parameter group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, float32 (optax.global_norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Clip `grads` in place as optax.clip_by_global_norm does; returns the
    norm before clipping."""
    norm = global_norm(grads)
    if not bool(norm < max_norm):
        torch._foreach_div_(grads, norm)
        torch._foreach_mul_(grads, max_norm)
    return norm


def make_optimizer(params, learning_rate: float,
                   weight_decay: float = 1e-5) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


class TrainState:
    """The trained module tree (`params`: the EMAVFI module, or a ModuleDict
    {"model", "flow"} under joint flow training), its optimizer, the clip
    norm and the step count."""

    def __init__(self, params: nn.Module, optimizer: torch.optim.Optimizer,
                 grad_clip_norm: float = 0.1, step: int = 0):
        self.params = params
        self.optimizer = optimizer
        self.grad_clip_norm = grad_clip_norm
        self.step = step

    def leaves(self) -> list:
        return [p for p in self.params.parameters() if p.requires_grad]

    def apply_gradients(self) -> torch.Tensor:
        """Clip the gradients held in `.grad` and take one optimizer step;
        returns their global norm before clipping. A leaf with no gradient
        takes a zero one, so that weight decay reaches it, as in optax."""
        leaves = self.leaves()
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in leaves],
                                    self.grad_clip_norm)
        self.optimizer.step()
        self.step += 1
        return norm


def create_train_state(params: nn.Module, learning_rate: float,
                       weight_decay: float = 1e-5,
                       grad_clip_norm: float = 0.1) -> TrainState:
    leaves = [p for p in params.parameters() if p.requires_grad]
    return TrainState(params, make_optimizer(leaves, learning_rate,
                                             weight_decay), grad_clip_norm)


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Write `lr` into every parameter group (between epochs)."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (torch semantics, mode 'min'): `step(val_loss)`
    returns the new lr."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad: int = 0

    def step(self, val_loss: float) -> float:
        if val_loss < self.best * (1.0 - self.threshold):
            self.best = val_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad = int(d["num_bad"])


@dataclass
class CosineScheduler:
    """Epoch-clocked cosine decay from lr0 to min_lr, with warm restarts
    every `period` epochs when period > 0 (0: one cosine over `total`, then
    min_lr). `step(val_loss)` ignores its argument."""

    lr0: float
    total: int
    period: int = 0
    min_lr: float = 1e-5
    t: int = 0
    lr: float = 0.0
    restarts: bool = False

    def __post_init__(self):
        self.restarts = self.period > 0
        if self.period <= 0:
            self.period = max(self.total, 1)
        if self.lr == 0.0:
            self.lr = self.lr0

    def step(self, val_loss: float) -> float:  # noqa: ARG002 (interface)
        self.t += 1
        if self.restarts:
            tc = self.t % self.period
        else:
            tc = min(self.t, self.period)
        self.lr = self.min_lr + 0.5 * (self.lr0 - self.min_lr) * (
            1.0 + math.cos(math.pi * tc / self.period))
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "t": self.t, "lr0": self.lr0,
                "period": self.period, "min_lr": self.min_lr}

    def load_state_dict(self, d: dict) -> None:
        # Only the clock (t, lr) is checkpoint state; the schedule's shape
        # belongs to the config.
        self.lr = float(d["lr"])
        self.t = int(d["t"])
