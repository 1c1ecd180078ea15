"""Autograd for the kernel wrappers: the port of the reference's
`custom_vjp`s (`vfi_tpu/ops/pallas/wrappers.py`), whose forward is the
kernel and whose backward differentiates the plain formulation of the same
function.

`differentiable(launch, plain, *inputs)` is what a wrapper returns on the
card. When grad is enabled and an input requires it, the launch runs as
the forward of `ThroughPlain`, whose backward is autograd of
`plain(*inputs)` on the saved inputs (one recomputed plain forward, as
`jax.vjp` of the XLA op in the reference). Otherwise (the engine's
`inference_mode`, `no_grad`, or no input that requires grad) it is the bare
launch, with no autograd bookkeeping. The single conv, whose reference
backward is closed-form, has its own Function in `ops/cuda/conv.py`.
"""

from __future__ import annotations

from typing import Callable

import torch


def needs_grad(*inputs) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)


class ThroughPlain(torch.autograd.Function):
    """forward: `launch(*inputs)`; backward: autograd of `plain(*inputs)`.
    `inputs` are tensors or None (an absent mask or bias)."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*leaves)
        wrt = [t for t, n in zip(leaves, need) if n]
        grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in need))


def differentiable(launch: Callable, plain: Callable, *inputs):
    """`launch(*inputs)`, recorded for autograd through `plain` when grad
    is needed (see the module docstring)."""
    if needs_grad(*inputs):
        return ThroughPlain.apply(launch, plain, *inputs)
    return launch(*inputs)
