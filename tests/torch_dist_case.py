"""Workers of the port's multi-process tests (torch only: spawned ranks
must not import jax). `run_ranks` starts a gloo group of `world` ranks on
the CPU, each running one of the case functions below, and returns what
each rank saved."""

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vfi_tpu_torch.cli.common import free_port


def _entry(rank, world, port, fn_name, spec, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        result = globals()[fn_name](rank, world, spec)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn_name: str, world: int, spec) -> list:
    """Run `fn_name(rank, world, spec)` on `world` gloo ranks; returns
    each rank's result, in rank order."""
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(_entry, args=(world, free_port(), fn_name, spec, out),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _model(kw, state):
    from vfi_tpu_torch.models import EMAVFI

    m = EMAVFI(**kw)
    m.load_state_dict(state)
    return m.eval()


def spatial_cases(rank, world, spec):
    """Each case of `spec["cases"]`: (name, kind, model kwargs, state dict
    key, frames key). kind "model": `spatial_interpolate` of the model;
    "engine": the engine's spatial route (`FrameInterpolator(spatial=
    True)` over the default group) on the JAX-layout tree `spec[state
    key]`; "grid" (4 ranks only): the same over a 2 x 2 grid of two
    spatial groups of two, the batch split over them by `data_group`.
    Rank 0 returns {name: midpoint}."""
    from vfi_tpu_torch.infer import FrameInterpolator
    from vfi_tpu_torch.parallel import spatial_interpolate

    out = {}
    grid = {}
    if world == 4:
        # 2 x 2: spatial groups {0, 1}, {2, 3}; data groups {0, 2}, {1, 3}
        rows = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        cols = [dist.new_group([0, 2]), dist.new_group([1, 3])]
        grid = dict(spatial_group=rows[rank // 2], data_group=cols[rank % 2])
    for name, kind, kw, skey, fkey in spec["cases"]:
        f0, f1 = (torch.from_numpy(a) for a in spec[fkey])
        with torch.no_grad():
            if kind == "model":
                y = spatial_interpolate(_model(kw, spec[skey]), f0, f1)
            elif kind == "grid" and not grid:
                continue
            else:
                eng = FrameInterpolator(spec[skey], bf16=False, device="cpu",
                                        spatial=True,
                                        **(grid if kind == "grid" else {}),
                                        **kw)
                y = eng.midpoints(f0.numpy(), f1.numpy())
        out[name] = y.numpy()
    return out if rank == 0 else {}


def train_tree(spec):
    """The trained tree of a train-step case: the EMAVFI model, or with
    `flow_kw` the {"model", "flow"} ModuleDict."""
    from vfi_tpu_torch.models import SimpleFlowNet

    model = _model(spec["model_kw"], spec["state"])
    if "flow_kw" not in spec:
        return model.train()
    flow = SimpleFlowNet(**spec["flow_kw"])
    flow.load_state_dict(spec["flow_state"])
    return torch.nn.ModuleDict({"model": model, "flow": flow}).train()


def train_state(tree, spec):
    """AdamW at `spec["lr"]` (the optimizer of record), or with lr None an
    SGD at rate 0 and no clip, whose `.grad` keeps the step's gradient."""
    from vfi_tpu_torch.train import TrainState, create_train_state

    if spec["lr"] is None:
        return TrainState(tree, torch.optim.SGD(tree.parameters(), lr=0.0),
                          grad_clip_norm=float("inf"))
    return create_train_state(tree, spec["lr"])


def dp_train_case(rank, world, spec):
    """One optimizer step of `make_train_step` over the gloo group: this
    rank's rows of every microbatch (`data_rows`), `spec["accum"]`
    microbatches. Returns the step's metrics, and the params and
    gradients after it."""
    import numpy as np

    from vfi_tpu_torch.losses import LossWeights
    from vfi_tpu_torch.train import make_train_step
    from vfi_tpu_torch.train.loop import data_rows

    tree = train_tree(spec)
    st = train_state(tree, spec)
    rows = data_rows(spec["batch"][0].shape[0], spec["accum"], rank, world)
    batch = [torch.from_numpy(np.ascontiguousarray(a[rows]))
             for a in spec["batch"]]
    step = make_train_step(None, 0, LossWeights(**spec["weights"]),
                           accum_steps=spec["accum"],
                           data_group=dist.group.WORLD,
                           **spec.get("flags", {}))
    met = step(st, *batch)
    return {"metrics": {k: float(v) for k, v in met.items()},
            "params": {k: v.detach().clone()
                       for k, v in tree.state_dict().items()},
            "grads": {k: p.grad.clone()
                      for k, p in tree.named_parameters()}}
