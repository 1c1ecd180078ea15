"""`python -m vfi_tpu_torch.cli.train` — train EMAVFI with the port, the
counterpart of `vfi_tpu/cli/train.py`: `--config` (a YAML file; needs
pyyaml), `--num-epochs`, and any TrainConfig field as `--key value`
(nested: `--color_jitter.hue 0.3`), plus `--device` (default `cuda`; the
CPU runs only when asked).

A mesh of more than one rank (`--mesh.data`, `--mesh.spatial`; data -1
takes every visible card `mesh.spatial` leaves, or one data row on the
CPU) starts its ranks here, one process each: NCCL with one card a rank,
or gloo on the CPU with `--device cpu`. Fewer cards than ranks is an
error. Rank 0 prints, logs and writes the outputs.
"""

from __future__ import annotations

import argparse
import dataclasses


def _report(history) -> None:
    if history["val_loss"]:
        print(f"done: best val loss {min(history['val_loss']):.4f}, "
              f"best PSNR {max(history['psnr']):.2f} dB, "
              f"final PSNR {history['psnr'][-1]:.2f} dB")


def _rank(rank: int, world: int, port: int, cfg, device: str) -> None:
    """One rank of a data-parallel run."""
    import torch
    import torch.distributed as dist

    from vfi_tpu_torch.train.loop import Trainer

    cuda = device != "cpu"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        trainer = Trainer(cfg, device=f"cuda:{rank}" if cuda else "cpu",
                          data_group=dist.group.WORLD)
        history = trainer.run()
        if rank == 0:
            _report(history)
    finally:
        dist.destroy_process_group()


def ranks_for(cfg, device: str) -> int:
    """The ranks the config's mesh takes on `device`'s cards (data -1:
    every visible card, one data row on the CPU); raises when the cards
    are fewer, or when a run of several ranks names one card."""
    import torch

    from vfi_tpu_torch.infer.pair import resolve_device
    from vfi_tpu_torch.train.loop import mesh_axes

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else None
    data, spatial = cfg.mesh.data, cfg.mesh.spatial
    if data == -1 and cards is None:
        data = 1
    data, spatial = mesh_axes(data, spatial, cards)
    world = data * spatial
    if world > 1 and cards is not None:
        if world > cards:
            raise ValueError(f"mesh {data}x{spatial} needs {world} cards, "
                             f"{cards} visible")
        if dev.index is not None:
            raise ValueError(f"--device {device}: a run of {world} ranks "
                             "takes cards 0..n-1 (one a rank); pass "
                             "--device cuda")
    return world


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Train EMAVFI (PyTorch port). Unlisted --key value pairs "
                    "override any TrainConfig field.")
    parser.add_argument("--config", default=None,
                        help="YAML config (reference train_config.yaml "
                             "compatible; needs pyyaml)")
    parser.add_argument("--num-epochs", type=int, default=None,
                        dest="num_epochs_cli")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain PyTorch path, and a mesh of several "
                             "ranks under gloo)")
    args, overrides = parser.parse_known_args(argv)

    from vfi_tpu_torch.cli.common import free_port
    from vfi_tpu_torch.utils.config import load_train_config

    cfg = load_train_config(args.config, overrides)
    if args.num_epochs_cli is not None:
        cfg = dataclasses.replace(cfg, num_epochs=args.num_epochs_cli)

    world = ranks_for(cfg, args.device)
    if world > 1:
        import torch.multiprocessing as mp

        mp.spawn(_rank, args=(world, free_port(), cfg, args.device),
                 nprocs=world, join=True)
        return 0

    from vfi_tpu_torch.train.loop import Trainer

    _report(Trainer(cfg, device=args.device).run())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
