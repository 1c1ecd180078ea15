"""`python -m vfi_tpu_torch.cli.train` — train EMAVFI with the port, the
counterpart of `vfi_tpu/cli/train.py`: `--config` (a YAML file; needs
pyyaml), `--num-epochs`, and any TrainConfig field as `--key value`
(nested: `--color_jitter.hue 0.3`), plus `--device` (default `cuda`; the
CPU runs only when asked)."""

from __future__ import annotations

import argparse
import dataclasses


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
                             "plain PyTorch path)")
    args, overrides = parser.parse_known_args(argv)

    from vfi_tpu_torch.utils.config import load_train_config

    cfg = load_train_config(args.config, overrides)
    if args.num_epochs_cli is not None:
        cfg = dataclasses.replace(cfg, num_epochs=args.num_epochs_cli)

    from vfi_tpu_torch.train.loop import Trainer

    history = Trainer(cfg, device=args.device).run()
    if history["val_loss"]:
        print(f"done: best val loss {min(history['val_loss']):.4f}, "
              f"best PSNR {max(history['psnr']):.2f} dB, "
              f"final PSNR {history['psnr'][-1]:.2f} dB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
