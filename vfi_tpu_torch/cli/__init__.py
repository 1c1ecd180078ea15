"""Command-line entry points of the port:
`python -m vfi_tpu_torch.cli.eval`."""
