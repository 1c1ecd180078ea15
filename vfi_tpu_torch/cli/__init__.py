"""Command-line entry points of the port:
`python -m vfi_tpu_torch.cli.eval`, `python -m vfi_tpu_torch.cli.serve`
and `python -m vfi_tpu_torch.cli.infer`."""
