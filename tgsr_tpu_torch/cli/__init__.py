"""Command-line entry points of the port (`python -m tgsr_tpu_torch.cli.serve`)."""
