"""Command-line entry points of the port (``python -m
protoclip_tpu_torch.cli.<name>``)."""
