"""Command-line scripts of the port (``python -m protoclip_tpu_torch.scripts.<name>``)."""
