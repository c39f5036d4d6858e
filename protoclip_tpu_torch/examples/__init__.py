"""Self-contained quickstarts of the port
(``python -m protoclip_tpu_torch.examples.<name>``)."""
