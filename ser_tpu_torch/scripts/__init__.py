"""Command-line tools of the port (``python -m ser_tpu_torch.scripts.<name>``)."""
