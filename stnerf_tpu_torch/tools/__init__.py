"""Command-line entry points of the port (``python -m stnerf_tpu_torch.tools.<name>``)."""
