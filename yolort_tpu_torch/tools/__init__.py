"""Command-line entry points of the port (``python -m yolort_tpu_torch.tools.<name>``)."""
