"""Command-line tools of the port (``python -m innfer_tpu_torch.tools.<name>``)."""
