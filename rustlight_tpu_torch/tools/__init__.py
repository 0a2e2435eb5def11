"""Command-line tools of the port (run as `python -m rustlight_tpu_torch.tools...`)."""
