"""Command-line tools of the port (run as ``python -m repro_torch.tools.<name>``)."""
