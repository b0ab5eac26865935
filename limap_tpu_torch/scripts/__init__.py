"""Command-line tools of the port, run as
``python -m limap_tpu_torch.scripts.<name>``."""
