"""The 7scenes dataset's readers and runners, each a CLI run as
``python -m limap_tpu_torch.runners.7scenes.<name>``."""
