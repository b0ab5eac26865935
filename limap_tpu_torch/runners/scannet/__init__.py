"""The scannet dataset's readers and runners, each a CLI run as
``python -m limap_tpu_torch.runners.scannet.<name>``."""
