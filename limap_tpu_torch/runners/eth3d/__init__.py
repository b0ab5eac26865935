"""The eth3d dataset's readers and runners, each a CLI run as
``python -m limap_tpu_torch.runners.eth3d.<name>``."""
