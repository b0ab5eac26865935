"""The rome16k dataset's readers and runners, each a CLI run as
``python -m limap_tpu_torch.runners.rome16k.<name>``."""
