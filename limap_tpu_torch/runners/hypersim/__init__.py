"""The Hypersim dataset: its loader and the triangulation, fit-and-merge
and joint SfM refinement commands, each run as
``python -m limap_tpu_torch.runners.hypersim.<name>``."""
