"""Graph ops, host bucketing and the hand-written CUDA kernels."""
