"""Batched Levenberg-Marquardt and line bundle adjustment."""
