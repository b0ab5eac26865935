"""The Hypersim dataset: its loader (the runners come with the CLIs)."""
