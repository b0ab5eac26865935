"""Track aggregation and the batch filter / remerge chain."""
