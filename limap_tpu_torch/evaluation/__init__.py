"""Evaluation of line maps against ground truth."""
