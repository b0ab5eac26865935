"""Core geometry: segments, cameras, linkers, infinite lines, tracks."""
