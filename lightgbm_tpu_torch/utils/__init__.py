"""Utility layer (logging, reference-order reductions)."""
