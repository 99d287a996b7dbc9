"""Preprocessing helpers of the port (the subset the ported slices use)."""
