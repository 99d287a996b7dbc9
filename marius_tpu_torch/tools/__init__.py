"""Host-side tools of the port (the subset the ported slices use)."""
