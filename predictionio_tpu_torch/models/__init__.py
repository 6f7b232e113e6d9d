"""Factor models of the port (the serving half of ALS in this slice)."""
