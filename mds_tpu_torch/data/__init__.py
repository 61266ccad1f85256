"""Dataset metadata of the port (label specs)."""
