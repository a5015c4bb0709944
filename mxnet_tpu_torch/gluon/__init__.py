"""Model side of the port (``torch.nn`` modules)."""
