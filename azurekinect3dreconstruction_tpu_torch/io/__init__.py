"""Frame sources (the synthetic renderer)."""
