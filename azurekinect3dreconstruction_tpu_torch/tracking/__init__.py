"""Camera tracking."""
