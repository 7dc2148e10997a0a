"""Core: SE(3), camera model, frame container, device selection."""
