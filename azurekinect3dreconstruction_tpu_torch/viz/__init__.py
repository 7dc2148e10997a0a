"""Geometry persistence (PLY/OBJ writers and readers)."""
