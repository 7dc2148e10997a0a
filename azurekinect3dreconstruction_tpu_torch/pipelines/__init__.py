"""End-to-end pipelines."""
