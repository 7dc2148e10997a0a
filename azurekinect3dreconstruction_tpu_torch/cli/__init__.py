"""Command-line entry points of the port, run as
``python -m azurekinect3dreconstruction_tpu_torch.cli.<name>``."""
