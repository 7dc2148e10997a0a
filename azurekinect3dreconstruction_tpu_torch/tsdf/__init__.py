"""Block-hashed TSDF volume, its spatial hash, and host streaming."""

from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF

__all__ = ["StreamingTSDF"]
