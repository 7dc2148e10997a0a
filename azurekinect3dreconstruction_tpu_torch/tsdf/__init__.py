"""Block-hashed TSDF volume and its spatial hash."""
