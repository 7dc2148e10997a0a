"""Multi-device fusion: the (cam x blk) sharded TSDF volume."""
