"""Multi-device TSDF fusion: cameras x block shards over a grid of devices
(the counterpart of the JAX package's ``parallel/sharded_volume.py``).

The JAX module runs one SPMD program over a ``jax.sharding.Mesh`` with two
axes: ``cam`` (each camera's frame on its own mesh row) and ``blk`` (each
column owns an independent sub-volume holding the block keys that hash to
it, so the pools never overlap and extraction is a disjoint union). Here
one Python process holds tensors on an ``(n_cam, n_blk)`` grid of devices
and copies between them explicitly:

- camera ``c`` is decoded and tracked on ``mesh[c, 0]``;
- shard ``b`` is one ordinary :class:`tsdf.volume.TSDFVolume` on
  ``mesh[0, b]``. The cam rows of a blk column hold identical replicas in
  JAX by construction; a single controller keeps one copy, which gives the
  same numbers with 1/n_cam of the memory and of the B1 launches;
- allocation dedups each camera's candidate keys on its own device, then
  every shard takes all cameras' key sets in cam order (JAX's
  ``all_gather`` over ``cam``), keeps the keys it owns (:func:`owner`) and
  inserts them; then it integrates every camera's frame in cam order with
  the worklist integrate (B1 on the card, its plain version on the CPU).

A grid may name one device more than once (the counterpart of XLA's
virtual CPU devices): the copies between its entries are then no-ops.
Between two distinct cards a copy is ``.to(device, non_blocking=True)`` on
the current streams, which PyTorch orders after the producer's stream; no
step synchronizes. The pools update in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.device import full_fp32_matmul, resolve_device
from azurekinect3dreconstruction_tpu_torch.core.types import decode_raw_frame
from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import integrate_worklist
from azurekinect3dreconstruction_tpu_torch.tsdf import hash as vhash
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf_volume
from azurekinect3dreconstruction_tpu_torch.tsdf.volume import TSDFVolume

# the owner hash's salt, 0x9E3779B9 wrapped to int32 as the JAX package holds it
_OWNER_SALT = 0x9E3779B9 - (1 << 32)


class DeviceMesh:
    """An ``(n_cam, n_blk)`` grid of ``torch.device``s; entries may repeat."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid = tuple(tuple(row) for row in grid)

    @property
    def shape(self) -> dict:
        return {"cam": len(self.grid), "blk": len(self.grid[0])}

    def __getitem__(self, idx) -> torch.device:
        c, b = idx
        return self.grid[c][b]

    def cam_device(self, c: int) -> torch.device:
        """Where camera ``c`` is decoded and tracked."""
        return self.grid[c][0]

    def blk_device(self, b: int) -> torch.device:
        """Where shard ``b`` lives."""
        return self.grid[0][b]

    def __repr__(self) -> str:
        return f"DeviceMesh(cam={len(self.grid)} x blk={len(self.grid[0])}: {self.grid})"


def _named(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that grid entries compare equal to
    the devices of the tensors placed on them."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_cam: int, n_blk: int, devices=None) -> DeviceMesh:
    """The grid of the first ``n_cam * n_blk`` of ``devices`` (default:
    every visible card), row by row. Raises ``ValueError`` when there are
    fewer (``RuntimeError`` for a CUDA device without a card)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [_named(resolve_device(d)) for d in devices]
    if len(devs) < n_cam * n_blk:
        raise ValueError(f"not enough devices for a {n_cam} x {n_blk} mesh: {len(devs)}")
    return DeviceMesh([devs[c * n_blk:(c + 1) * n_blk] for c in range(n_cam)])


class ShardedTSDF(NamedTuple):
    """One independent :class:`TSDFVolume` per blk shard, shard ``b`` on
    ``mesh[0, b]``, each of ``block_capacity`` blocks and ``hash_capacity``
    slots."""

    shards: Tuple[TSDFVolume, ...]

    @property
    def n_blocks(self) -> torch.Tensor:
        """int32 ``(n_blk,)`` on shard 0's device."""
        dev = self.shards[0].n_blocks.device
        return torch.stack([_to(s.n_blocks, dev) for s in self.shards])

    @property
    def overflow(self) -> torch.Tensor:
        """bool ``(n_blk,)`` on shard 0's device: each shard's sticky flag."""
        dev = self.shards[0].overflow.device
        return torch.stack([_to(s.overflow, dev) for s in self.shards])


def _to(t, dev: torch.device):
    """``t`` on ``dev``; the tensor itself when it is there already. The
    copy waits only where it lands on the CPU, which the host may read at
    once."""
    return t.to(dev, non_blocking=dev.type != "cpu")


def owner(keys, n_shards: int):
    """Which blk shard owns each packed block key (int32): the salted
    ``fmix32`` of the key modulo ``n_shards``, equal to the JAX package's
    ``_owner`` to the bit (``EMPTY_KEY`` included)."""
    h = vhash._mix(keys.to(torch.int32) ^ _OWNER_SALT)
    return (h % n_shards).to(torch.int32)


def create_sharded(cfg: TSDFConfig, mesh: DeviceMesh) -> ShardedTSDF:
    """Empty shards, shard ``b`` on ``mesh[0, b]``."""
    return ShardedTSDF(tuple(tsdf_volume.create(cfg, mesh.blk_device(b))
                             for b in range(mesh.shape["blk"])))


def alloc_shard(shard: TSDFVolume, cam_keys, b: int, n_blk: int, cfg: TSDFConfig) -> TSDFVolume:
    """Insert into shard ``b`` the keys it owns out of every camera's
    deduplicated key set (``cam_keys``, in cam order, each from
    :func:`tsdf.volume.candidate_keys` on its camera's device), in 8 probe
    rounds. Keys past a camera's dedup budget are dropped and allocated by
    a later frame, as in the flat ``allocate``."""
    dev = shard.tsdf.device
    keys = torch.cat([_to(k, dev) for k in cam_keys])
    mine = (owner(keys, n_blk) == b) & (keys != vhash.EMPTY_KEY)
    return tsdf_volume.insert_keys(shard, torch.where(mine, keys, vhash.EMPTY_KEY), cfg,
                                   max_probes=8)


def integrate_seq(shard: TSDFVolume, depths, colors, poses, intr: Intrinsics, cfg: TSDFConfig,
                  worklist_size: Optional[int]) -> TSDFVolume:
    """Integrate every camera's frame into ``shard``, in cam order, with
    the worklist integrate (B1 on the card, its plain version on the CPU).
    Sequential weighted-average fusion equals JAX's psum form while weights
    stay below ``max_integration_weight``. The worklist is the shard's whole
    pool when ``worklist_size`` is None; a frame with more visible blocks
    than an explicit ``worklist_size`` sets the shard's sticky ``overflow``."""
    dev = shard.tsdf.device
    for d, c, T in zip(depths, colors, poses):
        shard = integrate_worklist(shard, _to(d, dev), _to(c, dev), _to(T, dev), intr, cfg,
                                   worklist_size)
    return shard


def fuse_cam_shard(shard: TSDFVolume, b: int, cam_keys, depths, colors, poses,
                   intr: Intrinsics, cfg: TSDFConfig, n_blk: int,
                   worklist_size: Optional[int]) -> TSDFVolume:
    """:func:`alloc_shard` then :func:`integrate_seq`: shard ``b``'s part of
    one sharded step."""
    shard = alloc_shard(shard, cam_keys, b, n_blk, cfg)
    return integrate_seq(shard, depths, colors, poses, intr, cfg, worklist_size)


def _make_fuse(mesh: DeviceMesh, intr: Intrinsics, cfg: TSDFConfig, stride: int, samples: int,
               dedup_budget: int, worklist_size: Optional[int]):
    """fuse(vol, depths, colors, poses, rays) -> vol, each per-camera list
    on its camera's device: every camera's keys, then every shard."""
    n_cam, n_blk = mesh.shape["cam"], mesh.shape["blk"]

    def fuse(vol: ShardedTSDF, depths, colors, poses, rays) -> ShardedTSDF:
        keys = [tsdf_volume.candidate_keys(depths[c], _to(rays, mesh.cam_device(c)), poses[c],
                                           cfg, stride, samples, dedup_budget)
                for c in range(n_cam)]
        return ShardedTSDF(tuple(
            fuse_cam_shard(s, b, keys, depths, colors, poses, intr, cfg, n_blk, worklist_size)
            for b, s in enumerate(vol.shards)))

    return fuse


def _per_cam(mesh: DeviceMesh, batch, dtype=None):
    """``batch[c]`` on camera ``c``'s device, for every camera (``batch`` a
    tensor with a leading cam axis or a sequence of per-camera tensors)."""
    out = [_to(batch[c], mesh.cam_device(c)) for c in range(mesh.shape["cam"])]
    return out if dtype is None else [t.to(dtype) for t in out]


def make_sharded_step(mesh: DeviceMesh, intr: Intrinsics, cfg: TSDFConfig, stride: int = 4,
                      samples: int = 3, dedup_budget: int = 2048,
                      worklist_size: Optional[int] = None):
    """The multi-camera fusion step:

    step(vol, depths (n_cam, H, W), colors (n_cam, H, W, 3),
         poses (n_cam, 4, 4), rays (H, W, 2)) -> vol

    Every shard allocates from every camera's candidate keys, then
    integrates every camera's frame (B1 ``n_cam x n_blk`` times a step on
    the card). A per-camera argument may also be a sequence of tensors.
    The pools update in place; nothing waits on the host."""
    fuse = _make_fuse(mesh, intr, cfg, stride, samples, dedup_budget, worklist_size)

    def step(vol: ShardedTSDF, depths, colors, poses, rays) -> ShardedTSDF:
        with full_fp32_matmul():
            return fuse(vol, _per_cam(mesh, depths), _per_cam(mesh, colors),
                        _per_cam(mesh, poses, torch.float32), rays)

    return step


def make_sharded_raw_step(mesh: DeviceMesh, intr: Intrinsics, cfg: TSDFConfig, stride: int = 4,
                          samples: int = 3, dedup_budget: int = 2048,
                          worklist_size: Optional[int] = None):
    """The sharded fusion step fed raw sensor arrays (the two-camera hot
    path of ``DualCameraFusion(sharded=True)``):

    step(vol, depth_raw (n_cam, H, W) u16, color_raw (n_cam, H, W, 3) u8,
         poses (n_cam, 4, 4), rays, cam_on (n_cam,) f32,
         inv_scale, depth_min, depth_trunc) -> vol

    Each camera's frame is decoded on its row's device
    (``core.types.decode_raw_frame``); ``cam_on[i] = 0`` zeroes camera
    ``i``'s decoded depth, so it neither allocates nor integrates. The
    decode scalars are arguments of the call, so retuning them changes no
    step. A per-camera argument may also be a sequence of tensors."""
    fuse = _make_fuse(mesh, intr, cfg, stride, samples, dedup_budget, worklist_size)

    def step(vol: ShardedTSDF, depth_raw, color_raw, poses, rays, cam_on, inv_scale, depth_min,
             depth_trunc) -> ShardedTSDF:
        with full_fp32_matmul():
            on = _per_cam(mesh, torch.as_tensor(cam_on, dtype=torch.float32))
            frames = [decode_raw_frame(d, c, inv_scale, depth_min, depth_trunc)
                      for d, c in zip(_per_cam(mesh, depth_raw), _per_cam(mesh, color_raw))]
            return fuse(vol, [f[0] * o for f, o in zip(frames, on)], [f[1] for f in frames],
                        _per_cam(mesh, poses, torch.float32), rays)

    return step


def make_sharded_slam_batch(mesh: DeviceMesh, intr: Intrinsics, pcfg, stride: int = 4,
                            samples: int = 3, dedup_budget: int = 2048,
                            min_fitness: float = 0.3, worklist_size: Optional[int] = None):
    """Multi-camera SLAM over a frame batch: every camera tracks its own
    stream on its row's device while fusion stays block-sharded.

    batch(vol, T0 (n_cam, 4, 4), intensities (n_cam, F, H, W),
          depths (n_cam, F, H, W), colors (n_cam, F, H, W, 3), rays)
        -> (vol, poses (n_cam, F-1, 4, 4), fits (n_cam, F-1))

    Frame 0 of each stream is the tracking reference at ``T0[cam]``; each
    later frame is tracked against its predecessor by the pipelines'
    ``track_frame``: ``compute_odometry_fast`` (B2 once a camera a tracked
    frame on the card), gated by ``apply_odometry_gate`` (identity motion
    and fitness -1 where it rejects). Then every camera's frame is fused
    into every shard (B1 ``n_cam x n_blk`` times a frame). A Python loop over frames
    with no host synchronization; poses and fits are returned on camera
    0's device."""
    # the pipeline layer's tracking body, imported here so that this layer
    # does not load the pipelines
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import track_frame

    fuse = _make_fuse(mesh, intr, pcfg.tsdf, stride, samples, dedup_budget, worklist_size)
    n_cam = mesh.shape["cam"]

    def batch(vol: ShardedTSDF, T0, intensities, depths, colors, rays):
        with full_fp32_matmul():
            T = _per_cam(mesh, T0, torch.float32)
            inten, dep, col = (_per_cam(mesh, a) for a in (intensities, depths, colors))
            poses, fits = [[] for _ in range(n_cam)], [[] for _ in range(n_cam)]
            for f in range(1, dep[0].shape[0]):
                for c in range(n_cam):
                    T[c], fit = track_frame(T[c], inten[c][f - 1], dep[c][f - 1], inten[c][f],
                                            dep[c][f], intr, pcfg.odometry, min_fitness)
                    poses[c].append(T[c])
                    fits[c].append(fit)
                vol = fuse(vol, [d[f] for d in dep], [c_[f] for c_ in col], T, rays)
            dev0 = mesh.cam_device(0)
            return (vol, torch.stack([_to(torch.stack(p), dev0) for p in poses]),
                    torch.stack([_to(torch.stack(f), dev0) for f in fits]))

    return batch


def combine_shards(vol: ShardedTSDF, cfg: TSDFConfig, n_blk: int) -> TSDFVolume:
    """Merge the disjoint shards into ONE :class:`TSDFVolume` on shard 0's
    device, for extraction: a cell on a shard boundary needs
    its neighbors from other shards, so the combined volume triangulates it
    as a single volume holding the same blocks would.

    The alive prefix of each shard is taken in shard order (one read of the
    block counts), the pool padded to ``block_capacity * n_blk`` rows, and
    the hash built with ``hash.build_table`` at the next power of two >=
    ``hash_capacity * n_blk``. Raises ``RuntimeError`` when the table cannot
    place a key."""
    if len(vol.shards) != n_blk:
        raise ValueError(f"{len(vol.shards)} shards, not {n_blk}")
    dev = vol.shards[0].tsdf.device
    nb = [int(n) for n in vol.n_blocks.cpu()]
    total, N = sum(nb), cfg.block_capacity * n_blk

    def pool(field):
        parts = [_to(getattr(s, field)[:n], dev) for s, n in zip(vol.shards, nb)]
        first = parts[0]
        pad = first.new_zeros((N - total,) + tuple(first.shape[1:]))
        return torch.cat(parts + [pad])

    coords = pool("block_coords")
    keys = torch.full((N,), vhash.EMPTY_KEY, dtype=torch.int32, device=dev)
    keys[:total] = vhash.pack_key(coords[:total])
    cap = 1 << (cfg.hash_capacity * n_blk - 1).bit_length()
    table, ok = vhash.build_table(keys, torch.arange(N, dtype=torch.int32, device=dev),
                                  capacity=cap)
    if not bool(ok):
        raise RuntimeError(f"combine_shards: the {cap}-slot hash table failed to place every one "
                           f"of {total} keys")
    return TSDFVolume(
        table_keys=table.keys, table_vals=table.vals,
        n_blocks=torch.tensor(total, dtype=torch.int32, device=dev),
        block_coords=coords, tsdf=pool("tsdf"), weight=pool("weight"), color=pool("color"),
        overflow=_to(vol.overflow.any(), dev))


def gather_volume(vol: ShardedTSDF, cfg: TSDFConfig, shard: int, n_blk: int) -> TSDFVolume:
    """Shard ``shard`` as an ordinary :class:`TSDFVolume`: a copy, so later
    steps (which update the pools in place) do not change it."""
    if len(vol.shards) != n_blk:
        raise ValueError(f"{len(vol.shards)} shards, not {n_blk}")
    s = vol.shards[shard]
    return s._replace(**{k: t.clone() for k, t in s._asdict().items()})
