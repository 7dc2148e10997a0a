"""Block-hashed TSDF volume resident in device memory.

A fixed-capacity pool of ``block_resolution``^3 voxel blocks plus the
open-addressing hash of :mod:`.hash`. Integration has two phases:

1. **allocate**: backproject a strided pixel grid, sample a few points along
   each ray inside the truncation band, quantize to block coords, dedup, and
   insert-or-get them in the hash.
2. **update**: for each block, project its R^3 voxel centers into the depth
   image and fuse (running weighted average, truncation band, weight clamp).

The state is a ``NamedTuple`` of tensors. The voxel pools are stored flat as
``(capacity, R^3)`` (color ``(capacity, 3, R^3)``, channel-major) and are
**updated in place** by :func:`integrate`, :func:`integrate_frame` and the
worklist integrate of ``ops.kernels.tsdf_kernels``; the small hash and
bookkeeping tensors are replaced. The last pool row is reserved as the
worklist's trash slot and never allocated.

Pose convention: every function takes **camera-to-world** poses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.fmath import fma, rcp32
from azurekinect3dreconstruction_tpu_torch.tsdf import hash as vhash


class TSDFVolume(NamedTuple):
    """The complete volume state (fixed-shape tensors on one device)."""

    table_keys: torch.Tensor  # int32[hash_capacity]
    table_vals: torch.Tensor  # int32[hash_capacity]
    n_blocks: torch.Tensor  # int32[] allocated block count
    block_coords: torch.Tensor  # int32[capacity, 3] grid coords of each block
    tsdf: torch.Tensor  # f32[capacity, R^3] normalized sdf in [-1, 1]
    weight: torch.Tensor  # f32[capacity, R^3]
    color: torch.Tensor  # f32[capacity, 3, R^3] channel-major
    overflow: torch.Tensor  # bool[] sticky pool-exhausted flag

    @property
    def table(self) -> vhash.HashTable:
        return vhash.HashTable(self.table_keys, self.table_vals)


def create(cfg: TSDFConfig, device) -> TSDFVolume:
    """Fresh, empty volume on ``device``."""
    n = cfg.block_capacity
    r3 = cfg.block_resolution ** 3
    t = vhash.HashTable.empty(cfg.hash_capacity, device)
    return TSDFVolume(
        table_keys=t.keys,
        table_vals=t.vals,
        n_blocks=torch.zeros((), dtype=torch.int32, device=device),
        block_coords=torch.zeros((n, 3), dtype=torch.int32, device=device),
        tsdf=torch.zeros((n, r3), dtype=torch.float32, device=device),
        weight=torch.zeros((n, r3), dtype=torch.float32, device=device),
        color=torch.zeros((n, 3, r3), dtype=torch.float32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def reset(cfg: TSDFConfig, device) -> TSDFVolume:
    return create(cfg, device)


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------


def allocate(vol: TSDFVolume, depth, rays, T_world_cam, cfg: TSDFConfig,
             stride: int = 2, samples: int = 3, dedup_budget: int = 2048) -> TSDFVolume:
    """Ensure blocks exist along every ray's truncation band.

    depth: (H, W) meters (0 = invalid); rays: (H, W, 2) from pixel_rays.
    Candidate keys are sorted and deduplicated to at most ``dedup_budget``
    unique keys before the insert. Keys past the budget are simply allocated
    by a later frame (surfaces are seen by many pixels over many frames), so
    that does not set the sticky ``overflow`` flag; a full pool does.
    """
    d = depth[::stride, ::stride]
    r = rays[::stride, ::stride]
    T = T_world_cam.to(torch.float32)
    dev = d.device

    valid = d > 0.0
    # camera-space surface points p = (xn*z, yn*z, z); band samples scale p
    # radially so they stay on the pixel ray
    p = torch.cat([r * d[..., None], d[..., None]], dim=-1)
    offs = torch.linspace(-cfg.sdf_trunc, cfg.sdf_trunc, samples, dtype=torch.float32,
                          device=dev)
    scale = 1.0 + offs[:, None, None] / torch.clamp_min(d, 1e-6)[None]  # (S, h, w)
    pts = p[None] * scale[..., None]  # (S, h, w, 3)
    world = se3.transform_points(T, pts.reshape(-1, 3))
    # world / block_size, rounded as the reference's compiled division by a constant
    keys = vhash.pack_key(torch.floor(world * rcp32(cfg.block_size)).to(torch.int32))
    keys = torch.where(valid.reshape(-1).repeat(samples), keys, vhash.EMPTY_KEY)

    # dedup: sort (EMPTY = -1 sorts first), keep the first of each run
    skeys = torch.sort(keys).values
    first = torch.cat([skeys[:1] != vhash.EMPTY_KEY,
                       (skeys[1:] != skeys[:-1]) & (skeys[1:] != vhash.EMPTY_KEY)])
    order = torch.cumsum(first.to(torch.int32), 0) - 1
    dst = torch.where(first & (order < dedup_budget), order, dedup_budget).to(torch.int64)
    ukeys = torch.full((dedup_budget + 1,), vhash.EMPTY_KEY, dtype=torch.int32,
                       device=dev).scatter_(0, dst, skeys)[:dedup_budget]

    # the last pool row is reserved as the worklist's trash slot; 6 probe
    # rounds suffice at the load factors the config enforces (unresolved
    # keys retry on the next frame)
    table, counter, vals, overflowed = vhash.insert(
        vol.table, vol.n_blocks, ukeys, cfg.block_capacity - 1, max_probes=6)
    # record coords of (possibly fresh) slots; a MISS lands in the extra row
    n = cfg.block_capacity
    idx = torch.where(vals >= 0, vals, n).to(torch.int64)
    block_coords = torch.cat([vol.block_coords, vol.block_coords.new_zeros((1, 3))])
    block_coords[idx] = vhash.unpack_key(ukeys)
    return vol._replace(
        table_keys=table.keys,
        table_vals=table.vals,
        n_blocks=counter,
        block_coords=block_coords[:n],
        overflow=vol.overflow | overflowed,
    )


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------


def voxel_world_centers(block_coords, cfg: TSDFConfig):
    """(N, 3) block coords -> (N, R^3, 3) world-space voxel centers,
    ((bc*R + ijk) + 0.5) * voxel with voxel index lin = x*R^2 + y*R + z."""
    R = cfg.block_resolution
    lin = torch.arange(R ** 3, device=block_coords.device)
    ijk = torch.stack([lin // (R * R), (lin // R) % R, lin % R], dim=-1).to(torch.int32)
    vox = block_coords[:, None, :] * R + ijk[None]
    return (vox.to(torch.float32) + 0.5) * cfg.voxel_size


def fuse_blocks(vol: TSDFVolume, slots, coords, active, depth, color, T_cam_world,
                intr: Intrinsics, cfg: TSDFConfig) -> None:
    """The per-voxel update of pool rows ``slots`` (int64 (M,)) whose block
    coords are ``coords`` ((M, 3) int32), for rows where ``active`` is set;
    writes the pool tensors of ``vol`` in place.

    For each voxel center: camera coords via ``T_cam_world``, nearest pixel
    by round-half-to-even of ``fma(x / max(z, 1e-6), f, c)``, depth and
    color sampled there; where the pixel is in the image, ``z > 1e-4``,
    depth > 0 and ``sdf = d - z > -trunc``: tsdf and color take the running
    weighted average with ``min(sdf / trunc, 1)`` and weight becomes
    ``min(w + 1, max_weight)``. Multiply-adds are fused, and ``/ trunc`` is
    a multiply by the float32 reciprocal, exactly where the JAX package's
    compiled integrate does so (see ``core.fmath``): the two agree to the
    bit. This is the plain version of the CUDA kernel
    ``csrc/tsdf_integrate.cu``."""
    pts_c = se3.transform_points(T_cam_world, voxel_world_centers(coords, cfg))
    z = pts_c[..., 2]
    safe_z = torch.clamp_min(z, 1e-6)
    u = torch.round(fma(pts_c[..., 0] / safe_z, intr.fx, intr.cx))
    v = torch.round(fma(pts_c[..., 1] / safe_z, intr.fy, intr.cy))
    inb = (z > 1e-4) & (u >= 0) & (v >= 0) & (u < intr.width) & (v < intr.height)
    pix = (torch.clamp(v, 0, intr.height - 1).to(torch.int64) * intr.width
           + torch.clamp(u, 0, intr.width - 1).to(torch.int64))

    d = depth.reshape(-1)[pix]  # (M, V) gather
    sdf = d - z
    upd = inb & (d > 0.0) & (sdf > -cfg.sdf_trunc) & active[:, None]

    tsdf_obs = torch.clamp_max(sdf * rcp32(cfg.sdf_trunc), 1.0)
    w_old = vol.weight[slots]
    inv = 1.0 / torch.clamp_min(w_old + 1.0, 1.0)
    t_old = vol.tsdf[slots]
    t_new = torch.where(upd, fma(t_old, w_old, tsdf_obs) * inv, t_old)
    w_new = torch.where(upd, torch.clamp_max(w_old + 1.0, cfg.max_integration_weight), w_old)
    c = color.reshape(-1, 3)[pix].permute(0, 2, 1)  # (M, 3, V) channel-major
    c_old = vol.color[slots]
    c_new = torch.where(upd[:, None], fma(c_old, w_old[:, None], c) * inv[:, None], c_old)
    vol.tsdf[slots] = t_new
    vol.weight[slots] = w_new
    vol.color[slots] = c_new


def integrate(vol: TSDFVolume, depth, color, T_world_cam, intr: Intrinsics,
              cfg: TSDFConfig) -> TSDFVolume:
    """Fuse one registered RGB-D frame into every allocated block (update
    phase only — call :func:`allocate` first). The plain reference of the
    worklist integrate; updates the pools in place and returns ``vol``.

    depth: (H, W) f32 meters; color: (H, W, 3) f32 in [0,1];
    T_world_cam: camera-to-world.
    """
    n = vol.tsdf.shape[0]
    slots = torch.arange(n, device=vol.tsdf.device)
    fuse_blocks(vol, slots, vol.block_coords, slots < vol.n_blocks, depth, color,
                se3.inverse(T_world_cam.to(torch.float32)), intr, cfg)
    return vol


def integrate_frame(vol: TSDFVolume, depth, color, rays, T_world_cam,
                    intr: Intrinsics, cfg: TSDFConfig, stride: int = 2) -> TSDFVolume:
    """allocate + worklist integrate in one call (the first frame's path).

    The worklist spans the whole pool, so no visible block is left out and
    nothing waits on the host; on CUDA tensors this runs the kernel."""
    from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import (
        integrate_worklist,
    )

    vol = allocate(vol, depth, rays, T_world_cam, cfg, stride=stride)
    return integrate_worklist(vol, depth, color, T_world_cam, intr, cfg)


# ---------------------------------------------------------------------------
# queries / extraction helpers
# ---------------------------------------------------------------------------


def extract_point_cloud(vol: TSDFVolume, cfg: TSDFConfig, max_points: Optional[int] = None):
    """Surface points by zero-crossing interpolation along +x/+y/+z within
    each block. Returns a host-side compacted (points, colors) numpy pair."""
    n = int(vol.n_blocks)
    if n == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    R = cfg.block_resolution
    tsdf = vol.tsdf[:n].cpu().numpy().reshape(n, R, R, R)
    weight = vol.weight[:n].cpu().numpy().reshape(n, R, R, R)
    color = vol.color[:n].cpu().numpy().transpose(0, 2, 1).reshape(n, R, R, R, 3)
    coords = vol.block_coords[:n].cpu().numpy()
    pts, cols = host_interior_crossings(tsdf, weight, color, coords, cfg)
    if max_points is not None and pts.shape[0] > max_points:
        sel = np.random.RandomState(0).choice(pts.shape[0], max_points, replace=False)
        pts, cols = pts[sel], cols[sel]
    return pts, cols


def host_interior_crossings(tsdf, weight, color, coords, cfg: TSDFConfig):
    """The numpy crossing math behind :func:`extract_point_cloud`, on
    per-block host arrays. tsdf/weight: (n, R, R, R); color: (n, R, R, R, 3);
    coords: (n, 3)."""
    R = cfg.block_resolution
    pts_out = []
    col_out = []
    for axis in range(3):
        sl_a = [slice(None), slice(0, R - 1), slice(None), slice(None)]
        sl_b = [slice(None), slice(0, R - 1), slice(None), slice(None)]
        sl_b[axis + 1] = slice(1, R)
        sl_a[axis + 1] = slice(0, R - 1)
        t0 = tsdf[tuple(sl_a)]
        t1 = tsdf[tuple(sl_b)]
        w0 = weight[tuple(sl_a)]
        w1 = weight[tuple(sl_b)]
        cross = (w0 > 0) & (w1 > 0) & (np.sign(t0) != np.sign(t1)) & (t0 != 0)
        bi, xi, yi, zi = np.nonzero(cross)
        if bi.size == 0:
            continue
        base = coords[bi] * R + np.stack([xi, yi, zi], axis=-1)
        frac = t0[bi, xi, yi, zi] / (t0[bi, xi, yi, zi] - t1[bi, xi, yi, zi])
        p = (base + 0.5).astype(np.float32)
        p[:, axis] += frac
        pts_out.append(p * cfg.voxel_size)
        c0 = color[tuple(sl_a)][bi, xi, yi, zi]
        c1 = color[tuple(sl_b)][bi, xi, yi, zi]
        col_out.append(c0 * (1 - frac[:, None]) + c1 * frac[:, None])

    if not pts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    return np.concatenate(pts_out), np.concatenate(col_out)


def memory_bytes(cfg: TSDFConfig) -> int:
    """Device footprint of a volume with this config."""
    n, r3 = cfg.block_capacity, cfg.block_resolution ** 3
    return n * r3 * 4 * (1 + 1 + 3) + cfg.hash_capacity * 8 + n * 12
