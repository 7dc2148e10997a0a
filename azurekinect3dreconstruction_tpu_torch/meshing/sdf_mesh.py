"""Cloud -> mesh by oriented-point SDF splatting and marching cubes (the
counterpart of the JAX package's ``meshing/sdf_mesh.py``).

A narrow-band signed-distance field is built by splatting oriented points
into the block-pool volume, then meshed by the port's marching cubes. For
each point p with unit normal n, every voxel center c in its
(2*reach+1)^3 neighborhood accumulates

    w = exp(-|c - p|^2 / (2 sigma^2)),   d = (c - p) . n

and the voxel's signed distance is the weighted mean sum(w d) / sum(w), the
local tangent-plane fit, clamped to the truncation band. Like Poisson it
needs oriented normals; unlike Poisson it makes no surface far from the
data. Every step is a fixed-shape hash insert or lookup, an elementwise
weight, or a scatter-add (``index_add_``): plain PyTorch, as the JAX
package's is plain XLA. On CUDA the scatter-adds are atomics in no fixed
order, so a card's splat differs from the CPU's in the last bits of the sums.

Rounding follows the compiled reference (``core.fmath``): ``points /
voxel`` divides by a static constant, so it is a multiply by the float32
reciprocal; ``sigma`` and ``trunc`` are run-time scalars there, so their
divisions are true ones; ``center - p`` and the 3-term dot products are
fused multiply-adds;
``exp`` is XLA's (``fmath.exp32``). On the CPU the splat so equals the JAX
package's to the bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.core.fmath import dot3, exp32, fma, rcp32
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost, TriangleMeshHost
from azurekinect3dreconstruction_tpu_torch.tsdf import hash as vhash
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf_volume
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning

_CORNERS = np.array([[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], np.int32)


def splat_cloud(pts, nrm, cols, mask, cfg: TSDFConfig, sigma, trunc, reach: int = 1,
                dedup_budget: int = 16384) -> tsdf_volume.TSDFVolume:
    """A narrow-band SDF volume from an oriented cloud, on the cloud's device.

    pts / nrm / cols: (P, 3) f32 (cols in [0, 1]; zeros if uncolored);
    mask: (P,) bool; sigma, trunc: f32 0-d tensors. Blocks are allocated for
    the 8 corners of each point's splat box (sorted and deduplicated to at
    most ``dedup_budget`` keys; a full pool sets ``overflow``), then 27
    scatter-add passes accumulate w, w*d and w*color over the flat pools.
    Where the summed weight exceeds 1e-6 the voxel holds the clamped
    ``sum(w d) / sum(w) / trunc`` and the weight; elsewhere both are 0."""
    dev = pts.device
    vol = tsdf_volume.create(cfg, dev)
    R = cfg.block_resolution
    N, V = cfg.block_capacity, R ** 3
    pts = pts.to(torch.float32)
    idx0 = torch.floor(pts * rcp32(cfg.voxel_size)).to(torch.int32)  # (P, 3) voxel index

    # -- allocation: the blocks under each splat box's 8 corners ------------------
    lo = idx0 - reach
    hi = lo + 2 * reach  # the box's inclusive far corner
    corners = torch.from_numpy(_CORNERS).to(dev)
    vwc = torch.where(corners[None] > 0, hi[:, None, :], lo[:, None, :])  # (P, 8, 3)
    keys = vhash.pack_key(torch.div(vwc, R, rounding_mode="floor")).reshape(-1)
    keys = torch.where(mask[:, None].expand(-1, 8).reshape(-1), keys, vhash.EMPTY_KEY)
    skeys = torch.sort(keys).values
    first = torch.cat([skeys[:1] != vhash.EMPTY_KEY,
                       (skeys[1:] != skeys[:-1]) & (skeys[1:] != vhash.EMPTY_KEY)])
    order = torch.cumsum(first.to(torch.int32), 0) - 1
    dst = torch.where(first & (order < dedup_budget), order, dedup_budget).to(torch.int64)
    ukeys = torch.full((dedup_budget + 1,), vhash.EMPTY_KEY, dtype=torch.int32,
                       device=dev).scatter_(0, dst, skeys)[:dedup_budget]
    table, counter, vals, overflowed = vhash.insert(vol.table, vol.n_blocks, ukeys,
                                                    cfg.block_capacity - 1)
    idx = torch.where(vals >= 0, vals, N).to(torch.int64)
    coords = torch.cat([vol.block_coords, vol.block_coords.new_zeros((1, 3))])
    coords[idx] = vhash.unpack_key(ukeys)

    # -- splat: scatter-add w, w*d and w*color over the neighborhood ----------------
    inv2s2 = 1.0 / (2.0 * sigma.to(torch.float32) * sigma.to(torch.float32))
    offs = np.stack(np.meshgrid(*([np.arange(-reach, reach + 1)] * 3), indexing="ij"),
                    -1).reshape(-1, 3).astype(np.int32)
    W = torch.zeros((N * V + 1,), dtype=torch.float32, device=dev)
    WD = torch.zeros_like(W)
    WC = torch.zeros((3, N * V + 1), dtype=torch.float32, device=dev)
    cols_t = cols.to(torch.float32)
    for o in torch.from_numpy(offs).to(dev):
        vw = idx0 + o
        blk = torch.div(vw, R, rounding_mode="floor")
        loc = vw - blk * R
        slot = vhash.lookup(table, vhash.pack_key(blk))
        ok = mask & (slot >= 0)
        tgt = torch.where(ok, slot.to(torch.int64) * V
                          + (loc[:, 0] * (R * R) + loc[:, 1] * R + loc[:, 2]).to(torch.int64),
                          N * V)
        delta = fma(vw.to(torch.float32) + 0.5, cfg.voxel_size, -pts)  # center - p, fused
        d = dot3(delta, nrm)
        w = torch.where(ok, exp32(-dot3(delta, delta) * inv2s2), 0.0)
        W.index_add_(0, tgt, w)
        WD.index_add_(0, tgt, w * d)
        WC.index_add_(1, tgt, (w[:, None] * cols_t).T)

    eps = 1e-6
    W, WD, WC = W[:N * V], WD[:N * V], WC[:, :N * V]
    valid = W > eps
    Wc = torch.clamp_min(W, eps)
    # XLA simplifies (a / b) / c to a / (b * c)
    sdf = torch.clamp(WD / (Wc * trunc.to(torch.float32)), -1.0, 1.0)
    return vol._replace(
        table_keys=table.keys, table_vals=table.vals, n_blocks=counter,
        block_coords=coords[:N], overflow=vol.overflow | overflowed,
        tsdf=torch.where(valid, sdf, 0.0).reshape(N, V),
        weight=torch.where(valid, W, 0.0).reshape(N, V),
        color=(WC / Wc[None]).reshape(3, N, V).permute(1, 0, 2).contiguous())


def sdf_mesh_from_cloud(cloud: PointCloudHost, voxel: float = 0.01,
                        trunc: Optional[float] = None, sigma: Optional[float] = None,
                        block_capacity: int = 8192, reach: int = 1,
                        viewpoint=(0.0, 0.0, 0.0), *, device="cuda"
                        ) -> Optional[TriangleMeshHost]:
    """Host cloud -> welded mesh with vertex normals, splatted on ``device``
    (``"cuda"`` without a card raises); None under 16 points.

    A cloud without normals gets PCA normals oriented toward ``viewpoint``
    (a camera capture is oriented by its sensor position). ``trunc``
    defaults to 1.5 and ``sigma`` to 1 voxel; blocks are 8^3 voxels. A full
    pool logs a warning: the mesh then has holes."""
    pts = np.asarray(cloud.points, np.float32)
    if len(pts) < 16:
        log_warning("sdf_mesh_from_cloud: too few points")
        return None
    dev = resolve_device(device)
    p = torch.from_numpy(pts).to(dev)
    mask = torch.ones((len(pts),), dtype=torch.bool, device=dev)
    if cloud.normals is not None:
        nrm = torch.from_numpy(np.asarray(cloud.normals, np.float32)).to(dev)
    else:
        from azurekinect3dreconstruction_tpu_torch.ops.neighbors import estimate_normals_knn

        nrm = estimate_normals_knn(p, mask, radius=3 * voxel, k=12,
                                   orient_to=np.asarray(viewpoint, np.float32))
    cols = (torch.from_numpy(np.asarray(cloud.colors, np.float32)).to(dev)
            if cloud.colors is not None else torch.zeros_like(p))
    trunc = trunc if trunc is not None else 1.5 * voxel
    sigma = sigma if sigma is not None else voxel
    cfg = TSDFConfig(voxel_size=voxel, sdf_trunc=trunc, block_resolution=8,
                     block_capacity=block_capacity, hash_capacity=4 * block_capacity)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    vol = splat_cloud(p, nrm, cols, mask, cfg, f32(sigma), f32(trunc), reach=reach)
    if bool(vol.overflow):
        log_warning("sdf_mesh_from_cloud: block pool overflow — increase block_capacity "
                    "or voxel size; mesh will have holes")
    mesh = mc.extract_mesh(vol, cfg).compact()
    if cloud.colors is None:
        mesh.vertex_colors = None
    mesh = mc.weld_vertices(mesh)
    mesh.compute_vertex_normals()
    log_info(f"sdf mesh: {len(pts)} pts -> {mesh.triangles.shape[0]} tris "
             f"({int(vol.n_blocks)} blocks at {voxel * 1000:.0f}mm)")
    return mesh
