"""TSDF worklist integration: the frustum-culled worklist, the CUDA kernel
wrapper (``csrc/tsdf_integrate.cu``) and its plain PyTorch version.

The worklist is a device-side compacted list of the visible blocks, padded
with the reserved trash slot, so its size is static and nothing waits on the
host: a frame with more visible blocks than the worklist holds sets the
volume's sticky ``overflow`` flag instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.fmath import fma, rcp32
from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf_volume

KERNEL = "tsdf_integrate"


def build_worklist(block_coords, n_blocks, T_world_cam, intr: Intrinsics, cfg: TSDFConfig):
    """Frustum-cull live blocks. Returns (worklist int32 (N, 4), n_active):
    rows (slot, bx, by, bz) of the visible blocks first, in slot order, then
    rows of the trash slot ``cfg.block_capacity - 1``; ``n_active`` is an
    int32 0-d tensor.

    A block is visible when it is allocated, not wholly behind the camera,
    and its projected corner box overlaps the image (a block with any
    corner behind the camera counts as covering the whole image)."""
    N = block_coords.shape[0]
    dev = block_coords.device
    T_cw = se3.inverse(T_world_cam.to(torch.float32))
    # the 8 unit-cube corners, made on the device (a host tensor would sync)
    bits = torch.arange(8, device=dev)[:, None] >> torch.arange(3, device=dev)
    corners = (bits & 1).to(torch.float32)
    pw = (block_coords[:, None, :].to(torch.float32) + corners[None]) * (
        cfg.block_resolution * cfg.voxel_size)  # (N, 8, 3)
    pc = se3.transform_points(T_cw, pw)
    z = pc[..., 2]
    zs = torch.clamp_min(z, 1e-3)
    u = fma(pc[..., 0] / zs, intr.fx, intr.cx)
    v = fma(pc[..., 1] / zs, intr.fy, intr.cy)
    behind = z <= 1e-3
    inf = float("inf")
    umin = torch.where(behind, inf, u).amin(1)
    umax = torch.where(behind, -inf, u).amax(1)
    vmin = torch.where(behind, inf, v).amin(1)
    vmax = torch.where(behind, -inf, v).amax(1)
    any_behind = behind.any(1)
    umin = torch.where(any_behind, 0.0, umin)
    umax = torch.where(any_behind, float(intr.width), umax)
    vmin = torch.where(any_behind, 0.0, vmin)
    vmax = torch.where(any_behind, float(intr.height), vmax)

    slot_ids = torch.arange(N, dtype=torch.int32, device=dev)
    visible = ((slot_ids < n_blocks) & ~behind.all(1) & (z.amax(1) > 1e-3)
               & (umax > 0) & (umin < intr.width) & (vmax > 0) & (vmin < intr.height))

    order = torch.cumsum(visible.to(torch.int32), 0) - 1
    dst = torch.where(visible, order, N).to(torch.int64)
    rows = torch.cat([slot_ids[:, None], block_coords.to(torch.int32)], dim=1)  # (N, 4)
    worklist = torch.zeros((N + 1, 4), dtype=torch.int32, device=dev)
    worklist[:, 0] = cfg.block_capacity - 1
    worklist[dst] = rows
    return worklist[:N], order[-1] + 1


def integrate_worklist_plain(vol, worklist, depth, color, T_world_cam, intr: Intrinsics,
                             cfg: TSDFConfig) -> None:
    """Plain PyTorch version of the kernel: ``tsdf.volume.integrate``
    restricted to the worklist rows (trash rows do nothing). In place."""
    slots = worklist[:, 0].to(torch.int64)
    tsdf_volume.fuse_blocks(vol, slots, worklist[:, 1:], slots != cfg.block_capacity - 1,
                            depth, color, se3.inverse(T_world_cam.to(torch.float32)),
                            intr, cfg)


def integrate_worklist_cuda(vol, worklist, depth, color, T_world_cam, intr: Intrinsics,
                            cfg: TSDFConfig) -> None:
    """Launch ``akr_tsdf_integrate`` on PyTorch's current stream. In place."""
    R = cfg.block_resolution
    H, W = intr.height, intr.width
    N = vol.tsdf.shape[0]
    dev = vol.tsdf.device
    build.check_tensor(worklist, torch.int32, (worklist.shape[0], 4), dev, "worklist")
    build.check_tensor(depth, torch.float32, (H, W), dev, "depth")
    build.check_tensor(color, torch.float32, (H, W, 3), dev, "color")
    build.check_tensor(vol.tsdf, torch.float32, (N, R ** 3), dev, "tsdf pool")
    build.check_tensor(vol.weight, torch.float32, (N, R ** 3), dev, "weight pool")
    build.check_tensor(vol.color, torch.float32, (N, 3, R ** 3), dev, "color pool")
    T_cw = se3.inverse(T_world_cam.to(device=dev, dtype=torch.float32))[:3].contiguous()
    params = build.float_params(intr.fx, intr.fy, intr.cx, intr.cy, cfg.voxel_size,
                                cfg.sdf_trunc, rcp32(cfg.sdf_trunc), cfg.max_integration_weight)
    lib = build.library()
    err = lib.akr_tsdf_integrate(
        worklist.data_ptr(), worklist.shape[0], T_cw.data_ptr(), depth.data_ptr(),
        color.data_ptr(), H, W, vol.tsdf.data_ptr(), vol.weight.data_ptr(),
        vol.color.data_ptr(), R, cfg.block_capacity - 1, params, build.stream_handle(dev))
    build.check(err, KERNEL)
    build.launches[KERNEL] += 1


def integrate_worklist(vol, depth, color, T_world_cam, intr: Intrinsics, cfg: TSDFConfig,
                       worklist_size: Optional[int] = None):
    """Worklist integrate (update phase; call ``allocate`` first). The pool
    is updated in place; returns ``vol`` with ``overflow`` set if more
    blocks are visible than ``worklist_size`` (default: the whole pool).

    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    worklist, n_active = build_worklist(vol.block_coords, vol.n_blocks, T_world_cam, intr, cfg)
    M = vol.tsdf.shape[0] if worklist_size is None else min(worklist_size, worklist.shape[0])
    worklist = worklist[:M].contiguous()
    fn = integrate_worklist_cuda if vol.tsdf.is_cuda else integrate_worklist_plain
    fn(vol, worklist, depth, color, T_world_cam, intr, cfg)
    return vol._replace(overflow=vol.overflow | (n_active > M))


def integrate_step(vol, depth, color, T_world_cam, rays, intr: Intrinsics,
                   cfg: TSDFConfig, worklist_size: int, stride: int = 2):
    """allocate + worklist + integrate with no host synchronization: the
    worklist size is a static budget, and overflow sets the sticky flag."""
    vol = tsdf_volume.allocate(vol, depth, rays, T_world_cam, cfg, stride=stride)
    return integrate_worklist(vol, depth, color, T_world_cam, intr, cfg, worklist_size)
