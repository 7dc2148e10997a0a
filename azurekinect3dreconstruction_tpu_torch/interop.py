"""Carry state between the JAX package and the port, through numpy.

There are no weights to convert; what crosses is state: a TSDF volume (so
both packages can continue from the same pool, slot by slot) or a sharded
one, intrinsics, a
device calibration, pipeline configs, poses and rig extrinsics, an
extracted mesh, a fixed-capacity ``PointCloud``, a frame-to-model tracking
model (its points and mask), and an unorganized cloud with its neighbor and
feature outputs (points, mask, normals, FPFH), so that each registration
stage can be compared from the same inputs. Nothing here imports jax: the
JAX side hands over ``numpy`` arrays and plain dataclasses.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import (
    CameraCalibration,
    Distortion,
    Intrinsics,
)
from azurekinect3dreconstruction_tpu_torch.core.types import PointCloud, TriangleMesh
from azurekinect3dreconstruction_tpu_torch.tsdf.volume import TSDFVolume

if TYPE_CHECKING:
    from azurekinect3dreconstruction_tpu_torch.parallel.sharded_volume import ShardedTSDF

_LANES = 128  # the JAX pool's trailing (R^3/128, 128) layout


def volume_from_jax_arrays(arrays: dict, device) -> TSDFVolume:
    """A JAX ``TSDFVolume`` given as ``{field: numpy array}`` -> the port's
    volume. Pools go from ``(N, R^3/128, 128)`` to ``(N, R^3)`` (a plain
    reshape); the hash and block coords are copied as they are."""
    n = arrays["tsdf"].shape[0]

    def dev(name, dtype, shape=None):
        a = np.array(arrays[name], dtype)  # a writable copy
        return torch.from_numpy(a if shape is None else a.reshape(shape)).to(device)

    return TSDFVolume(
        table_keys=dev("table_keys", np.int32),
        table_vals=dev("table_vals", np.int32),
        n_blocks=dev("n_blocks", np.int32),
        block_coords=dev("block_coords", np.int32),
        tsdf=dev("tsdf", np.float32, (n, -1)),
        weight=dev("weight", np.float32, (n, -1)),
        color=dev("color", np.float32, (n, 3, -1)),
        overflow=dev("overflow", np.bool_),
    )


def volume_to_numpy(vol: TSDFVolume) -> dict:
    """The port's volume -> ``{field: numpy array}`` in the JAX layout
    (``jax TSDFVolume(**{k: jnp.asarray(v)})`` rebuilds it)."""
    out = {k: v.detach().cpu().numpy() for k, v in vol._asdict().items()}
    n = out["tsdf"].shape[0]
    out["tsdf"] = out["tsdf"].reshape(n, -1, _LANES)
    out["weight"] = out["weight"].reshape(n, -1, _LANES)
    out["color"] = out["color"].reshape(n, 3, -1, _LANES)
    return out


def sharded_volume_from_jax_arrays(arrays: dict, mesh) -> ShardedTSDF:
    """A JAX sharded volume (``parallel.sharded_volume``) given as ``{field:
    numpy array}`` -> the port's :class:`ShardedTSDF` on ``mesh``: each
    axis-0 array holds ``n_blk`` shards' rows one after the other, and
    ``n_blocks`` / ``overflow`` one entry a shard. Shard ``b`` goes to
    ``mesh[0, b]`` through :func:`volume_from_jax_arrays`."""
    from azurekinect3dreconstruction_tpu_torch.parallel.sharded_volume import ShardedTSDF

    n_blk = mesh.shape["blk"]
    rows = lambda name, b: np.split(np.asarray(arrays[name]), n_blk)[b]
    return ShardedTSDF(tuple(
        volume_from_jax_arrays({k: np.asarray(v)[b] if k in ("n_blocks", "overflow")
                                else rows(k, b) for k, v in arrays.items()},
                               mesh.blk_device(b))
        for b in range(n_blk)))


def sharded_volume_to_numpy(vol: ShardedTSDF) -> dict:
    """The port's sharded volume -> ``{field: numpy array}`` in the JAX
    sharded layout (the shards' rows concatenated on axis 0)."""
    parts = [volume_to_numpy(s) for s in vol.shards]
    return {k: (np.stack if k in ("n_blocks", "overflow") else np.concatenate)(
        [p[k] for p in parts]) for k in parts[0]}


def intrinsics_from(obj) -> Intrinsics:
    """Any intrinsics dataclass with the same fields (e.g. the JAX one)."""
    return Intrinsics(**dataclasses.asdict(obj))


def calibration_from(obj) -> CameraCalibration:
    """Any ``CameraCalibration``-shaped dataclass (e.g. the JAX one)."""
    return CameraCalibration(
        depth=intrinsics_from(obj.depth), color=intrinsics_from(obj.color),
        depth_distortion=Distortion(**dataclasses.asdict(obj.depth_distortion)),
        color_distortion=Distortion(**dataclasses.asdict(obj.color_distortion)),
        T_color_depth=obj.T_color_depth, serial=obj.serial)


def pipeline_config_from(obj) -> PipelineConfig:
    """Any ``PipelineConfig``-shaped dataclass, through its JSON form."""
    return PipelineConfig.from_json(json.dumps(dataclasses.asdict(obj)))


def pose_to_torch(T, device) -> torch.Tensor:
    """A 4x4 pose (numpy or array-like) -> float32 tensor on ``device``."""
    return torch.from_numpy(np.array(T, np.float32)).to(device)


def pose_to_numpy(T: torch.Tensor) -> np.ndarray:
    return T.detach().cpu().numpy().astype(np.float32)


def mesh_from(obj) -> TriangleMesh:
    """Any ``TriangleMesh``-shaped object (e.g. the JAX one) -> the port's,
    with host numpy arrays."""
    arr = lambda a: None if a is None else np.asarray(a)
    return TriangleMesh(vertices=arr(obj.vertices), triangles=arr(obj.triangles),
                        num_vertices=np.int32(obj.num_vertices),
                        num_triangles=np.int32(obj.num_triangles),
                        vertex_colors=arr(obj.vertex_colors),
                        vertex_normals=arr(getattr(obj, "vertex_normals", None)))


def point_cloud_from(obj, device) -> PointCloud:
    """Any ``PointCloud``-shaped object (e.g. the JAX one) -> the port's, on
    ``device``."""
    t = lambda a, dt: None if a is None else torch.from_numpy(np.array(a, dt)).to(device)
    return PointCloud(points=t(obj.points, np.float32), mask=t(obj.mask, np.bool_),
                      colors=t(obj.colors, np.float32), normals=t(obj.normals, np.float32))


def model_to_torch(points, mask, device):
    """A tracking model ``(points (M, 3), mask (M,))`` -> tensors on ``device``."""
    return (torch.from_numpy(np.array(points, np.float32)).to(device),
            torch.from_numpy(np.array(mask, np.bool_)).to(device))


def extrinsics_to_numpy(extrinsics) -> list:
    """Rig extrinsics (4x4 numpy, JAX or torch arrays; ``None`` where
    unknown) -> float64 numpy copies, as both packages' pipelines hold them."""
    host = lambda T: T.detach().cpu().numpy() if isinstance(T, torch.Tensor) else T
    return [None if T is None else np.array(host(T), np.float64) for T in extrinsics]


def extrinsics_to_torch(extrinsics, device) -> list:
    """Rig extrinsics -> float32 tensors on ``device`` (``None`` stays)."""
    return [None if T is None else pose_to_torch(T, device) for T in extrinsics]


def cloud_to_torch(points, mask, normals=None, features=None, device="cpu") -> tuple:
    """An unorganized cloud and its per-point outputs (numpy or array-like)
    -> tensors on ``device``: (points f32 (N, 3), mask bool (N,), normals
    f32 (N, 3) or None, FPFH f32 (N, 33) or None)."""
    f32 = lambda a: None if a is None else torch.from_numpy(np.array(a, np.float32)).to(device)
    return (f32(points), torch.from_numpy(np.array(mask, np.bool_)).to(device), f32(normals),
            f32(features))
