"""Carry state between the JAX package and the port, through numpy.

There are no weights to convert; what crosses is state: a TSDF volume (so
both packages can continue from the same pool, slot by slot), intrinsics,
pipeline configs and poses. Nothing here imports jax: the JAX side hands
over ``numpy`` arrays and plain dataclasses.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.tsdf.volume import TSDFVolume

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


def intrinsics_from(obj) -> Intrinsics:
    """Any intrinsics dataclass with the same fields (e.g. the JAX one)."""
    return Intrinsics(**dataclasses.asdict(obj))


def pipeline_config_from(obj) -> PipelineConfig:
    """Any ``PipelineConfig``-shaped dataclass, through its JSON form."""
    return PipelineConfig.from_json(json.dumps(dataclasses.asdict(obj)))


def pose_to_torch(T, device) -> torch.Tensor:
    """A 4x4 pose (numpy or array-like) -> float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(T, np.float32)).to(device)


def pose_to_numpy(T: torch.Tensor) -> np.ndarray:
    return T.detach().cpu().numpy().astype(np.float32)
