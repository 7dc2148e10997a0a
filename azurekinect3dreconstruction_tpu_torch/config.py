"""Pipeline configuration dataclasses (a field-for-field copy of the JAX
package's ``config.py``).

The JAX package cannot be imported without jax, so the port carries its own
copy; ``tests/test_torch_core.py`` holds the two equal through the JSON
round-trip. Every parameter is explicit and serializable; runtime-tunable
fields (depth_scale, depth_trunc) are plain floats a UI loop may rebind
between frames.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Stream geometry + depth decoding. Mirrors the reference's NFOV defaults.

    depth 640x576 NFOV_UNBINNED, mm units (scale 1000), truncation 3.0 m:
    reference CreateMesh.py:85-89,123-130,14-16.
    """

    depth_width: int = 640
    depth_height: int = 576
    color_width: int = 1280
    color_height: int = 720
    depth_scale: float = 1000.0  # raw units per meter (k4a depth is mm)
    depth_trunc: float = 3.0  # meters; depths beyond are discarded
    depth_min: float = 0.1  # meters; closer returns are sensor noise

    def replace(self, **kw) -> "CameraConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    """Block-hashed TSDF volume parameters.

    The reference exercises voxel sizes 4 cm / 1 cm / 5 mm / 4 mm with
    sdf_trunc 0.04 or 3-4x voxel (reference
    CodeThatWorks/1camera-detectsSceneChanges.py:78-82,
    GoodColorReconstruction.py:49-50, CodeThatKindaWorks/capture_frames.py:18-19,
    bundlefusion_reconstruction.py:108-110). block_resolution=16 follows the
    author's own GPU sizing note (GoodColorReconstruction.py:51-52), but the
    pool capacity here is sized for device memory, not the reference's guess of 1000.
    """

    voxel_size: float = 0.005  # meters
    sdf_trunc: float = 0.02  # meters (4x voxel by default at 5 mm)
    block_resolution: int = 16  # voxels per block edge
    block_capacity: int = 8192  # max resident blocks (16^3 voxels each)
    hash_capacity: int = 32768  # open-addressing table slots (>= 2x capacity, pow2)
    max_integration_weight: float = 64.0  # running-average clamp
    # note: free-space carving needs no flag here — every allocated voxel in
    # front of the surface (sdf > sdf_trunc) is already driven toward +1 by
    # the band update rule (sdf > -sdf_trunc), matching Open3D

    def __post_init__(self):
        if self.hash_capacity & (self.hash_capacity - 1):
            raise ValueError("hash_capacity must be a power of two")
        if self.hash_capacity < 2 * self.block_capacity:
            raise ValueError("hash_capacity must be >= 2 * block_capacity")

    @property
    def block_size(self) -> float:
        return self.voxel_size * self.block_resolution

    def replace(self, **kw) -> "TSDFConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Hybrid photometric+geometric RGB-D odometry (Gauss-Newton).

    Pyramid iteration schedule [20,10,5] and max_depth_diff 0.03 follow the
    reference's OdometryOption usage
    (CodeThatWorks/bundlefusionattemps/bundlefusion_reconstruction.py:118-129).
    """

    pyramid_iters: Tuple[int, ...] = (20, 10, 5)  # coarse->fine handled internally
    max_depth_diff: float = 0.03  # meters; correspondence gate (reference value)
    min_depth: float = 0.1
    max_depth: float = 3.0
    sigma_intensity: float = 0.125  # photometric residual scale (Huber-ish weight)
    sigma_depth: float = 0.05  # geometric residual scale
    huber_delta: float = 1.345
    damping: float = 1e-6  # Levenberg diagonal damping on JtJ
    # stop a pyramid level early once the GN step norm falls below this
    # (0 disables — the default: this GN converges LINEARLY at ~0.85/iter on
    # the photometric cost, so steps rarely drop below 1e-5 inside the
    # reference's [20,10,5] budget and a tolerance loose enough to fire
    # would trade per-frame accuracy, which accumulates as drift). Offered
    # for throughput-over-accuracy deployments.
    convergence_delta: float = 0.0
    term: str = "hybrid"  # "hybrid" | "color" | "depth"


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """ICP / colored-ICP / RANSAC budgets and acceptance gates.

    Fitness gates 0.3 (global), 0.5 (ICP), 0.6 (colored ICP) and 2-cam overlap
    0.2-0.3 mirror the reference's de-facto accuracy bars
    (GoodColorReconstruction.py:183,200,256; CreateMesh.py:640;
    Works2CamerasCOLORVisualizer.py:539). RANSAC budget in the reference is
    4,000,000 sequential host iterations (CreateMesh.py:245); here a much
    smaller number of *parallel* hypotheses runs with the same acceptance
    statistics.
    """

    icp_max_iters: int = 50
    icp_distance_threshold: float = 0.02  # meters
    colored_icp_max_iters: int = 100
    colored_icp_lambda_geometric: float = 0.968
    min_fitness_global: float = 0.3
    min_fitness_icp: float = 0.5
    min_fitness_colored: float = 0.6
    min_overlap_extrinsic: float = 0.2
    ransac_hypotheses: int = 8192  # parallel hypotheses per round
    ransac_rounds: int = 8
    ransac_n: int = 4
    edge_length_check: float = 0.9
    fpfh_radius_multiplier: float = 5.0
    feature_knn: int = 64


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level knobs shared by the live pipelines."""

    camera: CameraConfig = CameraConfig()
    tsdf: TSDFConfig = TSDFConfig()
    odometry: OdometryConfig = OdometryConfig()
    registration: RegistrationConfig = RegistrationConfig()
    keyframe_interval: int = 10  # register every N frames (GoodColorReconstruction.py:57)
    vis_update_interval: int = 5  # re-extract every N frames (GoodColorReconstruction.py:84)
    voxel_downsample: float = 0.01  # viz cloud downsample (CreateMesh.py:766-786)
    output_dir: str = "results"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "PipelineConfig":
        d = json.loads(s)
        return PipelineConfig(
            camera=CameraConfig(**d.get("camera", {})),
            tsdf=TSDFConfig(**d.get("tsdf", {})),
            odometry=OdometryConfig(
                **{
                    k: tuple(v) if k == "pyramid_iters" else v
                    for k, v in d.get("odometry", {}).items()
                }
            ),
            registration=RegistrationConfig(**d.get("registration", {})),
            **{
                k: v
                for k, v in d.items()
                if k not in ("camera", "tsdf", "odometry", "registration")
            },
        )
