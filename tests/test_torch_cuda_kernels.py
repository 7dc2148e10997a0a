"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device. This file imports neither
jax nor the JAX package, so on a machine without jax run it as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu_torch.config import OdometryConfig, PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera, orbit_trajectory
from azurekinect3dreconstruction_tpu_torch.ops.image import rgb_to_intensity
from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import MonoOdometryTSDF
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

pytestmark = pytest.mark.cuda

INTR = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
CFG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=2048,
                 hash_capacity=8192)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frames(dev):
    cam = SyntheticCamera(intrinsics=INTR, device=dev)
    poses = orbit_trajectory(4, radius=0.3, angle_span=0.6)
    return poses, [(torch.as_tensor(T, dtype=torch.float32, device=dev), *cam.render(T))
                   for T in poses]


def _clone(vol):
    return vol._replace(**{k: v.clone() for k, v in vol._asdict().items()})


def test_integrate_kernel_matches_plain_bitwise(dev, frames):
    _, fr = frames
    rays = pixel_rays(INTR, dev)
    vol = tsdf.create(CFG, dev)
    for T, z, c in fr[:2]:
        vol = tsdf.integrate_frame(vol, z, c, rays, T, INTR, CFG)
    T, z, c = fr[2]
    vol = tsdf.allocate(vol, z, rays, T, CFG)
    wl, n_active = tk.build_worklist(vol.block_coords, vol.n_blocks, T, INTR, CFG)
    wl = wl[:1024].contiguous()
    a, b = _clone(vol), _clone(vol)
    before = build.launches[tk.KERNEL]
    tk.integrate_worklist_cuda(a, wl, z, c, T, INTR, CFG)
    assert build.launches[tk.KERNEL] == before + 1
    tk.integrate_worklist_plain(b, wl, z, c, T, INTR, CFG)
    torch.cuda.synchronize()
    assert int(n_active) > 50
    assert torch.equal(a.weight, b.weight)
    assert torch.equal(a.tsdf, b.tsdf)
    assert torch.equal(a.color, b.color)


def test_odometry_kernel_matches_plain(dev, frames):
    _, fr = frames
    (_, z0, c0), (_, z1, c1) = fr[0], fr[1]
    args = (rgb_to_intensity(c0), z0, rgb_to_intensity(c1), z1, INTR)
    cfg = OdometryConfig(pyramid_iters=(8, 8, 8))
    before = build.launches[odo.KERNEL]
    rk = odo.odometry_pyramid(odo.level_cuda, *args, cfg)
    assert build.launches[odo.KERNEL] == before + 2 * 24
    rp = odo.odometry_pyramid(odo.level_plain, *args, cfg)
    torch.testing.assert_close(rk.T_target_source, rp.T_target_source, atol=1e-5, rtol=0)
    assert abs(float(rk.fitness) - float(rp.fitness)) <= 1e-4
    # deterministic: the fixed-order reduction gives the same pose every run
    rk2 = odo.odometry_pyramid(odo.level_cuda, *args, cfg)
    assert torch.equal(rk.T_target_source, rk2.T_target_source)


def test_wrappers_refuse_bad_inputs(dev, frames):
    _, fr = frames
    _, z, c = fr[0]
    vol = tsdf.create(CFG, dev)
    wl = torch.zeros((4, 4), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        tk.integrate_worklist_cuda(vol, wl, z, c, torch.eye(4, device=dev), INTR, CFG)
    state = torch.zeros(odo.STATE, device=dev)
    src = torch.zeros((6, 10, 10), device=dev)
    with pytest.raises(ValueError):
        odo.level_cuda(state, src, src[:2], INTR, OdometryConfig(), 1, 1.0, 1.0)


def test_mono_pipeline_on_cuda_matches_cpu(dev, frames):
    poses, _ = frames
    pcfg = PipelineConfig(tsdf=CFG, odometry=OdometryConfig(pyramid_iters=(8, 8, 8)))
    cam = SyntheticCamera(intrinsics=INTR, device="cpu")
    raw = [cam.capture(T) for T in poses]
    pg = MonoOdometryTSDF(INTR, pcfg, device=dev)
    pc = MonoOdometryTSDF(INTR, pcfg, device="cpu")
    b1, b2 = build.launches[tk.KERNEL], build.launches[odo.KERNEL]
    for d, c in raw:
        pg.process_frame(d, c)
        pc.process_frame(d, c)
    assert build.launches[tk.KERNEL] - b1 == len(raw)
    assert build.launches[odo.KERNEL] - b2 == 2 * 24 * (len(raw) - 1)
    np.testing.assert_allclose(np.stack(pg.trajectory), np.stack(pc.trajectory), atol=1e-4)
    assert pg.odometry_failures == 0 and not bool(pg.volume.overflow)
    assert int(pg.volume.n_blocks) == int(pc.volume.n_blocks)
