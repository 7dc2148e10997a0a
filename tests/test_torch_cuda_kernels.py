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


def _cpu_copy(vol):
    return vol._replace(**{k: v.cpu() for k, v in vol._asdict().items()})


def test_extract_mesh_on_cuda_matches_cpu(dev, frames):
    """The same pool on the card and on the CPU: the same soup in the same
    order (vertices <= 1e-6, colors <= 1e-6), and the sampled model equal."""
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc

    _, fr = frames
    rays = pixel_rays(INTR, dev)
    vol = tsdf.create(CFG, dev)
    for T, z, c in fr:
        vol = tsdf.integrate_frame(vol, z, c, rays, T, INTR, CFG)
    host = _cpu_copy(vol)
    mg, mh = mc.extract_mesh(vol, CFG), mc.extract_mesh(host, CFG)
    assert int(mg.num_triangles) == int(mh.num_triangles) > 1000
    np.testing.assert_allclose(mg.vertices, mh.vertices, atol=1e-6, rtol=0)
    np.testing.assert_allclose(mg.vertex_colors, mh.vertex_colors, atol=1e-6, rtol=0)
    T = fr[-1][0]
    pg, kg, _ = mc.extract_sampled_surface_model(vol, CFG, 3000, T, 3.0, sample_blocks=64)
    ph, kh, _ = mc.extract_sampled_surface_model(host, CFG, 3000, T.cpu(), 3.0,
                                                 sample_blocks=64)
    assert torch.equal(kg.cpu(), kh)
    np.testing.assert_allclose(pg.cpu().numpy(), ph.numpy(), atol=1e-6, rtol=0)


def test_f2m_step_on_cuda_matches_cpu(dev, frames):
    """One frame-to-model step from the same state on the card and on a CPU
    copy: pose <= 1e-4, the gate's decision equal, both kernels launched;
    the product stays in full float32 with TF32 requested."""
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        make_raw_f2m_step,
    )
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc

    poses, _ = frames
    pcfg = PipelineConfig(tsdf=CFG, odometry=OdometryConfig(pyramid_iters=(8, 8, 8)))
    cam = SyntheticCamera(intrinsics=INTR, device="cpu")
    (d0, c0), (d1, c1) = cam.capture(poses[0]), cam.capture(poses[1])
    pipe = MonoOdometryTSDF(INTR, pcfg, device=dev)
    pipe.process_frame(d0, c0)
    mp, mm, _ = mc.extract_sampled_surface_model(pipe.volume, CFG, 8192, pipe._T, 5.0)
    state = (pipe.volume, pipe._T, pipe._prev_int, pipe._prev_depth)
    cam_c = pcfg.camera
    scal = (1.0 / cam_c.depth_scale, cam_c.depth_min, cam_c.depth_trunc)
    step = make_raw_f2m_step(INTR, pcfg, min_inliers=200)
    host = (_cpu_copy(state[0]),) + tuple(t.cpu() for t in state[1:])
    b1, b2 = build.launches[tk.KERNEL], build.launches[odo.KERNEL]
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        out_g = step(*state, torch.from_numpy(d1).to(dev), torch.from_numpy(c1).to(dev),
                     pipe.rays, mp, mm, *scal)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert build.launches[tk.KERNEL] == b1 + 1
    assert build.launches[odo.KERNEL] == b2 + 2 * 24
    out_c = step(*host, torch.from_numpy(d1), torch.from_numpy(c1), pipe.rays.cpu(), mp.cpu(),
                 mm.cpu(), *scal)
    assert bool(out_g[6]) == bool(out_c[6]) is True
    np.testing.assert_allclose(out_g[1].cpu().numpy(), out_c[1].numpy(), atol=1e-4, rtol=0)
    assert abs(int(out_g[5]) - int(out_c[5])) <= 0.01 * int(out_c[5])


def test_f2m_pipeline_on_cuda_matches_cpu(dev, frames):
    poses, _ = frames
    pcfg = PipelineConfig(tsdf=CFG, odometry=OdometryConfig(pyramid_iters=(8, 8, 8)))
    cam = SyntheticCamera(intrinsics=INTR, device="cpu")
    raw = [cam.capture(T) for T in poses]
    kw = dict(tracking="frame_to_model", model_refine_interval=2, model_min_inliers=200)
    pg = MonoOdometryTSDF(INTR, pcfg, device=dev, **kw)
    pc = MonoOdometryTSDF(INTR, pcfg, device="cpu", **kw)
    for d, c in raw:
        pg.process_frame(d, c)
        pc.process_frame(d, c)
    np.testing.assert_allclose(np.stack(pg.trajectory), np.stack(pc.trajectory), atol=1e-4)
    assert pg.counts == pc.counts and pg.counts.get("model_icp_ok", 0) > 0


def test_graphed_icp_replays_the_eager_loop(dev, frames):
    """The CUDA-graph ICP equals the eager loop to the bit, on its first
    call (capture) and on a replay with other inputs."""
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import (
        GraphedICP,
        TargetMaps,
        icp_projective,
    )

    _, fr = frames
    rays = pixel_rays(INTR, dev)
    runner = GraphedICP(INTR, max_iters=10, dist_thr=0.05)
    for (T0, z0, _), (T1, z1, _) in ((fr[0], fr[1]), (fr[1], fr[2])):
        src = backproject_depth(z0, rays).reshape(-1, 3)
        mask = z0.reshape(-1) > 0
        tgt = TargetMaps.from_depth(z1, rays)
        init = se3.inverse(T1) @ T0
        want = icp_projective(src, mask, tgt, INTR, init=init, max_iters=10, dist_thr=0.05)
        got = runner(src, mask, tgt, init)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(got.inliers) > 1000
