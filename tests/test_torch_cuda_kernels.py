"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device. This file imports neither
jax nor the JAX package, so on a machine without jax run it as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu_torch.config import (
    OdometryConfig,
    PipelineConfig,
    RegistrationConfig,
    TSDFConfig,
)
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


# the main path's block geometry (5 mm voxels in 16^3 blocks) at quarter resolution
CFG16 = TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=16, block_capacity=4096,
                   hash_capacity=16384)


def _volume_before(fr, cfg, i=2):
    """A volume holding frames < i, with frame i's blocks allocated."""
    rays = pixel_rays(INTR, fr[0][1].device)
    vol = tsdf.create(cfg, rays.device)
    for T, z, c in fr[:i]:
        vol = tsdf.integrate_frame(vol, z, c, rays, T, INTR, cfg)
    T, z, _ = fr[i]
    return tsdf.allocate(vol, z, rays, T, cfg)


def test_integrate_kernel_matches_plain_bitwise_at_r16(dev, frames):
    """R = 16 at 5 mm (the main path's blocks): the kernel, bounded by the
    device-side row count, equals the plain version to the bit."""
    _, fr = frames
    vol = _volume_before(fr, CFG16)
    T, z, c = fr[2]
    wl, n_active = tk.build_worklist(vol.block_coords, vol.n_blocks, T, INTR, CFG16)
    wl = wl[:2048].contiguous()
    a, b = _clone(vol), _clone(vol)
    before = build.launches[tk.KERNEL]
    tk.integrate_worklist_cuda(a, wl, z, c, T, INTR, CFG16, n_active)
    assert build.launches[tk.KERNEL] == before + 1
    tk.integrate_worklist_plain(b, wl, z, c, T, INTR, CFG16)
    torch.cuda.synchronize()
    assert 100 < int(n_active) < 2048
    assert int(tk.updated_voxels(wl, z, T, INTR, CFG16)) > 100_000
    for k in ("weight", "tsdf", "color"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("cfg, size", [(CFG, 1024), (CFG16, 2048)], ids=["r8", "r16"])
def test_integrate_whole_pool_worklist_equals_compacted(dev, frames, cfg, size):
    """The first frame's whole-pool worklist (the default) and a compacted
    one give the same pools to the bit."""
    _, fr = frames
    vol = _volume_before(fr, cfg)
    T, z, c = fr[2]
    a = tk.integrate_worklist(_clone(vol), z, c, T, INTR, cfg)
    b = tk.integrate_worklist(_clone(vol), z, c, T, INTR, cfg, worklist_size=size)
    assert not bool(a.overflow) and not bool(b.overflow)
    for k in ("weight", "tsdf", "color"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_integrate_n_active_past_m_integrates_the_first_m_rows(dev, frames):
    """With more live rows than the worklist holds, exactly its M rows are
    integrated, as in the plain version, and the sticky flag is set."""
    _, fr = frames
    vol = _volume_before(fr, CFG16)
    T, z, c = fr[2]
    full, n_active = tk.build_worklist(vol.block_coords, vol.n_blocks, T, INTR, CFG16)
    M = 32
    assert int(n_active) > M
    wl = full[:M].contiguous()
    a, b = _clone(vol), _clone(vol)
    tk.integrate_worklist_cuda(a, wl, z, c, T, INTR, CFG16, n_active)
    tk.integrate_worklist_plain(b, wl, z, c, T, INTR, CFG16)
    for k in ("weight", "tsdf", "color"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    moved = (a.weight != vol.weight).any(dim=1)
    assert moved.sum() > 0 and not moved[full[M:int(n_active), 0].long()].any()
    assert set(moved.nonzero().flatten().tolist()) <= set(wl[:, 0].tolist())
    assert bool(tk.integrate_worklist(_clone(vol), z, c, T, INTR, CFG16, M).overflow)


def _by_key(vol):
    n = int(vol.n_blocks)
    keys = [tuple(k) for k in vol.block_coords[:n].cpu().tolist()]
    order = sorted(range(n), key=keys.__getitem__)
    idx = torch.tensor(order, device=vol.tsdf.device)
    return ([keys[i] for i in order],
            {k: getattr(vol, k)[idx] for k in ("weight", "tsdf", "color")})


def test_integrate_step_replays_in_a_cuda_graph(dev, frames):
    """allocate + worklist + B1 (``integrate_step``) captures into a CUDA
    graph; its replay on the next frame equals the eager call to the bit,
    block by block key (colliding hash claims may pick other slots)."""
    _, fr = frames
    rays = pixel_rays(INTR, dev)
    vol = _volume_before(fr, CFG16, 1)
    static = [a.clone() for a in fr[1]]  # T, depth, color
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.integrate_step(_clone(vol), static[1], static[2], static[0], rays, INTR, CFG16, 2048)
    torch.cuda.current_stream().wait_stream(side)
    captured = _clone(vol)
    graph = torch.cuda.CUDAGraph()
    before = build.launches[tk.KERNEL]
    with torch.cuda.graph(graph):
        out = tk.integrate_step(captured, static[1], static[2], static[0], rays, INTR, CFG16,
                                2048)
    assert build.launches[tk.KERNEL] == before + 1
    for s, a in zip(static, fr[2]):
        s.copy_(a)
    graph.replay()
    T, z, c = fr[2]
    want = tk.integrate_step(_clone(vol), z, c, T, rays, INTR, CFG16, 2048)
    torch.cuda.synchronize()
    assert int(out.n_blocks) == int(want.n_blocks) > int(vol.n_blocks)
    keys_g, rows_g = _by_key(out)
    keys_e, rows_e = _by_key(want)
    assert keys_g == keys_e
    for k in rows_g:
        assert torch.equal(rows_g[k], rows_e[k]), k
    assert bool(out.overflow) == bool(want.overflow) is False


def test_integrate_persistent_grid(dev):
    """The persistent grid: a whole number of CTAs on every SM, the same on
    a second query; printed for the record."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for R in tk.BLOCK_RESOLUTIONS:
        grid = tk.launch_grid(R)
        print(f"B1 persistent grid at R={R}: {grid} CTAs ({grid // sms} a SM, {sms} SMs)")
        assert grid > 0 and grid % sms == 0 and tk.launch_grid(R) == grid


def test_integrate_wrapper_refuses_unsupported_r_and_misaligned_pools(dev, frames):
    _, fr = frames
    T, z, c = fr[0]
    wl = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    before = build.launches[tk.KERNEL]
    cfg4 = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=4, block_capacity=64,
                      hash_capacity=256)
    with pytest.raises(ValueError, match="8, 16, 32"):
        tk.integrate_worklist_cuda(tsdf.create(cfg4, dev), wl, z, c, T, INTR, cfg4)
    vol = tsdf.create(CFG, dev)
    shifted = torch.zeros(CFG.block_capacity * 512 + 1, device=dev)[1:].view(-1, 512)
    with pytest.raises(ValueError, match="aligned"):
        tk.integrate_worklist_cuda(vol._replace(tsdf=shifted), wl, z, c, T, INTR, CFG)
    assert build.launches[tk.KERNEL] == before


def _odometry_args(fr, i=0):
    (_, z0, c0), (_, z1, c1) = fr[i], fr[i + 1]
    return (rgb_to_intensity(c0), z0, rgb_to_intensity(c1), z1, INTR)


def test_odometry_kernel_matches_plain(dev, frames):
    """One launch per frame pair; pose <= 1e-5 and fitness <= 1e-4 against
    the plain version at (8, 8, 8); the fixed grid and sum order give the
    same pose to the bit on a second run."""
    _, fr = frames
    args = _odometry_args(fr)
    cfg = OdometryConfig(pyramid_iters=(8, 8, 8))
    before = build.launches[odo.KERNEL]
    rk = odo.odometry_pyramid(odo.pyramid_cuda, *args, cfg)
    assert build.launches[odo.KERNEL] == before + 1
    rp = odo.odometry_pyramid(odo.pyramid_plain, *args, cfg)
    torch.testing.assert_close(rk.T_target_source, rp.T_target_source, atol=1e-5, rtol=0)
    assert abs(float(rk.fitness) - float(rp.fitness)) <= 1e-4
    rk2 = odo.odometry_pyramid(odo.pyramid_cuda, *args, cfg)
    assert torch.equal(rk.T_target_source, rk2.T_target_source)
    assert torch.equal(rk.fitness, rk2.fitness) and torch.equal(rk.rmse, rk2.rmse)


def test_odometry_kernel_global_path_equals_shared_path(dev, frames, monkeypatch):
    """The global-memory instance, forced on a pyramid that fits shared
    memory, does the same arithmetic in the same order: the same pose,
    fitness and rmse to the bit."""
    _, fr = frames
    args = _odometry_args(fr)
    cfg = OdometryConfig(pyramid_iters=(8, 8, 8))
    shared = odo.odometry_pyramid(odo.pyramid_cuda, *args, cfg)
    monkeypatch.setattr(odo, "oversized_levels", lambda dims, grid, band: [0])
    glob = odo.odometry_pyramid(odo.pyramid_cuda, *args, cfg)
    assert torch.equal(glob.T_target_source, shared.T_target_source)
    assert torch.equal(glob.fitness, shared.fitness) and torch.equal(glob.rmse, shared.rmse)


def test_odometry_kernel_zero_iteration_levels(dev, frames):
    """A (0, 3, 0) schedule: the empty levels pass the pose through, so the
    kernel equals the plain version at the same schedule."""
    _, fr = frames
    args = _odometry_args(fr)
    cfg = OdometryConfig(pyramid_iters=(0, 3, 0))
    init = torch.eye(4, device=dev)
    init[:3, 3] = torch.tensor([0.003, -0.002, 0.001], device=dev)
    rk = odo.odometry_pyramid(odo.pyramid_cuda, *args, cfg, init=init)
    rp = odo.odometry_pyramid(odo.pyramid_plain, *args, cfg, init=init)
    torch.testing.assert_close(rk.T_target_source, rp.T_target_source, atol=1e-5, rtol=0)
    assert abs(float(rk.fitness) - float(rp.fitness)) <= 1e-4
    none = odo.odometry_pyramid(odo.pyramid_cuda, *args, OdometryConfig(pyramid_iters=(0, 0, 0)),
                                init=init)
    assert torch.equal(none.T_target_source, init) and float(none.fitness) == 0.0


def test_odometry_kernel_convergence_exit(dev, frames):
    """convergence_delta = 1e9 stops every level after its first applied
    step: the same launch as a (1, 1, 1) schedule, to the bit."""
    _, fr = frames
    args = _odometry_args(fr)
    r_early = odo.odometry_pyramid(odo.pyramid_cuda, *args,
                                   OdometryConfig(pyramid_iters=(8, 8, 8), convergence_delta=1e9))
    r_one = odo.odometry_pyramid(odo.pyramid_cuda, *args, OdometryConfig(pyramid_iters=(1, 1, 1)))
    assert torch.equal(r_early.T_target_source, r_one.T_target_source)
    assert torch.equal(r_early.fitness, r_one.fitness)


def test_odometry_kernel_replays_in_a_cuda_graph(dev, frames):
    """One odometry call captures into a CUDA graph; a replay on new inputs
    gives the eager pose to the bit."""
    _, fr = frames
    cfg = OdometryConfig(pyramid_iters=(8, 8, 8))
    static = [a.clone() for a in _odometry_args(fr)[:4]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        odo.compute_odometry_fast(*static, INTR, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = odo.compute_odometry_fast(*static, INTR, cfg)
    new = _odometry_args(fr, 1)
    for s, a in zip(static, new[:4]):
        s.copy_(a)
    graph.replay()
    want = odo.compute_odometry_fast(*new[:4], INTR, cfg)
    torch.cuda.synchronize()
    assert torch.equal(out.T_target_source, want.T_target_source)
    assert torch.equal(out.fitness, want.fitness)


def test_wrappers_refuse_bad_inputs(dev, frames):
    _, fr = frames
    _, z, c = fr[0]
    vol = tsdf.create(CFG, dev)
    wl = torch.zeros((4, 4), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        tk.integrate_worklist_cuda(vol, wl, z, c, torch.eye(4, device=dev), INTR, CFG)
    state = torch.zeros(odo.STATE, device=dev)
    cfg = OdometryConfig(pyramid_iters=(1, 1, 1))
    pyr = [(torch.zeros((h, w), device=dev),) * 2 for h, w in ((144, 160), (72, 80), (36, 40))]
    before = build.launches[odo.KERNEL]
    cases = {
        "shape": ([pyr[0], (torch.zeros((72, 81), device=dev),) * 2, pyr[2]], pyr, cfg),
        "dtype": (pyr, [tuple(p.double() for p in pyr[0])] + pyr[1:], cfg),
        "depth": (pyr[:2], pyr[:2], cfg),
        "levels": (pyr + pyr[-1:] * 2, pyr + pyr[-1:] * 2, OdometryConfig(pyramid_iters=(1,) * 5)),
    }
    for ps, pt, c in cases.values():
        with pytest.raises(ValueError):
            odo.pyramid_cuda(state, ps, pt, INTR, c, 1.0, 1.0)
    assert build.launches[odo.KERNEL] == before


WFOV = Intrinsics(1024, 1024, 504.0, 504.0, 511.5, 511.5)  # WFOV unbinned depth


@pytest.fixture(scope="module")
def wfov_pair(dev):
    """A 1024x1024 frame pair of the synthetic scene, 2 cm apart."""
    cam = SyntheticCamera(intrinsics=WFOV, device=dev)
    T1 = np.eye(4)
    T1[:3, 3] = (0.02, -0.01, 0.01)
    (z0, c0), (z1, c1) = cam.render(np.eye(4)), cam.render(T1)
    return rgb_to_intensity(c0), z0, rgb_to_intensity(c1), z1, WFOV


def test_odometry_kernel_refuses_an_oversized_level(dev, wfov_pair):
    """A 1024x1024 level (WFOV unbinned) is larger than the grid's shared
    memory, so the launch keeps its planes in global memory: one launch,
    pose <= 1e-4 and fitness <= 1e-3 against the plain version, the same
    pose to the bit on a second launch."""
    grid, band = odo.launch_grid()
    assert 1024 * 1024 > grid * band
    cfg = OdometryConfig(pyramid_iters=(6, 4, 2))
    before = build.launches[odo.KERNEL]
    rk = odo.odometry_pyramid(odo.pyramid_cuda, *wfov_pair, cfg)
    assert build.launches[odo.KERNEL] == before + 1
    rp = odo.odometry_pyramid(odo.pyramid_plain, *wfov_pair, cfg)
    torch.testing.assert_close(rk.T_target_source, rp.T_target_source, atol=1e-4, rtol=0)
    assert abs(float(rk.fitness) - float(rp.fitness)) <= 1e-3 and float(rk.fitness) > 0.5
    rk2 = odo.odometry_pyramid(odo.pyramid_cuda, *wfov_pair, cfg)
    assert torch.equal(rk.T_target_source, rk2.T_target_source)


def test_odometry_kernel_global_path_exits_as_the_shared_path(dev, wfov_pair):
    """On the global path the zero-iteration levels pass the pose through
    and the convergence exit stops every level after one applied step, as
    on the shared path."""
    init = torch.eye(4, device=dev)
    init[:3, 3] = torch.tensor([0.003, -0.002, 0.001], device=dev)
    two = OdometryConfig(pyramid_iters=(2, 0, 0))
    rk = odo.odometry_pyramid(odo.pyramid_cuda, *wfov_pair, two, init=init)
    rp = odo.odometry_pyramid(odo.pyramid_plain, *wfov_pair, two, init=init)
    torch.testing.assert_close(rk.T_target_source, rp.T_target_source, atol=1e-4, rtol=0)
    r_early = odo.odometry_pyramid(odo.pyramid_cuda, *wfov_pair,
                                   OdometryConfig(pyramid_iters=(8, 8, 8), convergence_delta=1e9))
    r_one = odo.odometry_pyramid(odo.pyramid_cuda, *wfov_pair,
                                 OdometryConfig(pyramid_iters=(1, 1, 1)))
    assert torch.equal(r_early.T_target_source, r_one.T_target_source)
    assert torch.equal(r_early.fitness, r_one.fitness)


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
    assert build.launches[odo.KERNEL] - b2 == len(raw) - 1
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
    assert build.launches[odo.KERNEL] == b2 + 1
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


# -- two-camera fusion and the registration stack ----------------------------

DUAL_CFG = PipelineConfig(tsdf=CFG, registration=RegistrationConfig(
    ransac_hypotheses=1024, icp_max_iters=20, colored_icp_max_iters=30))
RIG_XI = (0.12, 0.03, -0.02, 0.05, -0.12, 0.04)  # tests/test_pipelines.py's rig


@pytest.fixture(scope="module")
def rig_pair():
    from azurekinect3dreconstruction_tpu_torch.core import se3

    T1 = se3.se3_exp(torch.tensor(RIG_XI, dtype=torch.float64)).numpy()
    cam = SyntheticCamera(intrinsics=INTR, device="cpu")
    return T1, (cam.capture(np.eye(4)), cam.capture(T1))


def test_dual_step_on_cuda_matches_cpu(dev, rig_pair):
    """One raw pair through the dual step on the card (B1 launched twice)
    and on the CPU (plain B1): the same block keys; matched voxels meet B1's
    tolerances (weights equal on >= 99.99 %, tsdf/color <= 1e-5 where they
    agree)."""
    from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import make_raw_dual_step

    T1, ((d0, c0), (d1, c1)) = rig_pair
    cam_c = DUAL_CFG.camera
    scal = (1.0 / cam_c.depth_scale, cam_c.depth_min, cam_c.depth_trunc)
    step = make_raw_dual_step(INTR, INTR, CFG)
    vols = []
    for d in (dev, torch.device("cpu")):
        rays = pixel_rays(INTR, d)
        t = lambda a: torch.from_numpy(a).to(d)
        before = build.launches[tk.KERNEL]
        vols.append(step(tsdf.create(CFG, d), t(d0), t(c0), t(d1), t(c1), rays, rays,
                         torch.eye(4, device=d), torch.as_tensor(T1, dtype=torch.float32,
                                                                 device=d),
                         *scal, torch.ones((), device=d)))
        assert build.launches[tk.KERNEL] - before == (2 if d.type == "cuda" else 0)
    _assert_close_by_key(*vols)


def _assert_close_by_key(vg, vc, edge_share: float = 0.0):
    """Two volumes hold the same block keys, and the matched voxels meet
    B1's tolerances: weights equal on >= 99.99 %, tsdf and color <= 1e-5
    where they agree, except on at most ``edge_share`` of those voxels:
    where the two integrated at poses a rounding apart (each device sums
    the tracking's normal equations in its own order), a voxel centre on a
    half-pixel edge samples the neighbouring pixel."""

    def keyed(v):
        n = int(v.n_blocks)
        return {tuple(k): s for s, k in enumerate(v.block_coords[:n].cpu().tolist())}

    kg, kc = keyed(vg), keyed(vc)
    assert kg.keys() == kc.keys() and len(kg) > 50
    keys = sorted(kg)
    rows = lambda v, k, f: getattr(v, f)[[k[x] for x in keys]].cpu()
    wg, wc = rows(vg, kg, "weight"), rows(vc, kc, "weight")
    agree = wg == wc
    assert agree.float().mean() >= 0.9999
    off = (rows(vg, kg, "tsdf") - rows(vc, kc, "tsdf")).abs() > 1e-5
    off |= ((rows(vg, kg, "color") - rows(vc, kc, "color")).abs() > 1e-5).any(dim=1)
    assert off[agree].float().mean() <= edge_share, int(off[agree].sum())


def _structured_pair():
    """A floor, a wall and a bump (distinctive FPFH), and its rigid copy."""
    from azurekinect3dreconstruction_tpu_torch.core import se3

    rng = np.random.RandomState(0)
    n = 400
    floor = np.stack([rng.uniform(0, 1, n), np.zeros(n), rng.uniform(0, 1, n)], 1)
    wall = np.stack([rng.uniform(0, 1, n), rng.uniform(0, 0.5, n), np.zeros(n)], 1)
    t, p = rng.uniform(0, 2 * np.pi, n), rng.uniform(0, np.pi, n)
    bump = 0.15 * np.stack([np.sin(p) * np.cos(t), np.sin(p) * np.sin(t), np.cos(p)], 1)
    src = np.concatenate([floor, wall, bump + [0.5, 0.15, 0.5]]).astype(np.float32)
    T = se3.se3_exp(torch.tensor([0.2, -0.1, 0.15, 0.3, 0.2, -0.4])).numpy()
    return src, (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32), T


def test_match_and_ransac_on_cuda_ignore_tf32(dev):
    """With ``set_float32_matmul_precision("high")`` requested, matching
    and RANSAC on the card equal the CPU's: the same correspondences where
    the nearest feature is decided (a gap > 1e-5), and from the same
    correspondences and ranks T within 1e-4 and fitness equal."""
    from azurekinect3dreconstruction_tpu_torch.config import RegistrationConfig as RC
    from azurekinect3dreconstruction_tpu_torch.ops.neighbors import estimate_normals_knn
    from azurekinect3dreconstruction_tpu_torch.tracking import ransac
    from azurekinect3dreconstruction_tpu_torch.tracking.features import compute_fpfh

    src, tgt, T = _structured_pair()
    mask = torch.ones(len(src), dtype=torch.bool)
    feats = []
    for pts, eye in ((src, [0.5, 2.0, 0.5]), (tgt, T[:3, :3] @ [0.5, 2.0, 0.5] + T[:3, 3])):
        p = torch.from_numpy(pts)
        n = estimate_normals_knn(p, mask, radius=0.12, k=16, orient_to=np.asarray(eye))
        feats.append(compute_fpfh(p, n, mask, radius=0.15, k=16))
    cfg = RC(ransac_hypotheses=2048)
    corr_c = ransac.match_features(feats[0], feats[1], mask, mask)
    ranks = ransac.draw_samples((corr_c >= 0).sum(), 2048, 4, torch.Generator().manual_seed(0))
    res_c = ransac.ransac_registration(torch.from_numpy(src), torch.from_numpy(tgt), corr_c,
                                       cfg, 0.05, samples=ranks)
    g = lambda a: a.to(dev)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        corr_g = ransac.match_features(g(feats[0]), g(feats[1]), g(mask), g(mask)).cpu()
        res_g = ransac.ransac_registration(g(torch.from_numpy(src)), g(torch.from_numpy(tgt)),
                                           g(corr_c), cfg, 0.05, samples=g(ranks))
    finally:
        torch.set_float32_matmul_precision(prev)
    f0, f1 = feats[0].double(), feats[1].double()
    d = torch.cdist(f0, f1) ** 2
    top2 = torch.topk(d, 2, dim=1, largest=False).values
    decided = (top2[:, 1] - top2[:, 0]) > 1e-5
    assert decided.float().mean() > 0.4
    assert torch.equal(corr_g[decided], corr_c[decided])
    np.testing.assert_allclose(res_g.T.cpu().numpy(), res_c.T.numpy(), atol=1e-4, rtol=0)
    assert float(res_g.fitness) == float(res_c.fitness) > 0.1


def test_calibrated_dual_loop_never_syncs(dev, rig_pair, tmp_path):
    """``DualCameraFusion(device="cuda")``: the first pair calibrates the
    test rig (within 2 cm / 0.03 rad), and after it ``process_frames`` runs
    under ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    host synchronization, with B1 launched twice a pair."""
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import DualCameraFusion

    T1, pair = rig_pair
    pipe = DualCameraFusion((INTR, INTR), DUAL_CFG, device=dev, output_dir=str(tmp_path))
    pipe.process_frames(pair)
    assert pipe.calibrated
    err = se3.se3_log(torch.as_tensor(np.linalg.inv(T1) @ pipe.extrinsics[1])).numpy()
    assert np.linalg.norm(err[:3]) < 0.02 and np.linalg.norm(err[3:]) < 0.03
    torch.cuda.synchronize()
    before = build.launches[tk.KERNEL]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            pipe.process_frames(pair)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert build.launches[tk.KERNEL] - before == 6
    assert not bool(pipe.volume.overflow)


# -- the recorder and the offline bundle ----------------------------------------

REC_CFG = PipelineConfig(tsdf=CFG, odometry=OdometryConfig(pyramid_iters=(8, 8, 8)),
                         registration=RegistrationConfig(ransac_hypotheses=1024, icp_max_iters=20,
                                                         colored_icp_max_iters=30),
                         keyframe_interval=1)


def _raw_frames(poses):
    cam = SyntheticCamera(intrinsics=INTR, device="cpu")
    return [cam.capture(T) for T in poses]


def test_recorder_steps_on_cuda_match_cpu(dev, frames):
    """The keyframe step (seed from zero maps, then a keyframe against the
    seed's maps) and the interval step on the card and on the CPU: pose
    <= 1e-4, fitness <= 1e-3, the volume by block key to B1's tolerances
    (the two keyframe poses are a rounding apart, so 0.01 % of the voxels
    may sit on the other side of a half-pixel edge, as against JAX in
    tests/test_torch_recorder.py), B1 once a step on the card."""
    from azurekinect3dreconstruction_tpu_torch.pipelines.recorder import make_raw_recorder_steps

    poses, _ = frames
    raw = _raw_frames(poses[:3])
    cam_c = REC_CFG.camera
    scal = (1.0 / cam_c.depth_scale, cam_c.depth_min, cam_c.depth_trunc)
    kf, intg = make_raw_recorder_steps(INTR, REC_CFG)
    H, W = INTR.height, INTR.width
    out = []
    for d in (dev, torch.device("cpu")):
        t = lambda a: torch.from_numpy(a).to(d)
        rays, eye = pixel_rays(INTR, d), torch.eye(4, device=d)
        zeros = (torch.zeros((H, W, 3), device=d),) * 2 + (torch.zeros((H, W), device=d),) * 3
        before = build.launches[tk.KERNEL]
        vol, T0, fit0, *maps = kf(tsdf.create(CFG, d), eye, eye, *zeros, t(raw[0][0]),
                                  t(raw[0][1]), rays, *scal)
        vol, T1, fit1, *_ = kf(vol, T0, T0, *maps, t(raw[1][0]), t(raw[1][1]), rays, *scal)
        vol = intg(vol, T1, t(raw[2][0]), t(raw[2][1]), rays, *scal)
        assert build.launches[tk.KERNEL] - before == (3 if d.type == "cuda" else 0)
        out.append((vol, T1.cpu(), float(fit0), float(fit1)))
    (vg, Tg, f0g, f1g), (vc, Tc, f0c, f1c) = out
    assert f0g == f0c == -1.0 and f1c >= REC_CFG.registration.min_fitness_colored
    assert abs(f1g - f1c) <= 1e-3
    np.testing.assert_allclose(Tg.numpy(), Tc.numpy(), atol=1e-4, rtol=0)
    assert not bool(vg.overflow) and not bool(vc.overflow)
    _assert_close_by_key(vg, vc, edge_share=1e-4)


def test_recorder_interval_steps_never_sync(dev, frames, tmp_path):
    """``Recorder(device="cuda")`` with a keyframe every 4 frames: after the
    seed keyframe, the interval frames run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    synchronization, with B1 once a frame."""
    import dataclasses

    from azurekinect3dreconstruction_tpu_torch.pipelines.recorder import Recorder

    poses, _ = frames
    raw = _raw_frames(poses)
    rec = Recorder(INTR, dataclasses.replace(REC_CFG, keyframe_interval=4), device=dev,
                   output_dir=str(tmp_path))
    rec.toggle_recording()
    rec.process_frame(*raw[0])
    torch.cuda.synchronize()
    before = build.launches[tk.KERNEL]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for d, c in raw[1:]:
            rec.process_frame(d, c)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert build.launches[tk.KERNEL] - before == len(raw) - 1
    assert len(rec.telemetry._timers["integrate"]) == len(raw) - 1
    assert not bool(rec.volume.overflow) and len(rec.trajectory) == len(raw) + 1


def test_offline_reintegrate_on_cuda_matches_cpu(dev, frames, tmp_path):
    """The offline bundle's reintegration of its logged frames at their
    poses on the card (B1 once a frame, whole-pool worklist) and on the CPU:
    the same block keys, B1's tolerances, no overflow."""
    from azurekinect3dreconstruction_tpu_torch.pipelines.offline_bundle import OfflineBundle

    poses, _ = frames
    raw = _raw_frames(poses)
    ob = OfflineBundle(INTR, REC_CFG, device=dev, output_dir=str(tmp_path))
    for d, c in raw:
        ob.process_frame(d, c)
    host = OfflineBundle(INTR, REC_CFG, device="cpu", output_dir=str(tmp_path))
    host.graph = ob.graph
    before = build.launches[tk.KERNEL]
    vg = ob._reintegrate(tsdf.create(CFG, dev))
    assert build.launches[tk.KERNEL] - before == len(raw)
    vc = host._reintegrate(tsdf.create(CFG, "cpu"))
    assert not bool(vg.overflow) and not bool(vc.overflow)
    _assert_close_by_key(vg, vc)


# -- relocalization and incremental extraction -------------------------------------

RELOC_CFG = PipelineConfig(tsdf=CFG, odometry=OdometryConfig(pyramid_iters=(8, 8, 8)))


@pytest.mark.parametrize("lost_in", [0.0, 1.0])
def test_latched_step_on_cuda_matches_cpu(dev, frames, lost_in):
    """One latched step (``integrate_rejected=False``) from the same state on
    the card and on a CPU copy: the same ``lost``, pose <= 1e-4, the volume
    by block key to B1's tolerances, nothing allocated or updated when
    latched; B2 and B1 launched once each on the card."""
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        make_raw_slam_step,
    )

    poses, _ = frames
    raw = _raw_frames(poses[:2])
    cam_c = RELOC_CFG.camera
    scal = (1.0 / cam_c.depth_scale, cam_c.depth_min, cam_c.depth_trunc)
    pipe = MonoOdometryTSDF(INTR, RELOC_CFG, device=dev)
    pipe.process_frame(*raw[0])
    state = (pipe.volume, pipe._T, pipe._prev_int, pipe._prev_depth)
    host = (_cpu_copy(state[0]),) + tuple(t.cpu() for t in state[1:])
    before = int(host[0].n_blocks), host[0].weight.clone()
    step = make_raw_slam_step(INTR, RELOC_CFG, integrate_rejected=False)
    out = []
    for d, st in ((dev, state), (torch.device("cpu"), host)):
        t = lambda a: torch.from_numpy(a).to(d)
        b1, b2 = build.launches[tk.KERNEL], build.launches[odo.KERNEL]
        vol, T, fit, _, _, lost = step(*st, t(raw[1][0]), t(raw[1][1]), pixel_rays(INTR, d),
                                       *scal, torch.full((), lost_in, device=d))
        n = 1 if d.type == "cuda" else 0
        assert (build.launches[tk.KERNEL] - b1, build.launches[odo.KERNEL] - b2) == (n, n)
        out.append((vol, T.cpu(), float(fit), float(lost)))
    (vg, Tg, fg, lg), (vc, Tc, fc, lc) = out
    assert lg == lc == lost_in and fc > 0.3 and abs(fg - fc) <= 1e-3
    np.testing.assert_allclose(Tg.numpy(), Tc.numpy(), atol=1e-4, rtol=0)
    if lost_in:
        assert int(vg.n_blocks) == int(vc.n_blocks) == before[0]
        assert torch.equal(vg.weight.cpu(), before[1]) and torch.equal(vc.weight, before[1])
    else:
        assert int(vg.n_blocks) > before[0]
        _assert_close_by_key(vg, vc, edge_share=1e-4)


def test_content_checksums_on_cuda_equal_cpu(dev, frames):
    """The pool's content stamp of a card volume equals the CPU copy's to
    the bit, with values in the trash slot too."""
    _, fr = frames
    rays = pixel_rays(INTR, dev)
    vol = tsdf.create(CFG, dev)
    for T, z, c in fr[:3]:
        vol = tsdf.integrate_frame(vol, z, c, rays, T, INTR, CFG)
    vol.tsdf[-1] = 0.25
    vol.weight[-1] = 7.0
    got = tsdf.content_checksums(vol)
    want = tsdf.content_checksums(_cpu_copy(vol))
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
    assert int(want[0, -1]) == int(want[1, -1]) == 0 and int(want[2, 0]) == int(vol.n_blocks)


def test_reloc_model_cache_misses_after_b1_refusion(dev, frames):
    """B1 updates the pools through raw pointers: after a re-fusion into the
    same blocks the pool tensor, its address and its version counter are
    all unchanged, yet the relocalizer's model cache must miss; the same
    volume again hits."""
    from azurekinect3dreconstruction_tpu_torch.tracking.relocalize import Relocalizer

    _, fr = frames
    T, z, c = fr[0]
    rays = pixel_rays(INTR, dev)
    vol = tsdf.integrate_frame(tsdf.create(CFG, dev), z, c, rays, T, INTR, CFG)
    reloc = Relocalizer(INTR, RELOC_CFG, device=dev, min_inliers=500, model_points=16384,
                        restarts=1)
    hint = T.cpu().numpy().astype(np.float64)
    reloc.attempt(vol, z, T_hint=hint)
    key1 = reloc._model_cache[0]
    ptr, version, nb = vol.tsdf.data_ptr(), vol.tsdf._version, int(vol.n_blocks)
    b1 = build.launches[tk.KERNEL]
    vol2 = tsdf.integrate_frame(vol, z, c, rays, T, INTR, CFG)
    assert build.launches[tk.KERNEL] == b1 + 1
    assert vol2.tsdf is vol.tsdf and vol2.tsdf.data_ptr() == ptr
    assert vol2.tsdf._version == version and int(vol2.n_blocks) == nb
    reloc.attempt(vol2, z, T_hint=hint)
    assert reloc._model_cache[0] != key1, "B1's in-place update must miss the model cache"
    key2, model = reloc._model_cache[0], reloc._model_cache[1]
    reloc.attempt(vol2, z, T_hint=hint)
    assert reloc._model_cache[0] == key2 and reloc._model_cache[1] is model


def test_relocalize_loop_syncs_only_at_check_frames(dev, frames):
    """``MonoOdometryTSDF(relocalize=True)`` while tracking is healthy: every
    frame but the check frames (each ``reloc_interval``-th) runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    synchronization; B2 once and B1 once a tracked frame."""
    poses = orbit_trajectory(9, radius=0.3, angle_span=0.6)
    raw = _raw_frames(poses)
    pipe = MonoOdometryTSDF(INTR, RELOC_CFG, device=dev, relocalize=True, reloc_interval=4)
    pipe.process_frame(*raw[0])
    torch.cuda.synchronize()
    b1, b2 = build.launches[tk.KERNEL], build.launches[odo.KERNEL]
    checks = 0
    for d, c in raw[1:]:
        check = (pipe.frame_index + 1) % pipe.reloc_interval == 0
        checks += check
        torch.cuda.set_sync_debug_mode(0 if check else "error")
        try:
            pipe.process_frame(d, c)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert checks == 2
    assert build.launches[tk.KERNEL] - b1 == build.launches[odo.KERNEL] - b2 == len(raw) - 1
    assert not pipe.lost and pipe.counts == {} and pipe.odometry_failures == 0


# -- the cloud meshers and the point-cloud pipelines ---------------------------------

# the splat's sums on the card are float32 atomics in no fixed order: weights
# within 1e-5 relative, tsdf and color within 1e-5
SPLAT_TOL = 1e-5


def _sphere(n=20000, r=0.15):
    rng = np.random.RandomState(0)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ((d * r + [0.0, 0.0, 0.5]).astype(np.float32), d.astype(np.float32),
            (d * 0.5 + 0.5).astype(np.float32))


def test_splat_on_cuda_matches_cpu(dev):
    """The SDF splat of one oriented, colored cloud on the card and on the
    CPU: the same block keys and overflow flag, weights within 1e-5
    relative, tsdf and color within 1e-5."""
    from azurekinect3dreconstruction_tpu_torch.meshing.sdf_mesh import splat_cloud

    pts, nrm, cols = _sphere()
    cfg = TSDFConfig(voxel_size=0.01, sdf_trunc=0.015, block_resolution=8, block_capacity=8192,
                     hash_capacity=32768)
    vols = []
    for d in (dev, torch.device("cpu")):
        t = lambda a: torch.from_numpy(a).to(d)
        vols.append(splat_cloud(t(pts), t(nrm), t(cols), torch.ones(len(pts), dtype=torch.bool,
                                                                   device=d), cfg,
                                torch.tensor(0.01, device=d), torch.tensor(0.015, device=d)))
    vg, vc = vols
    assert not bool(vg.overflow) and not bool(vc.overflow)

    def keyed(v):
        n = int(v.n_blocks)
        return {tuple(k): s for s, k in enumerate(v.block_coords[:n].cpu().tolist())}

    kg, kc = keyed(vg), keyed(vc)
    assert kg.keys() == kc.keys() and len(kg) > 50
    keys = sorted(kg)
    rows = lambda v, k, f: getattr(v, f)[[k[x] for x in keys]].cpu()
    wg, wc = rows(vg, kg, "weight"), rows(vc, kc, "weight")
    assert ((wg - wc).abs() <= SPLAT_TOL * wc).all()
    for f in ("tsdf", "color"):
        assert float((rows(vg, kg, f) - rows(vc, kc, f)).abs().max()) <= SPLAT_TOL


def test_fragment_pipeline_on_cuda_launches_b1_twice_a_frame(dev, frames):
    """``FragmentPipeline(device="cuda")`` over 3 captured frames: B1 twice
    a frame (the fragment meshes, then the scene), B2 never; the scene
    volume equals a CPU copy integrated at the card's poses, by block key
    to B1's tolerances."""
    from azurekinect3dreconstruction_tpu_torch.pipelines.fragments import FragmentPipeline

    poses, _ = frames
    raw = _raw_frames(poses[:3])
    pipe = FragmentPipeline(INTR, REC_CFG, device=dev, sample_points=4000)
    host = FragmentPipeline(INTR, REC_CFG, device="cpu", mesh_fragments=False)
    for p in (pipe, host):
        for d, c in raw:
            p.capture(d, c)
    b1, b2 = build.launches[tk.KERNEL], build.launches[odo.KERNEL]
    mesh = pipe.run()
    assert build.launches[tk.KERNEL] - b1 == 2 * len(raw)
    assert build.launches[odo.KERNEL] == b2
    assert mesh.triangles.shape[0] > 200
    host.make_fragments()
    for fh, fg in zip(host.fragments, pipe.fragments):
        fh.pose = fg.pose
    host.integrate_scene()
    assert not bool(pipe.volume.overflow) and not bool(host.volume.overflow)
    _assert_close_by_key(pipe.volume, host.volume)


def test_cloud_accumulator_keyframes_on_cuda_match_cpu(dev, frames, tmp_path):
    """Three ``CloudAccumulator`` keyframes on the card and on the CPU: each
    pose within 1e-4, the model's points within 1e-5 in the same order; no
    kernel launched."""
    from azurekinect3dreconstruction_tpu_torch.pipelines.cloud_accumulator import (
        CloudAccumulator,
    )

    poses, _ = frames
    raw = _raw_frames(poses[:3])
    pg = CloudAccumulator(INTR, REC_CFG, device=dev, coarse=False, output_dir=str(tmp_path))
    pc = CloudAccumulator(INTR, REC_CFG, device="cpu", coarse=False, output_dir=str(tmp_path))
    b1, b2 = build.launches[tk.KERNEL], build.launches[odo.KERNEL]
    for d, c in raw:
        pg.process_frame(d, c)
        pc.process_frame(d, c)
        np.testing.assert_allclose(pg.T_world_cam, pc.T_world_cam, atol=1e-4, rtol=0)
    assert build.launches[tk.KERNEL] == b1 and build.launches[odo.KERNEL] == b2
    assert pg.telemetry.counters == pc.telemetry.counters == {}
    np.testing.assert_allclose(pg.model_points, pc.model_points, atol=1e-5, rtol=0)


def test_pca_normals_on_cuda_take_large_batches(dev):
    """``pca_normal`` over 200,000 neighborhoods (a model cloud's
    ``estimate_normals_knn``): cuSOLVER's batched 3x3 ``eigh`` refuses such
    a batch whole, so it runs in batches; the normals agree with the CPU's
    up to sign (|cos| >= 1 - 1e-5) on near-planar neighborhoods."""
    from azurekinect3dreconstruction_tpu_torch.ops.normals import pca_normal

    rng = np.random.RandomState(0)
    xy = rng.uniform(-1.0, 1.0, (200_000, 12, 2))
    z = 0.3 * xy[..., 0] - 0.2 * xy[..., 1] + rng.normal(0.0, 1e-3, xy.shape[:2])
    nb = torch.from_numpy(np.concatenate([xy, z[..., None]], -1).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=xy.shape[:2]) > 0.1)
    ng = pca_normal(nb.to(dev), mask.to(dev)).cpu()
    nc = pca_normal(nb, mask)
    assert ng.shape == nc.shape == (200_000, 3)
    assert float((ng * nc).sum(dim=1).abs().min()) >= 1 - 1e-5


# -- host streaming ----------------------------------------------------------------

# tests/test_streaming.py's small pool and its manager
STREAM_CFG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=256,
                        hash_capacity=1024)
STREAM_KW = dict(evict_dist=1.4, reload_dist=1.1, high_water=0.75, check_interval=4)


def _corridor(x_cam, device):
    """tests/test_streaming.py's corridor frame at camera x: (depth, color,
    pose) tensors on ``device``."""
    yy, xx = np.meshgrid(np.arange(INTR.height), np.arange(INTR.width), indexing="ij")
    d = 0.6 + 0.03 * np.sin(0.2 * (xx + 37.0 * x_cam)) * np.sin(0.15 * yy)
    c = np.stack([0.5 + 0.5 * np.sin(0.05 * xx + x_cam), np.full_like(d, 0.3),
                  0.5 + 0.5 * np.cos(0.07 * yy)], axis=-1)
    T = np.eye(4)
    T[0, 3] = x_cam
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in (d, c, T))


def _soup(mesh):
    v = np.concatenate([np.asarray(mesh.vertices).reshape(-1, 9),
                        np.asarray(mesh.vertex_colors).reshape(-1, 9)], axis=1)
    return v[np.lexsort(v.T[::-1])]


def test_streaming_pinned_store_round_trips_to_the_bit(dev):
    """Evicted payloads land in page-locked host tensors and equal the
    pool's rows to the bit; reloaded, the pool's rows equal them again."""
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF

    sv = StreamingTSDF(STREAM_CFG, device=dev, **STREAM_KW)
    rays = pixel_rays(INTR, dev)
    for i in range(4):
        d, c, T = _corridor(0.04 * i, dev)
        sv.integrate_frame(d, c, rays, T, INTR)
    before = {tuple(k): (sv.vol.tsdf[s].clone(), sv.vol.weight[s].clone(), sv.vol.color[s].clone())
              for s, k in enumerate(sv.vol.block_coords[:int(sv.vol.n_blocks)].tolist())}
    sv.high_water = 0
    sv.tick(np.array([5.0, 0.0, 0.0]))  # every block is farther than evict_dist
    assert sv.n_evictions == 1 and int(sv.vol.n_blocks) == 0 and sv.n_stored == len(before)
    b = next(iter(sv._pbatch.values()))
    assert b.tsdf.is_pinned() and b.weight.is_pinned() and b.color.is_pinned()
    assert sv.pinned_bytes >= len(before) * 5 * 4 * STREAM_CFG.block_resolution ** 3
    for key in list(sv.store):
        t, w, c, crd = sv._stored_payload(key)
        bt, bw, bc = before[tuple(crd.tolist())]
        assert np.array_equal(t, bt.cpu().numpy()) and np.array_equal(w, bw.cpu().numpy())
        assert np.array_equal(c, bc.cpu().numpy())
    sv.tick(np.array([0.06, 0.0, 0.6]))  # amid the blocks: everything reloads
    assert sv.n_stored == 0 and int(sv.vol.n_blocks) == len(before)
    for s, k in enumerate(sv.vol.block_coords[:len(before)].tolist()):
        bt, bw, bc = before[tuple(k)]
        assert torch.equal(sv.vol.tsdf[s], bt) and torch.equal(sv.vol.weight[s], bw)
        assert torch.equal(sv.vol.color[s], bc)


def test_compact_then_b1_matches_cpu(dev, frames):
    """A shuffling compaction on the card and on a CPU copy, then one
    ``integrate_step`` (B1 on the card, its plain version on the CPU): the
    same block keys and B1's tolerances, and B1 launched once."""
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import _compact

    _, fr = frames
    rays = pixel_rays(INTR, dev)
    vol = tsdf.create(CFG, dev)
    for T, z, c in fr[:2]:
        vol = tsdf.integrate_frame(vol, z, c, rays, T, INTR, CFG)
    n = int(vol.n_blocks)
    perm = np.zeros(CFG.block_capacity, np.int64)
    perm[: n - 7] = np.random.RandomState(5).permutation(n)[: n - 7]  # and drop 7 blocks
    vg = _compact(vol, perm, n - 7)
    vc = _compact(_cpu_copy(vol), perm, n - 7)
    assert not bool(vg.overflow) and torch.equal(vg.block_coords.cpu(), vc.block_coords)
    T, z, c = fr[2]
    b1 = build.launches[tk.KERNEL]
    vg = tk.integrate_step(vg, z, c, T, rays, INTR, CFG, 2048)
    vc = tk.integrate_step(vc, z.cpu(), c.cpu(), T.cpu(), rays.cpu(), INTR, CFG, 2048)
    assert build.launches[tk.KERNEL] - b1 == 1
    _assert_close_by_key(vg, vc)


def test_streamed_corridor_on_cuda_matches_cpu_and_is_exact(dev):
    """60 corridor frames through the manager on the card and on the CPU:
    the same evictions and stored keys, the live volumes equal by block key
    within B1's tolerances; on the card, the streamed soup equals the soup
    of an infinite pool that saw the same frames to the bit."""
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF

    big = STREAM_CFG.replace(block_capacity=4096, hash_capacity=16384)
    runs = {}
    for device in (dev, torch.device("cpu")):
        sv = StreamingTSDF(STREAM_CFG, device=device, **STREAM_KW)
        rays = pixel_rays(INTR, device)
        ref = tsdf.create(big, device)
        b1 = build.launches[tk.KERNEL]
        for i in range(60):
            d, c, T = _corridor(0.04 * i, device)
            sv.integrate_frame(d, c, rays, T, INTR)
            ref = tsdf.integrate_frame(ref, d, c, rays, T, INTR, big)
        runs[device.type] = (sv, ref, build.launches[tk.KERNEL] - b1)
    sg, refg, launches = runs["cuda"]
    sc, _, _ = runs["cpu"]
    assert launches == 120  # B1 once a frame in each pool
    assert sg.n_evictions == sc.n_evictions > 0 and not bool(sg.vol.overflow)
    assert set(sg.store) == set(sc.store) and set(sg.soups) == set(sc.soups)
    _assert_close_by_key(sg.vol, sc.vol)
    got, want = _soup(sg.extract_mesh()), _soup(mc.extract_mesh(refg, big))
    assert got.shape == want.shape and got.shape[0] > 1000
    assert np.array_equal(got, want)


def test_streamed_loop_syncs_only_at_tick_frames(dev):
    """``MonoOdometryTSDF(streaming=...)``: every frame but the tick frames
    (each ``check_interval``-th) runs under
    ``torch.cuda.set_sync_debug_mode("error")``, the frame that copies the
    tick's state ahead included; B2 once and B1 once a tracked frame."""
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF

    pcfg = PipelineConfig(tsdf=CFG, odometry=OdometryConfig(pyramid_iters=(8, 8, 8)))
    sv = StreamingTSDF(CFG, evict_dist=9.0, reload_dist=7.0, check_interval=4, device=dev)
    pipe = MonoOdometryTSDF(INTR, pcfg, device=dev, streaming=sv)
    raw = _raw_frames(orbit_trajectory(10, radius=0.3, angle_span=0.6))
    pipe.process_frame(*raw[0])
    torch.cuda.synchronize()
    b1, b2 = build.launches[tk.KERNEL], build.launches[odo.KERNEL]
    ticks = 0
    for d, c in raw[1:]:
        tick = sv._since_check + 1 == sv.check_interval
        ticks += tick
        torch.cuda.set_sync_debug_mode(0 if tick else "error")
        try:
            pipe.process_frame(d, c)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert ticks == sv.n_ticks == 2
    assert build.launches[tk.KERNEL] - b1 == build.launches[odo.KERNEL] - b2 == len(raw) - 1
    assert pipe.volume.tsdf is sv.vol.tsdf and pipe.odometry_failures == 0
