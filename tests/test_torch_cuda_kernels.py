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


def test_odometry_kernel_refuses_an_oversized_level(dev):
    """A 1024x1024 level (WFOV unbinned) does not fit the grid's shared
    memory: pyramid_cuda raises before the launch."""
    big = Intrinsics(1024, 1024, 504.0, 504.0, 511.5, 511.5)
    pyr = [(torch.zeros((1024, 1024), device=dev),) * 2]
    state = torch.zeros(odo.STATE, device=dev)
    before = build.launches[odo.KERNEL]
    with pytest.raises(ValueError, match="level 0 is 1024x1024"):
        odo.pyramid_cuda(state, pyr, pyr, big, OdometryConfig(pyramid_iters=(1,)), 1.0, 1.0)
    assert build.launches[odo.KERNEL] == before


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

    def keyed(v):
        n = int(v.n_blocks)
        return {tuple(k): s for s, k in enumerate(v.block_coords[:n].cpu().tolist())}

    kg, kc = keyed(vols[0]), keyed(vols[1])
    assert kg.keys() == kc.keys() and len(kg) > 50
    keys = sorted(kg)
    rows = lambda v, k, f: getattr(v, f)[[k[x] for x in keys]].cpu()
    wg, wc = rows(vols[0], kg, "weight"), rows(vols[1], kc, "weight")
    agree = wg == wc
    assert agree.float().mean() >= 0.9999
    assert (rows(vols[0], kg, "tsdf") - rows(vols[1], kc, "tsdf")).abs()[agree].max() <= 1e-5
    dc = (rows(vols[0], kg, "color") - rows(vols[1], kc, "color")).abs()
    assert dc[agree[:, None].expand_as(dc)].max() <= 1e-5


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
