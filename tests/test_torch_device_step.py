"""The port's device-resident step and batches against the JAX package's
and against the port's own loops: ``make_fused_frame_fn`` /
``make_fused_batch_fn`` (``ops/kernels/tsdf_kernels.py``) and
``make_device_slam_step`` / ``make_device_slam_batch``
(``pipelines/mono_odometry_tsdf.py``).

Quarter resolution on the CPU, where the wrappers run B1's and B2's plain
versions; JAX's factories run their Pallas kernels in interpret mode. The
frames are the synthetic camera's, quantized to the sensor's u16 / u8 and
decoded as the live loop decodes them, at orbit poses jittered by
``small_motion`` (a numpy seed). Volumes are compared by block key (slot
order differs between the two packages' hashes). Each tolerance is stated
where it is used.

The JAX package is imported inside the fixture that needs it, so that the
card-only tests (marked ``cuda``) also run where jax is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_device_step.py``.
"""

import types

import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.config import (
    OdometryConfig,
    PipelineConfig,
    TSDFConfig,
)
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.types import decode_raw_frame
from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
    SyntheticCamera,
    orbit_trajectory,
    small_motion,
)
from azurekinect3dreconstruction_tpu_torch.ops.image import rgb_to_intensity
from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
from azurekinect3dreconstruction_tpu_torch.parallel import sharded_volume as sv
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
    MonoOdometryTSDF,
    make_device_slam_batch,
    make_device_slam_step,
)
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

torch.set_num_threads(2)

INTR = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
# the SMALL_CFG of tests/test_pipelines.py
CFG = PipelineConfig(
    tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=2048,
                    hash_capacity=8192),
    odometry=OdometryConfig(pyramid_iters=(8, 8, 8)),
)
WORKLIST = 1024
N_FRAMES = 6


def _frames(dev, n=N_FRAMES):
    """(raw host frames, decoded (depths, colors, intensities) on ``dev``,
    poses relative to the first as float32 on ``dev``)."""
    cam = SyntheticCamera(intrinsics=INTR, device=dev)
    poses = [T @ small_motion(i, 0.5).astype(np.float64)
             for i, T in enumerate(orbit_trajectory(n, radius=0.25, angle_span=0.5))]
    raw = [cam.capture(T) for T in poses]
    cc = CFG.camera
    dec = [decode_raw_frame(torch.from_numpy(d).to(dev), torch.from_numpy(c).to(dev),
                            1.0 / cc.depth_scale, cc.depth_min, cc.depth_trunc) for d, c in raw]
    D, C, I = (torch.stack([f[k] for f in dec]) for k in range(3))
    rel = np.stack([np.linalg.inv(poses[0]) @ T for T in poses])
    return raw, D, C, I, torch.as_tensor(rel, dtype=torch.float32, device=dev)


@pytest.fixture(scope="module")
def frames():
    return _frames("cpu")


@pytest.fixture(scope="module")
def rays():
    return pixel_rays(INTR, "cpu")


@pytest.fixture(scope="module")
def port_slam(frames, rays):
    _, D, C, I, _ = frames
    batch = make_device_slam_batch(INTR, CFG, worklist_size=WORKLIST)
    return batch(tsdf.create(CFG.tsdf, "cpu"), torch.eye(4), I, D, C, rays)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's factories, config and intrinsics."""
    import jax.numpy as jnp

    from azurekinect3dreconstruction_tpu import config as jcfg
    from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
    from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
    from azurekinect3dreconstruction_tpu.ops.pallas import tsdf_kernels as jtk
    from azurekinect3dreconstruction_tpu.pipelines import mono_odometry_tsdf as jmono
    from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf

    jintr = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)
    jc = jcfg.PipelineConfig(
        tsdf=jcfg.TSDFConfig(**{f: getattr(CFG.tsdf, f) for f in (
            "voxel_size", "sdf_trunc", "block_resolution", "block_capacity", "hash_capacity")}),
        odometry=jcfg.OdometryConfig(pyramid_iters=CFG.odometry.pyramid_iters))
    return types.SimpleNamespace(jnp=jnp, intr=jintr, cfg=jc, rays=jpixel_rays(jintr),
                                 tk=jtk, mono=jmono, tsdf=jtsdf)


def _keyed(v):
    """{block key: (tsdf, weight, color) rows} of a volume's live blocks
    (numpy fields)."""
    n = int(v["n_blocks"])
    R = CFG.tsdf.block_resolution
    return {tuple(v["block_coords"][s]): (v["tsdf"][s].reshape(-1), v["weight"][s].reshape(-1),
                                          v["color"][s].reshape(3, R ** 3)) for s in range(n)}


def _np(vol):
    return {k: np.asarray(t) for k, t in vol._asdict().items()}


def _assert_b1_close(got, want):
    """B1's stated tolerances by block key: the same keys; weights equal on
    >= 99 % of the blocks; tsdf within 1e-5 where the weights agree on
    >= 99 % of the voxels; color within 0.51/255 on >= 99.9 % of the
    voxels. The Pallas kernel samples a half-resolution mip level for
    large blocks and keeps its color as u8, so a few voxels read a
    neighbouring pixel or round their color."""
    a, b = _keyed(got), _keyed(want)
    assert a.keys() == b.keys() and len(a) > 50
    keys = sorted(a)
    wa, wb = (np.stack([x[k][1] for k in keys]) for x in (a, b))
    ta, tb = (np.stack([x[k][0] for k in keys]) for x in (a, b))
    ca, cb = (np.stack([x[k][2] for k in keys]) for x in (a, b))
    same_w = wa == wb
    assert same_w.all(axis=1).mean() >= 0.99, same_w.all(axis=1).mean()
    assert (same_w & (np.abs(ta - tb) <= 1e-5)).mean() >= 0.99
    assert (np.abs(ca - cb).max(axis=1) <= 0.51 / 255).mean() >= 0.999


def _equal(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in a._fields)


# -- the fused factories ---------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_batch_equals_integrate_step_calls(frames, rays, stride):
    """``make_fused_batch_fn`` is F calls of ``integrate_step``, to the bit."""
    _, D, C, _, P = frames
    got = tk.make_fused_batch_fn(INTR, CFG.tsdf, WORKLIST, stride)(
        tsdf.create(CFG.tsdf, "cpu"), D, C, P, rays)
    want = tsdf.create(CFG.tsdf, "cpu")
    for f in range(N_FRAMES):
        want = tk.integrate_step(want, D[f], C[f], P[f], rays, INTR, CFG.tsdf, WORKLIST, stride)
    assert _equal(got, want) and int(got.n_blocks) > 50 and not bool(got.overflow)


def test_fused_frame_fn_chained_equals_the_batch(frames, rays):
    """``make_fused_frame_fn`` called frame by frame equals the batch, to
    the bit; the pools update in place (the returned volume shares the
    input's storage, as JAX's donated volume would)."""
    _, D, C, _, P = frames
    step = tk.make_fused_frame_fn(INTR, CFG.tsdf, WORKLIST)
    vol = tsdf.create(CFG.tsdf, "cpu")
    pool = vol.tsdf.data_ptr()
    for f in range(N_FRAMES):
        vol = step(vol, D[f], C[f], P[f], rays)
    assert vol.tsdf.data_ptr() == pool
    want = tk.make_fused_batch_fn(INTR, CFG.tsdf, WORKLIST)(
        tsdf.create(CFG.tsdf, "cpu"), D, C, P, rays)
    assert _equal(vol, want)


def test_fused_batch_overflow_sets_the_sticky_flag(frames, rays):
    """A worklist smaller than the visible blocks sets ``overflow``."""
    _, D, C, _, P = frames
    vol = tk.make_fused_batch_fn(INTR, CFG.tsdf, 8)(tsdf.create(CFG.tsdf, "cpu"), D[:2], C[:2],
                                                    P[:2], rays)
    assert bool(vol.overflow)


def test_fused_batch_matches_jax_by_key(frames, rays, jax_side):
    """Against JAX's ``make_fused_batch_fn(interpret=True)`` on the same
    decoded frames and poses, frame by frame from JAX's state (carried
    across with ``interop.volume_from_jax_arrays``), with B1's tolerances
    (``_assert_b1_close``). The tolerances are per launch: the Pallas
    kernel's per-frame disagreement (some 0.015 % of the voxels read a
    neighbouring pixel) compounds from frame to frame, so each frame is
    held to them from the same state; the port's batch equals its
    ``integrate_step`` chain to the bit (above)."""
    J = jax_side
    _, D, C, _, P = frames
    batch = tk.make_fused_batch_fn(INTR, CFG.tsdf, WORKLIST)
    jb = J.tk.make_fused_batch_fn(J.intr, J.cfg.tsdf, WORKLIST, 2, True)
    jvol = J.tsdf.create(J.cfg.tsdf)
    for f in range(N_FRAMES):
        got = batch(interop.volume_from_jax_arrays(_np(jvol), "cpu"), D[f:f + 1], C[f:f + 1],
                    P[f:f + 1], rays)
        jvol = jb(jvol, *(J.jnp.asarray(t[f:f + 1].numpy()) for t in (D, C, P)), J.rays)
        assert bool(jvol.overflow) == bool(got.overflow) is False
        _assert_b1_close(_np(got), _np(jvol))


def test_factories_are_cached():
    """Hashable configs key the factories' caches, as JAX's
    ``lru_cache``s are keyed."""
    assert tk.make_fused_batch_fn(INTR, CFG.tsdf, WORKLIST) is tk.make_fused_batch_fn(
        INTR, CFG.tsdf, WORKLIST)
    assert tk.make_fused_frame_fn(INTR, CFG.tsdf, WORKLIST) is tk.make_fused_frame_fn(
        INTR, CFG.tsdf, WORKLIST)
    assert make_device_slam_step(INTR, CFG) is make_device_slam_step(INTR, CFG)
    assert make_device_slam_batch(INTR, CFG, worklist_size=WORKLIST) is make_device_slam_batch(
        INTR, CFG, worklist_size=WORKLIST)
    assert make_device_slam_batch(INTR, CFG) is not make_device_slam_batch(INTR, CFG, 1024)


# -- the SLAM step and batch -----------------------------------------------------


def test_slam_batch_matches_jax_interpret(frames, rays, port_slam, jax_side):
    """Against JAX's ``make_device_slam_batch(interpret=True)``: poses within
    1e-4 and fits within 1e-3 (the two sum their normal equations in another
    order), the same gate decisions, the same block keys."""
    J = jax_side
    _, D, C, I, _ = frames
    vol, poses, fits = port_slam
    jb = J.mono.make_device_slam_batch(J.intr, J.cfg, worklist_size=WORKLIST, interpret=True)
    jvol, jposes, jfits = jb(J.tsdf.create(J.cfg.tsdf), J.jnp.eye(4, dtype=J.jnp.float32),
                             *(J.jnp.asarray(t.numpy()) for t in (I, D, C)), J.rays)
    assert poses.shape == (N_FRAMES - 1, 4, 4) and fits.shape == (N_FRAMES - 1,)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(fits.numpy(), np.asarray(jfits), rtol=0, atol=1e-3)
    assert ((fits.numpy() > 0.3) == (np.asarray(jfits) > 0.3)).all() and (fits > 0.3).all()
    # the volume by key: the same blocks, weights equal on >= 99 % of them
    # (B1's own parity is held frame by frame above)
    a, b = _keyed(_np(vol)), _keyed(_np(jvol))
    assert a.keys() == b.keys() and len(a) > 50
    assert np.mean([np.array_equal(a[k][1], b[k][1]) for k in a]) >= 0.99


def test_slam_batch_equals_the_mono_loop(frames, port_slam):
    """On the mono loop's own decoded frames, the batch's poses and fits
    equal ``MonoOdometryTSDF``'s, to the bit (the same decode, odometry and
    gate)."""
    raw = frames[0]
    _, poses, fits = port_slam
    pipe = MonoOdometryTSDF(INTR, CFG, device="cpu", worklist_size=WORKLIST)
    for d, c in raw:
        pipe.process_frame(d, c)
    assert torch.equal(torch.stack(pipe._traj[2:]), poses)
    assert torch.equal(torch.stack(pipe._fits), fits)


def test_slam_batch_equals_the_sharded_1x1_batch(frames, rays, port_slam):
    """``make_sharded_slam_batch`` on a 1 x 1 CPU grid shares the per-frame
    tracking body: the same poses and fits, to the bit."""
    _, D, C, I, _ = frames
    _, poses, fits = port_slam
    mesh = sv.make_mesh(1, 1, ["cpu"])
    batch = sv.make_sharded_slam_batch(mesh, INTR, CFG, stride=2, worklist_size=WORKLIST)
    _, sposes, sfits = batch(sv.create_sharded(CFG.tsdf, mesh), torch.eye(4)[None], I[None],
                             D[None], C[None], rays)
    assert torch.equal(sposes[0], poses) and torch.equal(sfits[0], fits)


def test_slam_step_chained_equals_the_batch(frames, rays, port_slam):
    """``make_device_slam_step`` chained by hand equals the batch: poses,
    fits and every field of the volume, to the bit."""
    _, D, C, I, _ = frames
    vol_b, poses, fits = port_slam
    step = make_device_slam_step(INTR, CFG, worklist_size=WORKLIST)
    vol, T = tsdf.create(CFG.tsdf, "cpu"), torch.eye(4)
    for f in range(1, N_FRAMES):
        vol, T, fit = step(vol, T, I[f - 1], D[f - 1], I[f], D[f], C[f], rays)
        assert torch.equal(T, poses[f - 1]) and torch.equal(fit, fits[f - 1])
    assert _equal(vol, vol_b)


def test_slam_batches_chain_through_the_shared_frame(frames, rays, port_slam):
    """Two batches chained through their shared frame (the last of the
    first batch is index 0 of the second, at its pose) equal one batch; a
    one-frame batch tracks nothing."""
    _, D, C, I, _ = frames
    vol_b, poses, fits = port_slam
    batch = make_device_slam_batch(INTR, CFG, worklist_size=WORKLIST)
    vol, p1, f1 = batch(tsdf.create(CFG.tsdf, "cpu"), torch.eye(4), I[:3], D[:3], C[:3], rays)
    vol, p2, f2 = batch(vol, p1[-1], I[2:], D[2:], C[2:], rays)
    assert torch.equal(torch.cat([p1, p2]), poses) and torch.equal(torch.cat([f1, f2]), fits)
    assert _equal(vol, vol_b)
    v0, p0, f0 = batch(vol, torch.eye(4), I[:1], D[:1], C[:1], rays)
    assert p0.shape == (0, 4, 4) and f0.shape == (0,) and v0 is vol


def test_slam_batch_rejects_a_lost_frame_to_identity(frames, rays):
    """A frame with no depth fails the gate: fitness -1 and identity motion
    (the pose repeats), and the next frame still tracks."""
    _, D, C, I, _ = frames
    D2 = D[:4].clone()
    D2[2] = 0.0
    batch = make_device_slam_batch(INTR, CFG, worklist_size=WORKLIST)
    _, poses, fits = batch(tsdf.create(CFG.tsdf, "cpu"), torch.eye(4), I[:4], D2, C[:4], rays)
    # identity motion, through compose_renormalized's re-orthonormalization
    assert float(fits[1]) == -1.0
    np.testing.assert_allclose(poses[1].numpy(), poses[0].numpy(), rtol=0, atol=1e-6)
    assert float(fits[0]) > 0.3


def test_device_slam_batch_tracks_and_fuses():
    """tests/test_device_slam.py's test (slow there): 6 rendered orbit
    frames at 2 cm voxels in 16^3 blocks; frame 0 integrated at the
    identity first, then the batch: every fit > 0.5, the final pose within
    3 cm / 0.05 rad of the true relative motion, over 50 blocks."""
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=16,
                                         block_capacity=1024, hash_capacity=4096),
                         odometry=OdometryConfig(pyramid_iters=(8, 8, 8)))
    cam = SyntheticCamera(intrinsics=INTR, device="cpu")
    rays = pixel_rays(INTR, "cpu")
    poses = orbit_trajectory(6, radius=0.25, angle_span=0.5)
    rendered = [cam.render(np.asarray(T, np.float32)) for T in poses]
    depths = torch.stack([z for z, _ in rendered])
    colors = torch.stack([c for _, c in rendered])
    intens = torch.stack([rgb_to_intensity(c) for c in colors])
    vol = tk.make_fused_frame_fn(INTR, cfg.tsdf, 512, 2)(tsdf.create(cfg.tsdf, "cpu"), depths[0],
                                                         colors[0], torch.eye(4), rays)
    batch = make_device_slam_batch(INTR, cfg, worklist_size=512, stride=2)
    vol, traj, fits = batch(vol, torch.eye(4), intens, depths, colors, rays)
    assert (fits > 0.5).all(), fits
    T_true = np.linalg.inv(poses[0]) @ poses[-1]
    err = se3.se3_log(torch.as_tensor(np.linalg.inv(T_true) @ traj[-1].numpy().astype(np.float64),
                                      dtype=torch.float32)).numpy()
    assert np.linalg.norm(err[:3]) < 0.03 and np.linalg.norm(err[3:]) < 0.05
    assert int(vol.n_blocks) > 50


# -- on the card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, D, C, I, P = _frames(dev)
    return dev, D, C, I, P, pixel_rays(INTR, dev)


@pytest.mark.cuda
def test_batches_launch_b1_and_b2_on_the_card(card):
    """B1 once a frame in the fused batch, and B1 and B2 once each a
    tracked frame in the SLAM batch; the card's SLAM poses within 1e-4 of
    the CPU's."""
    dev, D, C, I, P, rays = card
    fused = tk.make_fused_batch_fn(INTR, CFG.tsdf, WORKLIST)
    slam = make_device_slam_batch(INTR, CFG, worklist_size=WORKLIST)
    torch.cuda.synchronize()
    build.launches.clear()
    fused(tsdf.create(CFG.tsdf, dev), D, C, P, rays)
    torch.cuda.synchronize()
    assert build.launches[tk.KERNEL] == N_FRAMES and build.launches[odo.KERNEL] == 0
    build.launches.clear()
    _, poses, fits = slam(tsdf.create(CFG.tsdf, dev), torch.eye(4, device=dev), I, D, C, rays)
    torch.cuda.synchronize()
    assert build.launches[tk.KERNEL] == build.launches[odo.KERNEL] == N_FRAMES - 1
    _, cposes, _ = slam(tsdf.create(CFG.tsdf, "cpu"), torch.eye(4), I.cpu(), D.cpu(), C.cpu(),
                        rays.cpu())
    assert (fits > 0.3).all()
    np.testing.assert_allclose(poses.cpu().numpy(), cposes.numpy(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_batches_never_sync(card):
    """After a warm-up, both batches run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    synchronization."""
    dev, D, C, I, P, rays = card
    fused = tk.make_fused_batch_fn(INTR, CFG.tsdf, WORKLIST)
    slam = make_device_slam_batch(INTR, CFG, worklist_size=WORKLIST)
    eye = torch.eye(4, device=dev)
    vf, vs = tsdf.create(CFG.tsdf, dev), tsdf.create(CFG.tsdf, dev)
    vf = fused(vf, D[:2], C[:2], P[:2], rays)
    vs, _, _ = slam(vs, eye, I[:2], D[:2], C[:2], rays)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vf = fused(vf, D, C, P, rays)
        vs, poses, fits = slam(vs, eye, I, D, C, rays)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not bool(vf.overflow) and not bool(vs.overflow) and (fits > 0.3).all()
