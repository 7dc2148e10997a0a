"""The port's tracking-loss recovery against the JAX package: the
``Relocalizer`` (its stride and voxel ladder, the hint rung's pose from one
carried-across volume), ``apply_lost_latch``, the latched raw step, and
``MonoOdometryTSDF(relocalize=True)``. Quarter resolution, the CFG of
tests/test_relocalize.py; the JAX side runs ``backend="xla"`` (the latched
step its Pallas kernels in interpret mode, at (2, 2, 2) iterations).

Every non-slow test of tests/test_relocalize.py has its mirror here, with
that test's bounds, except ``test_streaming_ticks_and_recovery_while_lost``:
the streaming volume is not ported yet. The global rung's RANSAC draws from
a ``torch.Generator``, not JAX's key, so its results are held to the JAX
tests' bounds, not to JAX's poses."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu import config as jcfg
from azurekinect3dreconstruction_tpu.core import camera as jcamera
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.core.types import RGBDFrame as JRGBDFrame
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.pipelines import mono_odometry_tsdf as jmono
from azurekinect3dreconstruction_tpu.tracking.relocalize import Relocalizer as JRelocalizer
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
    MonoOdometryTSDF,
    apply_lost_latch,
    make_raw_slam_step,
)
from azurekinect3dreconstruction_tpu_torch.tracking.relocalize import Relocalizer
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

torch.set_num_threads(1)

JINTR = jcamera.Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
INTR = interop.intrinsics_from(JINTR)
# the CFG of tests/test_relocalize.py
JCFG = jcfg.PipelineConfig(
    tsdf=jcfg.TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                         block_capacity=2048, hash_capacity=8192),
    odometry=jcfg.OdometryConfig(pyramid_iters=(8, 8, 8)),
    registration=jcfg.RegistrationConfig(ransac_hypotheses=2048, ransac_rounds=4,
                                         icp_max_iters=20),
)
CFG = interop.pipeline_config_from(JCFG)
CAMC = JCFG.camera
SCAL = (1.0 / CAMC.depth_scale, CAMC.depth_min, CAMC.depth_trunc)
POSE_TOL = 1e-4  # the hint rung and the latched step against JAX's


@pytest.fixture(scope="module")
def cam():
    return JCamera(intrinsics=JINTR)


def _pose_err(T_est, T_true):
    """(trans_m, rot_norm) of the relative error."""
    xi = np.asarray(jse3.se3_log(np.linalg.inv(T_true) @ np.asarray(T_est)))
    return float(np.linalg.norm(xi[:3])), float(np.linalg.norm(xi[3:]))


def _meters(d, c):
    return d.astype(np.float32) / 1000.0, c.astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def fused_orbit(cam):
    """An 8-pose orbit fused at known poses with pose 4 held out, in JAX
    (``backend="xla"``): (poses, world poses, the JAX volume as numpy)."""
    poses = orbit_trajectory(8, radius=0.3, angle_span=0.9)
    world = [np.linalg.inv(poses[0]) @ T for T in poses]
    jrays = jcamera.pixel_rays(JINTR)
    vol = jtsdf.create(JCFG.tsdf)
    for i in range(8):
        if i == 4:
            continue
        dm, cf = _meters(*cam.capture(poses[i]))
        vol = jtsdf.integrate_frame(vol, dm, cf, jrays, world[i], JINTR, JCFG.tsdf, backend="xla")
    return poses, world, {k: np.asarray(v) for k, v in vol._asdict().items()}


def _reloc(**kw):
    return Relocalizer(INTR, CFG, device="cpu", min_inliers=500, model_points=16384, **kw)


def _dark(cam):
    h, w = JINTR.height, JINTR.width
    return np.zeros((h, w), np.uint16), np.zeros((h, w, 3), np.uint8)


def _pipe(**kw):
    return MonoOdometryTSDF(INTR, CFG, device="cpu", relocalize=True, reloc_min_inliers=500,
                            **kw)


# -- mirrors of tests/test_relocalize.py -------------------------------------------


def test_relocalizer_recovers_heldout_pose(cam, fused_orbit):
    """A frame from a pose the volume never tracked, with a neighbor pose as
    the hint: within 5 cm / 0.1 rad of the truth, one success."""
    poses, world, st = fused_orbit
    reloc = _reloc()
    dm, cf = _meters(*cam.capture(poses[4]))
    T = reloc.attempt(interop.volume_from_jax_arrays(st, "cpu"), dm, cf,
                      T_hint=world[2])
    assert T is not None, f"relocalization rejected: {reloc.last_reject}"
    t_err, r_err = _pose_err(T, world[4])
    assert t_err < 0.05, f"translation error {t_err}"
    assert r_err < 0.1, f"rotation error {r_err}"
    assert reloc.n_success == 1


def test_relocalizer_rejects_empty_frame():
    reloc = Relocalizer(INTR, CFG, device="cpu")
    assert reloc.attempt(tsdf.create(CFG.tsdf, "cpu"),
                         np.zeros((INTR.height, INTR.width), np.float32),
                         np.zeros((INTR.height, INTR.width, 3), np.float32)) is None
    assert reloc.last_reject == "empty_frame"


def test_relocalizer_hint_rung_recovers_without_descriptors(cam, fused_orbit):
    poses, world, st = fused_orbit
    reloc = _reloc()
    dm, cf = _meters(*cam.capture(poses[4]))
    T = reloc.attempt(interop.volume_from_jax_arrays(st, "cpu"), dm, cf,
                      T_hint=world[3])
    assert T is not None, f"relocalization rejected: {reloc.last_reject}"
    t_err, r_err = _pose_err(T, world[4])
    assert t_err < 0.05 and r_err < 0.1, (t_err, r_err)
    assert reloc.n_hint_success == 1, "recovery should come from rung 0"


def test_relocalizer_wrong_hint_never_returns_wrong_pose(cam, fused_orbit):
    """A hint far outside any ICP basin: rung 0's gate rejects, and the
    global rung returns a correct pose or None, never a wrong one."""
    poses, world, st = fused_orbit
    reloc = _reloc()
    dm, cf = _meters(*cam.capture(poses[4]))
    bad_hint = np.asarray(world[4], np.float64).copy()
    bad_hint[:3, 3] += [0.9, -0.6, 0.8]
    T = reloc.attempt(interop.volume_from_jax_arrays(st, "cpu"), dm, cf,
                      T_hint=bad_hint)
    assert reloc.n_hint_success == 0, "rung 0 must not accept a wrong basin"
    if T is not None:
        t_err, r_err = _pose_err(T, world[4])
        assert t_err < 0.05 and r_err < 0.1, (t_err, r_err)


@pytest.mark.parametrize("xi, in_basin", [
    ((0.025, -0.026, 0.125, 0.025, -0.128, 0.086), True),
    ((0.0, 0.0, 0.0, -0.137, -0.001, 0.074), False),  # a tilt
    ((0.003, 0.129, 0.012, 0.0, 0.0, 0.0), False),  # a slide
    ((-0.114, -0.011, -0.061, -0.118, -0.088, -0.051), False),
], ids=["in_basin", "tilt", "slide", "tilt_and_slide"])
def test_global_rung_gates_its_refinement_on_overlap(cam, fused_orbit, monkeypatch, xi,
                                                     in_basin):
    """The global rung with its RANSAC winner scripted to a pose ``xi`` (se3,
    camera frame) off the truth and a hint far outside any basin. A winner
    in ICP's basin refines to the truth and is returned; one outside it
    refines to a wrong pose that still has thousands of ICP inliers, so an
    inlier count alone returned it (ROADMAP C12): the projective overlap
    gate of rung 0 rejects it."""
    from types import SimpleNamespace

    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.tracking import relocalize

    poses, world, st = fused_orbit
    seed = world[4] @ se3.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()
    # a winner with the consensus of the orbit's own (32 of 200, no rival), so that what
    # decides is the refinement's gate
    monkeypatch.setattr(relocalize, "global_registration", lambda *a, **k: SimpleNamespace(
        T=torch.as_tensor(seed, dtype=torch.float32), fitness=torch.tensor(0.16),
        n_correspondences=torch.tensor(200), rival=torch.tensor(0)))
    reloc = _reloc(restarts=1)
    dm, cf = _meters(*cam.capture(poses[4]))
    bad_hint = np.asarray(world[4], np.float64).copy()
    bad_hint[:3, 3] += [0.9, -0.6, 0.8]
    T = reloc.attempt(interop.volume_from_jax_arrays(st, "cpu"), dm, cf,
                      T_hint=bad_hint)
    assert reloc.n_hint_success == 0
    if in_basin:
        assert T is not None, reloc.last_reject
        t_err, r_err = _pose_err(T, world[4])
        assert t_err < 0.05 and r_err < 0.1, (t_err, r_err)
    else:
        assert T is None, f"a wrong pose returned: {_pose_err(T, world[4])}"
        assert reloc.last_reject.startswith("icp overlap"), reloc.last_reject


@pytest.mark.parametrize("n_f, n_rival, held", [(32, 0, True), (6, 0, False), (32, 26, False)],
                         ids=["held", "no_consensus", "rivalled"])
def test_global_rung_gates_its_winner_on_consensus(cam, fused_orbit, monkeypatch, n_f, n_rival,
                                                   held):
    """The global rung with its RANSAC winner scripted to the truth and a
    hint far outside any basin. With the orbit's own consensus (32 inliers,
    no rival) it recovers; with 6 inliers (the corridor's winners hold 0
    to 8: the overlap passes a plane anywhere on a plane, and ICP pulls
    the pose to the nearest repeat, ROADMAP C15) or a rival holding 26 of
    32 (a repeat as well supported as the winner) the consensus gate turns
    it down, before any refinement."""
    from types import SimpleNamespace

    from azurekinect3dreconstruction_tpu_torch.tracking import relocalize

    poses, world, st = fused_orbit
    monkeypatch.setattr(relocalize, "global_registration", lambda *a, **k: SimpleNamespace(
        T=torch.as_tensor(world[4], dtype=torch.float32), fitness=torch.tensor(n_f / 200),
        n_correspondences=torch.tensor(200), rival=torch.tensor(n_rival)))
    reloc = _reloc(restarts=1)
    dm, cf = _meters(*cam.capture(poses[4]))
    bad_hint = np.asarray(world[4], np.float64).copy()
    bad_hint[:3, 3] += [0.9, -0.6, 0.8]
    T = reloc.attempt(interop.volume_from_jax_arrays(st, "cpu"), dm, cf, T_hint=bad_hint)
    assert reloc.n_hint_success == 0 and reloc.last_consensus == (n_f, n_rival)
    if held:
        assert T is not None, reloc.last_reject
        t_err, r_err = _pose_err(T, world[4])
        assert t_err < 0.05 and r_err < 0.1, (t_err, r_err)
        assert reloc.n_consensus_rejects == 0
    else:
        assert T is None and reloc.n_consensus_rejects == 1
        assert reloc.last_reject == f"global consensus {n_f}, rival {n_rival}"


def test_pipeline_relocalizes_after_occlusion_and_jump(cam):
    """Track, lose the view (6 dark frames), resume far ahead: the loss is
    declared once, nothing fuses while rejected or lost, the pipeline
    relocalizes from the fused model and ends within 6 cm / 0.12 rad. (The
    JAX original is marked slow; here it takes a few seconds on the CPU.)"""
    poses = orbit_trajectory(16, radius=0.3, angle_span=1.1)
    world = [np.linalg.inv(poses[0]) @ T for T in poses]
    pipe = _pipe(reloc_window=2, reloc_interval=4)
    for i in range(6):
        pipe.process_frame(*cam.capture(poses[i]))
    nb_before = int(pipe.volume.n_blocks)
    for _ in range(6):
        pipe.process_frame(*_dark(cam))
    assert pipe.lost, "6 straight rejections at window=2 must declare loss"
    assert int(pipe.volume.n_blocks) == nb_before
    for i in range(10, 16):
        pipe.process_frame(*cam.capture(poses[i]))
    assert not pipe.lost, (pipe._relocalizer and pipe._relocalizer.last_reject)
    assert pipe.counts["tracking_lost"] == 1
    assert pipe.counts["relocalized"] == 1
    assert int(pipe.volume.n_blocks) > nb_before
    t_err, r_err = _pose_err(pipe.T_world_cam, world[15])
    assert t_err < 0.06, f"post-recovery translation error {t_err}"
    assert r_err < 0.12, f"post-recovery rotation error {r_err}"


def test_lost_latch_blocks_gate_passing_frames(cam):
    """With lost_in=1 a perfectly tracked frame allocates nothing and the
    latch stays up; with lost_in=0 the same frame fuses."""
    step = make_raw_slam_step(INTR, CFG, integrate_rejected=False)
    rays = pixel_rays(INTR, "cpu")
    d, c = cam.capture()
    prev = RGBDFrame.from_raw(torch.from_numpy(d), torch.from_numpy(c), 1000.0, 3.0, 0.1)
    T0 = torch.eye(4)
    args = (prev.intensity, prev.depth, torch.from_numpy(d), torch.from_numpy(c), rays,
            1e-3, 0.1, 3.0)
    vol, _T, fit, _i, _d, lost = step(tsdf.create(CFG.tsdf, "cpu"), T0, *args,
                                      torch.ones(()))
    assert float(fit) > 0.3, "identical frames must track"
    assert float(lost) == 1.0, "only the host clears the latch"
    assert int(vol.n_blocks) == 0, "latched frame must not allocate"
    vol, _T, fit, _i, _d, lost = step(vol, T0, *args, torch.zeros(()))
    assert float(lost) == 0.0
    assert int(vol.n_blocks) > 0, "unlatched frame fuses normally"


def test_pipeline_transient_rejection_resumes_fusion(cam):
    """A rejection burst shorter than the window declares no loss: the check
    clears the latch, fusion resumes, the paused frames are counted."""
    poses = orbit_trajectory(12, radius=0.25, angle_span=0.7)
    pipe = _pipe(reloc_window=3, reloc_interval=4)
    for i in range(6):
        pipe.process_frame(*cam.capture(poses[i]))
    pipe.process_frame(*_dark(cam))
    for i in range(6, 12):
        pipe.process_frame(*cam.capture(poses[i]))
    assert not pipe.lost
    assert pipe.counts.get("tracking_lost", 0) == 0
    assert pipe.counts.get("fusion_paused_frames", 0) >= 1
    world = [np.linalg.inv(poses[0]) @ T for T in poses]
    t_err, r_err = _pose_err(pipe.T_world_cam, world[11])
    assert t_err < 0.06, f"translation error {t_err}"
    assert r_err < 0.12, f"rotation error {r_err}"


def test_warmup_is_invisible_to_episode_state():
    """warmup() runs the attempt path and leaks nothing observable: the
    counters, last_reject, the generator's state and the model cache."""
    reloc = _reloc(restarts=1)
    reloc.last_reject = "sentinel"
    state_before = reloc.generator.get_state().clone()
    assert reloc.warmup() > 0.0
    assert reloc.n_attempts == 0 and reloc.n_success == 0 and reloc.n_hint_success == 0
    assert reloc.last_reject == "sentinel"
    assert reloc._model_cache is None
    assert torch.equal(reloc.generator.get_state(), state_before)


def test_pipeline_reloc_warmup_flag(monkeypatch):
    called = []
    monkeypatch.setattr(Relocalizer, "warmup", lambda self, vol=None: called.append(1) or 0.0)
    pipe = MonoOdometryTSDF(INTR, CFG, device="cpu", relocalize=True, reloc_warmup=True)
    assert called == [1]
    assert pipe._relocalizer is not None


def test_mid_window_rejection_streak_declares_loss(cam):
    """A streak >= the window that ends before the check still declares the
    loss, and none of the gate-passing frames after it fuse."""
    poses = orbit_trajectory(16, radius=0.3, angle_span=1.1)
    pipe = _pipe(reloc_window=3, reloc_interval=8)
    for i in range(8):
        pipe.process_frame(*cam.capture(poses[i]))
    assert not pipe.lost
    nb = int(pipe.volume.n_blocks)
    for _ in range(4):
        pipe.process_frame(*_dark(cam))
    for i in range(12, 16):
        pipe.process_frame(*cam.capture(poses[i]))
    assert pipe.lost, "mid-window streak of 4 >= window 3 must declare loss"
    assert pipe.counts["tracking_lost"] == 1
    assert int(pipe.volume.n_blocks) == nb


def test_latch_survives_check_boundary_mid_streak(cam):
    """A short streak that reaches the check keeps the latch up; a later
    check that sees it resolved clears it and counts the 6 paused frames."""
    poses = orbit_trajectory(16, radius=0.25, angle_span=0.8)
    pipe = _pipe(reloc_window=4, reloc_interval=4)
    for i in range(6):
        pipe.process_frame(*cam.capture(poses[i]))
    nb = int(pipe.volume.n_blocks)
    for _ in range(2):
        pipe.process_frame(*_dark(cam))
    assert not pipe.lost
    assert pipe._latch_up, "check at the streak edge must keep the latch up"
    for i in range(8, 11):
        pipe.process_frame(*cam.capture(poses[i]))
    assert int(pipe.volume.n_blocks) == nb, \
        "gate-passing frames must not fuse while the latch is up"
    pipe.process_frame(*cam.capture(poses[11]))
    assert not pipe.lost
    assert not pipe._latch_up
    assert pipe.counts.get("tracking_lost", 0) == 0
    assert pipe.counts["fusion_paused_frames"] == 6
    for i in range(12, 16):
        pipe.process_frame(*cam.capture(poses[i]))
    assert int(pipe.volume.n_blocks) > nb


def test_model_cache_keyed_on_volume_contents(cam):
    """Re-fusing the same frame into the same blocks updates the pools in
    place (the same tensors, n_blocks unchanged): the cache must miss. The
    same volume again hits."""
    rays = pixel_rays(INTR, "cpu")
    poses = orbit_trajectory(4, radius=0.3, angle_span=0.4)
    dm, cf = (torch.from_numpy(a) for a in _meters(*cam.capture(poses[0])))
    vol = tsdf.integrate_frame(tsdf.create(CFG.tsdf, "cpu"), dm, cf, rays, torch.eye(4), INTR,
                               CFG.tsdf)
    reloc = _reloc(restarts=1)
    reloc.attempt(vol, dm, cf, T_hint=np.eye(4))
    key1 = reloc._model_cache[0]
    nb = int(vol.n_blocks)
    vol2 = tsdf.integrate_frame(vol, dm, cf, rays, torch.eye(4), INTR, CFG.tsdf)
    assert int(vol2.n_blocks) == nb and vol2.tsdf.data_ptr() == vol.tsdf.data_ptr()
    reloc.attempt(vol2, dm, cf, T_hint=np.eye(4))
    assert reloc._model_cache[0] != key1, "updated volume contents must miss the model cache"
    key2 = reloc._model_cache[0]
    model = reloc._model_cache[1]
    reloc.attempt(vol2, dm, cf, T_hint=np.eye(4))
    assert reloc._model_cache[0] == key2 and reloc._model_cache[1] is model


def test_auto_stride_respects_point_budget():
    full = Intrinsics.azure_kinect_depth_nfov()
    r = Relocalizer(full, CFG, device="cpu")
    assert r.stride == 4
    n_pts = -(-full.height // r.stride) * -(-full.width // r.stride)
    assert n_pts <= 36000


# -- against the JAX package ---------------------------------------------------------


def test_stride_and_voxel_ladder_match_jax(cam, fused_orbit):
    """The auto stride at several scales, and the fitted ladder voxel of the
    model samples, of a frame cloud and of a dense cloud that climbs the
    ladder, equal JAX's."""
    for s in (1.0, 0.5, 0.25, 0.1):
        ji = jcamera.Intrinsics.azure_kinect_depth_nfov().scaled(s)
        assert (Relocalizer(interop.intrinsics_from(ji), CFG, device="cpu").stride
                == JRelocalizer(ji, JCFG).stride)
    poses, _, st = fused_orbit
    from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as jmc

    jv = jtsdf.TSDFVolume(**{k: jnp.asarray(v) for k, v in st.items()})
    mp, mm, _ = jmc.extract_surface_samples(jv, JCFG.tsdf, 16384)
    frame = np.asarray(jcamera.pixel_rays(JINTR))  # (H, W, 2)
    dm, cf = _meters(*cam.capture(poses[4]))
    src = np.concatenate([frame * dm[..., None], dm[..., None]], -1).reshape(-1, 3)
    dense = np.random.RandomState(0).uniform(-1.0, 1.0, (40000, 3)).astype(np.float32)
    jr, pr = JRelocalizer(JINTR, JCFG, feature_points=2048), _reloc(feature_points=2048)
    climbed = []
    for pts, mask in ((np.asarray(mp), np.asarray(mm)), (src, src[:, 2] > 0),
                      (dense, np.ones(len(dense), bool))):
        want = jr._fit_voxel(jnp.asarray(pts), jnp.asarray(mask))
        got = pr._fit_voxel(torch.from_numpy(np.array(pts)), torch.from_numpy(np.array(mask)))
        assert got == want
        climbed.append(got > pr.downsample_voxel)
    assert climbed[-1]


def test_apply_lost_latch_matches_jax():
    rng = np.random.RandomState(1)
    depth = rng.uniform(0.0, 3.0, (6, 7)).astype(np.float32)
    depth[0, :3] = 0.0
    for lost_in in (0.0, 1.0):
        for fit in (-1.0, -1e-7, 0.0, 0.2, 0.31, 0.9, np.nan):
            jl, jd = jmono.apply_lost_latch(np.float32(lost_in), jnp.float32(fit), depth)
            pl, pd = apply_lost_latch(torch.tensor(lost_in), torch.tensor(fit, dtype=torch.float32),
                                      torch.from_numpy(depth))
            assert float(pl) == float(jl), (lost_in, fit)
            np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("lost_in", [0.0, 1.0])
def test_latched_step_matches_jax(cam, lost_in):
    """One latched step from a carried-across state, against JAX's Pallas
    step in interpret mode at (2, 2, 2) iterations: the same ``lost`` and
    ``n_blocks`` (unchanged when latched), pose <= 1e-4."""
    jc = dataclasses.replace(JCFG, odometry=jcfg.OdometryConfig(pyramid_iters=(2, 2, 2)))
    pc = interop.pipeline_config_from(jc)
    poses = orbit_trajectory(5, radius=0.25, angle_span=0.5)
    (d0, c0), (d1, c1) = cam.capture(poses[0]), cam.capture(poses[1])
    f0 = JRGBDFrame.from_raw(d0, c0, CAMC.depth_scale, CAMC.depth_trunc, CAMC.depth_min)
    jrays = jcamera.pixel_rays(JINTR)
    eye = np.eye(4, dtype=np.float32)
    vj = jtsdf.integrate_frame(jtsdf.create(jc.tsdf), f0.depth, f0.color, jrays,
                               jnp.asarray(eye), JINTR, jc.tsdf, backend="xla")
    state = {k: np.asarray(v) for k, v in vj._asdict().items()}
    vt = interop.volume_from_jax_arrays(state, "cpu")
    jstep = jmono.make_raw_slam_step(JINTR, jc, worklist_size=2048, backend="pallas",
                                     interpret=True, integrate_rejected=False)
    vj, Tj, fitj, _, _, lostj = jstep(vj, jnp.asarray(eye), f0.intensity, f0.depth, d1, c1,
                                      jrays, *SCAL, np.float32(lost_in))
    tstep = make_raw_slam_step(INTR, pc, worklist_size=2048, integrate_rejected=False)
    vt, Tt, fitt, _, _, lostt = tstep(vt, torch.eye(4), torch.from_numpy(np.array(f0.intensity)),
                                      torch.from_numpy(np.array(f0.depth)), torch.from_numpy(d1),
                                      torch.from_numpy(c1), pixel_rays(INTR, "cpu"), *SCAL,
                                      torch.tensor(lost_in))
    assert float(lostt) == float(lostj) == lost_in  # the frame tracks: only lost_in decides
    assert float(fitt) > 0.3 and float(fitj) > 0.3
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=POSE_TOL)
    assert int(vt.n_blocks) == int(vj.n_blocks)
    if lost_in:
        assert int(vt.n_blocks) == int(state["n_blocks"])
        np.testing.assert_array_equal(vt.weight.numpy().reshape(state["weight"].shape),
                                      state["weight"])
    else:
        assert int(vt.n_blocks) > int(state["n_blocks"])


def test_hint_rung_pose_matches_jax(cam, fused_orbit):
    """From one carried-across volume, the same frame and neighbor hint: both
    recover by rung 0, poses within 1e-4. The orbit's surface overflows a
    16,384-point sample, where the port samples near the hint and JAX keeps
    the oldest blocks (ROADMAP C9), so both sample 32,768 points, within
    budget, and build the same model."""
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc

    poses, world, st = fused_orbit
    vol = interop.volume_from_jax_arrays(st, "cpu")
    assert not bool(mc.extract_surface_samples(vol, CFG.tsdf, 32768)[2])
    dm, cf = _meters(*cam.capture(poses[4]))
    jr = JRelocalizer(JINTR, JCFG, min_inliers=500, model_points=32768)
    Tj = jr.attempt(jtsdf.TSDFVolume(**{k: jnp.asarray(v) for k, v in st.items()}), dm,
                    T_hint=world[3])
    pr = Relocalizer(INTR, CFG, device="cpu", min_inliers=500, model_points=32768)
    Tp = pr.attempt(vol, dm, cf, T_hint=world[3])
    assert Tj is not None and Tp is not None, (jr.last_reject, pr.last_reject)
    assert jr.n_hint_success == pr.n_hint_success == 1
    assert Tp.dtype == np.float64
    np.testing.assert_allclose(Tp, Tj, rtol=0, atol=POSE_TOL)


def test_frame_to_model_with_relocalize_raises():
    with pytest.raises(ValueError):
        MonoOdometryTSDF(INTR, CFG, device="cpu", tracking="frame_to_model", relocalize=True)


def test_reset_clears_the_loss_state(cam):
    """A lost pipeline's reset returns it to a fresh, unlatched state, and
    the lost frames appear in the trajectory with the stale pose."""
    poses = orbit_trajectory(6, radius=0.25, angle_span=0.4)
    pipe = _pipe(reloc_window=2, reloc_interval=2)
    for i in range(3):
        pipe.process_frame(*cam.capture(poses[i]))
    for _ in range(5):
        pipe.process_frame(*_dark(cam))
    assert pipe.lost and pipe.counts["tracking_lost"] == 1
    traj = pipe.trajectory
    assert len(traj) == 9 and np.array_equal(traj[-1], traj[-2])
    assert pipe.counts.get("reloc_failed", 0) >= 1  # dark frames cannot register
    pipe.reset()
    assert not pipe.lost and not pipe._latch_up and float(pipe._lost) == 0.0
    assert pipe.counts == {} and len(pipe.trajectory) == 1
    pipe.process_frame(*cam.capture(poses[0]))
    pipe.process_frame(*cam.capture(poses[1]))
    assert int(pipe.volume.n_blocks) > 0 and pipe.odometry_failures == 0


def _corridor_camera():
    """bench.py's streaming corridor (a checkered wall 0.55 m ahead, 33
    spheres along +x) at quarter resolution, rendered by the port."""
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import Plane, Scene, Sphere
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera

    scene = Scene(
        planes=(Plane((0.0, 0.0, 0.55), (0.0, 0.0, -1.0), (0.7, 0.65, 0.6), checker=0.1),),
        spheres=tuple(Sphere((0.3 * k, 0.1 * (-1) ** k, 0.5), 0.05,
                             (0.3 + 0.5 * (k % 2), 0.4, 0.8 - 0.5 * (k % 2))) for k in range(33)))
    return SyntheticCamera(scene=scene, intrinsics=INTR, device="cpu")


def test_late_loss_in_a_map_over_the_sample_budget_recovers():
    """A loss late in a long sweep (ROADMAP C9): 52 frames 4 cm apart along
    the corridor, at 1 cm voxels, fill the volume past the relocalizer's
    sample budget (``model_points`` 8,192: 10,922 emitted triangles); 4 dark
    frames declare the loss, and the camera reappears at the next sweep
    pose. ``extract_surface_samples`` keeps the oldest blocks, which no
    point of the late frame sees, so the reference's model leaves nothing
    to register against; the port samples the blocks near the hint and
    recovers, then tracks on, within tests/test_relocalize.py's bounds
    (< 6 cm / 0.12 rad)."""
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import TargetMaps, projective_overlap
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc

    cfg = dataclasses.replace(
        CFG, tsdf=CFG.tsdf.replace(voxel_size=0.01, sdf_trunc=0.04, block_capacity=4096,
                                   hash_capacity=16384),
        camera=CFG.camera.replace(depth_trunc=0.7))
    cam = _corridor_camera()
    poses = [np.eye(4) for _ in range(58)]
    for i, T in enumerate(poses):
        T[0, 3] = 0.04 * i
    pipe = MonoOdometryTSDF(INTR, cfg, device="cpu", relocalize=True, reloc_window=2,
                            reloc_interval=4, reloc_min_inliers=500, model_points=8192)
    for T in poses[:52]:
        pipe.process_frame(*cam.capture(T))
    assert pipe.odometry_failures == 0
    old, old_mask, ovf = mc.extract_surface_samples(pipe.volume, cfg.tsdf, 8192)
    assert bool(ovf), "the sweep must overflow the sample budget"
    for _ in range(4):
        pipe.process_frame(*_dark(cam))
    assert pipe.lost and pipe.counts["tracking_lost"] == 1
    depth, color = cam.capture(poses[52])
    pipe.process_frame(depth, color)
    assert not pipe.lost and pipe.counts.get("relocalized") == 1, pipe._relocalizer.last_reject
    assert pipe._relocalizer.n_hint_success == 1
    # the reference's model: no point of it is visible in the frame that recovered
    frame = RGBDFrame.from_raw(torch.from_numpy(depth), torch.from_numpy(color))
    maps = TargetMaps.from_depth(frame.depth, pipe.rays)
    T_cw = torch.as_tensor(np.linalg.inv(pipe.T_world_cam), dtype=torch.float32)
    _, vis_old, _ = projective_overlap(old, old_mask, maps, INTR, T_cw)
    _, model, mask, _, _, _ = pipe._relocalizer._model_cache
    n_m, vis_new, _ = projective_overlap(model, mask, maps, INTR, T_cw)
    assert int(vis_old) == 0 and int(vis_new) >= 500, (int(vis_old), int(vis_new))
    # the two samples are disjoint along the corridor: the oldest blocks, and those near the hint
    assert float(old[old_mask][:, 0].max()) < float(model[mask][:, 0].min())
    for T in poses[53:]:
        pipe.process_frame(*cam.capture(T))
    assert not pipe.lost and pipe.counts.get("tracking_lost") == 1
    t_err, r_err = _pose_err(pipe.T_world_cam, poses[-1])
    assert t_err < 0.06 and r_err < 0.12, (t_err, r_err)


@pytest.mark.parametrize("slide", [0.0, 0.14], ids=["at_the_truth", "slid_14cm"])
def test_hint_rung_gates_a_pose_slid_along_the_wall(slide):
    """The corridor's checkered wall and spheres fused at their true poses
    (x 0 to 0.96 m, 2 cm voxels); a frame from x = 0.48 m. Seeded at the
    truth, rung 0 recovers within 1 cm / 0.02 rad. Seeded 14 cm along the
    wall, the geometry holds no slide and rung 0's pose stays 14 cm off,
    with thousands of inliers and the overlap gate passed: the slide gate
    turns it down, and whatever the attempt returns is within 6 cm / 0.12
    rad (ROADMAP C15)."""
    cfg = dataclasses.replace(CFG, camera=CFG.camera.replace(depth_trunc=0.7))
    cam = _corridor_camera()
    rays = pixel_rays(INTR, "cpu")
    vol = tsdf.create(cfg.tsdf, "cpu")
    pose = lambda x: np.array([[1, 0, 0, x], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                              np.float64)
    decode = lambda d, c: RGBDFrame.from_raw(torch.from_numpy(d), torch.from_numpy(c),
                                             CAMC.depth_scale, 0.7, CAMC.depth_min)
    for i in range(13):
        f = decode(*cam.capture(pose(0.08 * i)))
        vol = tsdf.integrate_frame(vol, f.depth, f.color, rays,
                                   torch.as_tensor(pose(0.08 * i), dtype=torch.float32), INTR,
                                   cfg.tsdf)
    f = decode(*cam.capture(pose(0.48)))
    reloc = Relocalizer(INTR, cfg, device="cpu", min_inliers=500, restarts=1)
    T = reloc.attempt(vol, f.depth, f.color, T_hint=pose(0.48 + slide))
    if not slide:
        assert T is not None and reloc.n_hint_success == 1, reloc.last_reject
        t_err, r_err = _pose_err(T, pose(0.48))
        assert t_err < 0.01 and r_err < 0.02, (t_err, r_err)
        assert reloc.n_texture_rejects == reloc.n_free_space_rejects == 0
    else:
        assert reloc.n_texture_rejects + reloc.n_free_space_rejects >= 1
        if T is not None:
            t_err, r_err = _pose_err(T, pose(0.48))
            assert t_err < 0.06 and r_err < 0.12, (t_err, r_err)


def test_slice_modules_import_without_jax():
    """With jax made unimportable, both new modules and the extended
    pipeline and marching cubes import and pull in no jax."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["tracking.relocalize", "tsdf.incremental", "pipelines.mono_odometry_tsdf",
            "tsdf.marching_cubes", "tsdf.volume"]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            + "".join(f"importlib.import_module('azurekinect3dreconstruction_tpu_torch.{m}')\n"
                      for m in mods)
            + "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]\n"
            + "assert 'azurekinect3dreconstruction_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
