"""The live camera's other paths on its color-aligned frames, through the
port against the JAX package: the two-camera rig, the recorder and
relocalization on the frames ``--source k4a`` and ``mkv:`` hand the
pipelines (depth re-projected into each unit's color camera,
``transformed_depth``), with the color camera's intrinsics, at quarter
resolution: 160x144 depth into the 320x180 color camera.

Each unit renders depth with the JAX renderer at its depth camera's pose
(the color camera's pose times the calibration's ``color_from_depth``),
puts it through the port's ``transformed_depth`` with the nominal
calibration (its 32 mm baseline) and quantizes it to u16 mm; color is
rendered at the color camera's pose. Camera 1's color intrinsics differ
from camera 0's by 1.5 px in fx and -1 px in cx (6 and -4 px at
1280x720), as two factory units differ. The rigs are color camera 1's
pose in color camera 0's frame. Both packages get the same numpy frames.
The calibration's fast path on a slid candidate (ROADMAP C21), found on
these frames on the card, is held on depth-camera frames; the recorder's
fallback ladder confirming a wrong pose (C22) on these frames."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu import config as jcfg
from azurekinect3dreconstruction_tpu.core import camera as jcamera
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.io.synthetic import Scene as JScene
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.pipelines.dual_fusion import DualCameraFusion as JDual
from azurekinect3dreconstruction_tpu.pipelines.dual_fusion import (
    make_raw_dual_step as jmake_raw_dual_step,
)
from azurekinect3dreconstruction_tpu.pipelines.recorder import Recorder as JRecorder
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.cli.bench import bench_rig
from azurekinect3dreconstruction_tpu_torch.config import RegistrationConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame
from azurekinect3dreconstruction_tpu_torch.ops.depth_to_color import transformed_depth
from azurekinect3dreconstruction_tpu_torch.pipelines import dual_fusion
from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import (
    FAST_PATH_MAX_SHARE,
    DualCameraFusion,
    make_raw_dual_step,
)
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import MonoOdometryTSDF
from azurekinect3dreconstruction_tpu_torch.pipelines import recorder as recorder_mod
from azurekinect3dreconstruction_tpu_torch.pipelines.recorder import Recorder
from azurekinect3dreconstruction_tpu_torch.tracking import icp
from azurekinect3dreconstruction_tpu_torch.tracking.icp import ICPResult
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

torch.set_num_threads(1)

SCALE = 0.25
_NOMINAL = jcamera.CameraCalibration.azure_kinect_nominal()
JCAL0 = dataclasses.replace(_NOMINAL, depth=_NOMINAL.depth.scaled(SCALE),
                            color=_NOMINAL.color.scaled(SCALE))
JCAL1 = dataclasses.replace(JCAL0, color=dataclasses.replace(
    JCAL0.color, fx=JCAL0.color.fx + 6.0 * SCALE, cx=JCAL0.color.cx - 4.0 * SCALE))
JCALS = (JCAL0, JCAL1)
CALS = tuple(interop.calibration_from(c) for c in JCALS)
JINTRS = tuple(c.color for c in JCALS)
INTRS = tuple(c.color for c in CALS)
# the SMALL_CFG of tests/test_pipelines.py (tests/test_torch_aligned.py's)
JCFG = jcfg.PipelineConfig(
    tsdf=jcfg.TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                         block_capacity=2048, hash_capacity=8192),
    odometry=jcfg.OdometryConfig(pyramid_iters=(8, 8, 8)),
    registration=jcfg.RegistrationConfig(ransac_hypotheses=1024, icp_max_iters=20,
                                         colored_icp_max_iters=30),
    keyframe_interval=1,
    vis_update_interval=2,
)
CFG = interop.pipeline_config_from(JCFG)
# tests/test_torch_dual.py's bench-rig calibrations run the registration defaults
BENCH_CFG = dataclasses.replace(CFG, registration=RegistrationConfig())
# tests/test_relocalize.py's CFG for the loss and recovery
RELOC_CFG = interop.pipeline_config_from(dataclasses.replace(
    JCFG, registration=jcfg.RegistrationConfig(ransac_hypotheses=2048, ransac_rounds=4,
                                               icp_max_iters=20), keyframe_interval=10))
CAMC = JCFG.camera
SCAL = (1.0 / CAMC.depth_scale, CAMC.depth_min, CAMC.depth_trunc)
CALIB_T_LIMIT_M, CALIB_R_LIMIT_RAD = 0.02, 0.03  # tests/test_pipelines.py's bounds
RECORDER_POSE_TOL = 1e-3  # tests/test_torch_recorder.py's
RELOC_T_LIMIT_M, RELOC_R_LIMIT_RAD = 0.06, 0.12  # tests/test_relocalize.py's
TEST_RIG_XI = np.array([0.12, 0.03, -0.02, 0.05, -0.12, 0.04])  # tests/test_torch_dual.py's


class Unit:
    """One k4a unit on the synthetic scene: ``capture(T)`` at the color
    camera's pose ``T`` gives the color-aligned raw frame (u16 mm depth in
    the color camera, u8 RGB); ``noise`` relative depth noise is drawn in
    the depth camera from a numpy generator seeded with ``seed``."""

    def __init__(self, k: int, scene: str = "default", noise: float = 0.0, seed: int = 0):
        sc = getattr(JScene, scene)()
        self.jcal, self.cal = JCALS[k], CALS[k]
        self.cam_d = JCamera(scene=sc, intrinsics=self.jcal.depth)
        self.cam_c = JCamera(scene=sc, intrinsics=self.jcal.color)
        self.rays_d = pixel_rays(self.cal.depth, "cpu")
        self.noise, self.rng = noise, np.random.default_rng(seed)

    def capture(self, T):
        T = np.asarray(T, np.float64)
        z, _ = self.cam_d.render(np.asarray(T @ self.jcal.color_from_depth, np.float32))
        z = np.array(z)
        if self.noise:
            z = np.where(z > 0, z + self.noise * self.rng.standard_normal(z.shape) * z,
                         0).astype(np.float32)
        zc = transformed_depth(torch.from_numpy(z), self.rays_d, self.cal).numpy()
        _, color = self.cam_c.render(np.asarray(T, np.float32))
        return (np.round(zc * 1000.0).astype(np.uint16),
                np.round(np.asarray(color) * 255.0).astype(np.uint8))


def _pose(xi) -> np.ndarray:
    return np.asarray(jse3.se3_exp(np.asarray(xi, np.float64)), np.float64)


def _err(T_est, T_true):
    """(trans m, rot rad) of the relative error."""
    xi = np.asarray(jse3.se3_log(np.linalg.inv(T_true) @ np.asarray(T_est, np.float64)))
    return float(np.linalg.norm(xi[:3])), float(np.linalg.norm(xi[3:]))


def _by_key(v):
    n = int(v["n_blocks"])
    return {tuple(v["block_coords"][s]): s for s in range(n)}


def _pair(rig, scene="default", noise=0.0, seed=0):
    return tuple(Unit(k, scene, noise, seed + k).capture(T)
                 for k, T in enumerate((np.eye(4), rig)))


def _decoded(pair):
    return tuple(RGBDFrame.from_raw(*map(torch.from_numpy, f), CAMC.depth_scale, CAMC.depth_trunc,
                                    CAMC.depth_min) for f in pair)


def test_aligned_dual_step_matches_jax():
    """One aligned pair at the bench rig's true extrinsic, each camera with
    its own color intrinsics, through both packages' dual steps (JAX's
    ``backend="xla"``: allocate + full-pool integrate; the port's: allocate
    + the whole-pool worklist + plain B1): the same blocks, and on every
    voxel weights equal and tsdf and color within B1's 1e-5 (the plain B1
    equals JAX's integrate to the bit where the pose is the same)."""
    rig = bench_rig()
    (d0, c0), (d1, c1) = _pair(rig)
    jrays = tuple(jcamera.pixel_rays(i) for i in JINTRS)
    want = jmake_raw_dual_step(*JINTRS, JCFG.tsdf, backend="xla")(
        jtsdf.create(JCFG.tsdf), *map(jnp.asarray, (d0, c0, d1, c1)), *jrays,
        jnp.eye(4, dtype=jnp.float32), jnp.asarray(rig, jnp.float32), *SCAL, jnp.float32(1.0))
    t = torch.from_numpy
    got = make_raw_dual_step(*INTRS, CFG.tsdf)(
        tsdf.create(CFG.tsdf, "cpu"), t(d0), t(c0), t(d1), t(c1),
        *(pixel_rays(i, "cpu") for i in INTRS), torch.eye(4), interop.pose_to_torch(rig, "cpu"),
        *SCAL, torch.tensor(1.0))
    a, b = interop.volume_to_numpy(got), {k: np.asarray(v) for k, v in want._asdict().items()}
    ka, kb = _by_key(a), _by_key(b)
    assert not bool(a["overflow"]) and ka.keys() == kb.keys() and len(ka) > 50
    rows = lambda v, keys, f: np.stack([v[f][keys[k]].reshape(-1) for k in ka])
    np.testing.assert_array_equal(rows(a, ka, "weight"), rows(b, kb, "weight"))
    for f in ("tsdf", "color"):
        np.testing.assert_allclose(rows(a, ka, f), rows(b, kb, f), atol=1e-5, rtol=0, err_msg=f)


@pytest.mark.parametrize("rig_name, scene, noise, seed", [
    ("bench", "default", 0.0, 0), ("bench", "cluttered", 0.01, 1), ("test", "default", 0.01, 0)])
def test_aligned_rig_autocalibrates(rig_name, scene, noise, seed, tmp_path):
    """``DualCameraFusion.calibrate`` on the aligned pair of the bench rig
    (35 cm apart, toed in 0.26 rad) or tests/test_torch_dual.py's rig, each
    camera with its own color intrinsics, at relative depth noise 0 or
    0.01: accepted within 2 cm / 0.03 rad of color camera 1's pose."""
    rig = bench_rig() if rig_name == "bench" else _pose(TEST_RIG_XI)
    pipe = DualCameraFusion(INTRS, BENCH_CFG, device="cpu", output_dir=str(tmp_path))
    pipe.generator = torch.Generator().manual_seed(seed)
    assert pipe.calibrate(_decoded(_pair(rig, scene, noise, seed)))
    et, er = _err(pipe.extrinsics[1], rig)
    assert et < CALIB_T_LIMIT_M and er < CALIB_R_LIMIT_RAD, (et, er, pipe.calib_scores)


def test_slid_candidate_takes_the_colored_route(monkeypatch, tmp_path):
    """ROADMAP C21: on the card at 1280x720 the point-to-plane candidate of
    best overlap in the cluttered scene landed 8.5 and 17.5 mm off (seeds
    0, 1) with 1.2 and 2.2 % of the pixels in front (0.4 % at the truth),
    under the 3 % gate and within the 3 cm band floor, and was taken
    without the colored refinement. Here every point-to-plane refinement is
    scripted to the bench rig slid 25 mm along x, on depth-camera frames at
    quarter resolution (the aligned frames' own 1.7-2.8 % in front at the
    truth leave no room under the gate at that size; these leave 0.7 %):
    the slid pose passes the gate, so it was taken 25 mm off; now its share
    over ``FAST_PATH_MAX_SHARE`` sends it to the colored refinement, which
    lands within 2 cm / 0.03 rad."""
    rig = bench_rig()
    cam = JCamera(intrinsics=JCAL0.depth)
    frames = _decoded((cam.capture(np.eye(4)), cam.capture(rig)))
    slid = rig.copy()
    slid[0, 3] += 0.025
    intr = CALS[0].depth
    band = icp.free_space_band(frames[0].depth, frames[1].depth)
    T = torch.as_tensor(slid, dtype=torch.float32)
    share = max(float(icp.free_space_shares(frames[0].depth, intr, frames[1].depth,
                                            pixel_rays(intr, "cpu"), T, band)[0]),
                float(icp.free_space_shares(frames[1].depth, intr, frames[0].depth,
                                            pixel_rays(intr, "cpu"), torch.linalg.inv(T),
                                            band)[0]))
    assert FAST_PATH_MAX_SHARE < share <= icp.FREE_SPACE_MAX_SHARE, share
    scripted = lambda *a, **k: ICPResult(T=T.clone(), fitness=torch.tensor(0.9),
                                         inlier_rmse=torch.tensor(0.01),
                                         inliers=torch.tensor(1000, dtype=torch.int32))
    monkeypatch.setattr(dual_fusion, "icp_point_to_plane", scripted)
    pipe = DualCameraFusion((intr, intr), BENCH_CFG, device="cpu", output_dir=str(tmp_path))
    assert pipe.calibrate(frames)
    assert "colored_refine" in pipe.calib_stage_ms
    et, er = _err(pipe.extrinsics[1], rig)
    assert et < CALIB_T_LIMIT_M and er < CALIB_R_LIMIT_RAD, (et, er, pipe.calib_scores)


def test_jax_calibration_of_the_aligned_bench_rig_is_reported(tmp_path, record_property):
    """JAX's auto-calibration on the same aligned bench-rig pair, reported
    and not pinned (ROADMAP C4: with its overlap gate alone it accepts poses
    tens of cm off on this rig): it returns, and its error is recorded."""
    rig = bench_rig()
    pipe = JDual(JINTRS, dataclasses.replace(JCFG, registration=jcfg.RegistrationConfig()),
                 backend="xla", output_dir=str(tmp_path))
    pipe.process_frames(_pair(rig))
    err = _err(pipe.extrinsics[1], rig) if pipe.calibrated else None
    record_property("jax_aligned_bench_rig_calibration", {"calibrated": pipe.calibrated,
                                                          "err_m_rad": err})
    print(f"JAX aligned bench-rig calibration: calibrated {pipe.calibrated}, error {err}")
    assert isinstance(pipe.calibrated, bool)


def test_aligned_recorder_keyframes_match_jax(tmp_path):
    """The recorder over 4 aligned frames of a short orbit (a keyframe every
    frame: colored ICP against the previous keyframe) through both
    packages (JAX's ``backend="xla"``), each with the color intrinsics:
    every keyframe pose within tests/test_torch_recorder.py's 1e-3 of JAX's,
    every keyframe accepted, equal ``n_blocks``, no overflow, and the last
    pose within 5 cm of the color camera's truth."""
    unit = Unit(0)
    poses = [T @ np.linalg.inv(JCAL0.color_from_depth)
             for T in orbit_trajectory(4, radius=0.2, angle_span=0.3)]
    raw = [unit.capture(T) for T in poses]
    jp = JRecorder(JINTRS[0], JCFG, backend="xla", output_dir=str(tmp_path / "jax"))
    pp = Recorder(INTRS[0], CFG, device="cpu", output_dir=str(tmp_path / "port"))
    for p in (jp, pp):
        p.toggle_recording()
        for d, c in raw:
            p.process_frame(d, c)
    np.testing.assert_allclose(np.stack(pp.trajectory), np.stack(jp.trajectory), rtol=0,
                               atol=RECORDER_POSE_TOL)
    assert pp.telemetry._counters == jp.telemetry._counters == {"colored_icp_ok": 3}
    assert int(pp.volume.n_blocks) == int(jp.volume.n_blocks) > 50
    assert not bool(pp.volume.overflow)
    assert _err(pp.T_world_cam, np.linalg.inv(poses[0]) @ poses[-1])[0] < 0.05


def test_fallback_ladder_turns_down_a_pose_that_leaves_free_space_occupied(tmp_path,
                                                                          monkeypatch):
    """ROADMAP C22: on the card at 1280x720 the recorder's ladder confirmed
    the keyframe jump 0.20 m / 0.18 rad off. Here, on the aligned jump pair
    (tests/test_torch_recorder.py's orbit[2] -> orbit[7]), RANSAC and ICP
    are scripted: two restarts land on a pose 0.2 m / 0.18 rad off at
    fitness 0.9, two on the true pose at 0.7. The wrong pose has the higher
    fitness and is confirmed, so the ladder took it; it leaves more than
    ``FREE_SPACE_MAX_SHARE`` of the pixels in front of the other frame's
    surface (the truth under it), and the gate now returns the truth."""
    import types

    unit = Unit(0)
    orbit = orbit_trajectory(8, radius=0.45, angle_span=1.3, height_wobble=0.0)
    prev_T, curr_T = orbit[2], orbit[7]
    raw = [tuple(torch.from_numpy(a) for a in unit.capture(T)) for T in (prev_T, curr_T)]
    truth = np.linalg.inv(prev_T) @ curr_T  # this camera -> the previous keyframe's
    poses = {"true": truth, "wrong": truth @ _pose([0.2, 0.0, 0.0, 0.0, 0.18, 0.0])}
    fitness = {"true": 0.7, "wrong": 0.9}
    draws = iter(["wrong", "true", "wrong", "true"])

    def fake_global(*args, **kwargs):
        return types.SimpleNamespace(T=torch.as_tensor(poses[next(draws)], dtype=torch.float32))

    def fake_icp(src, mask, maps, intr, init, cfg):
        name = min(poses, key=lambda k: np.abs(poses[k] - init.numpy()).max())
        return ICPResult(init, torch.tensor(fitness[name]), torch.tensor(0.0),
                         torch.tensor(1, dtype=torch.int32))

    monkeypatch.setattr(recorder_mod, "global_registration", fake_global)
    monkeypatch.setattr(recorder_mod, "icp_point_to_plane", fake_icp)
    pipe = Recorder(INTRS[0], CFG, device="cpu", output_dir=str(tmp_path))
    frames = _decoded([tuple(a.numpy() for a in r) for r in raw])
    band = icp.free_space_band(frames[0].depth, frames[1].depth)
    rays = pixel_rays(INTRS[0], "cpu")

    def front(T):
        T = torch.as_tensor(T, dtype=torch.float32)
        return max(float(icp.free_space_shares(frames[0].depth, INTRS[0], frames[1].depth, rays,
                                               T, band)[0]),
                   float(icp.free_space_shares(frames[1].depth, INTRS[0], frames[0].depth, rays,
                                               torch.linalg.inv(T), band)[0]))

    assert front(poses["true"]) <= icp.FREE_SPACE_MAX_SHARE < front(poses["wrong"])
    T = pipe._register_fallback(*raw)
    np.testing.assert_allclose(T, poses["true"], atol=1e-6)
    assert pipe.telemetry.counters.get("fallback_retry", 0) == 0
    assert pipe.telemetry.counters["fallback_icp_ok"] == 1
    # the ladder's log: each refinement as the gate read it, the wrong pose turned down
    assert [ok for *_, ok in pipe.ladder] == [False, True, False, True]
    for (T_r, fit, share, ok), name in zip(pipe.ladder, ["wrong", "true", "wrong", "true"]):
        np.testing.assert_allclose(T_r, poses[name], atol=1e-6)
        assert fit == pytest.approx(fitness[name])
        assert share == pytest.approx(front(poses[name]), abs=1e-6)


def test_aligned_loss_and_recovery():
    """tests/test_torch_relocalize.py's occlusion and jump on aligned
    frames: track 6 orbit poses, 6 dark frames, resume 4 poses ahead. The
    loss is declared once, nothing fuses while latched (``n_blocks``
    unchanged), one recovery, and the last pose within 6 cm / 0.12 rad of
    the color camera's truth."""
    unit = Unit(0)
    poses = [T @ np.linalg.inv(JCAL0.color_from_depth)
             for T in orbit_trajectory(16, radius=0.3, angle_span=1.1)]
    world = [np.linalg.inv(poses[0]) @ T for T in poses]
    pipe = MonoOdometryTSDF(INTRS[0], RELOC_CFG, device="cpu", relocalize=True,
                            reloc_min_inliers=500, reloc_window=2, reloc_interval=4)
    for i in range(6):
        pipe.process_frame(*unit.capture(poses[i]))
    nb = int(pipe.volume.n_blocks)
    h, w = INTRS[0].height, INTRS[0].width
    for _ in range(6):
        pipe.process_frame(np.zeros((h, w), np.uint16), np.zeros((h, w, 3), np.uint8))
        assert int(pipe.volume.n_blocks) == nb
    assert pipe.lost
    for i in range(10, 16):
        pipe.process_frame(*unit.capture(poses[i]))
        if pipe.lost:  # still latched: this frame fused nothing
            assert int(pipe.volume.n_blocks) == nb
    assert not pipe.lost, pipe._relocalizer and pipe._relocalizer.last_reject
    assert pipe.counts["tracking_lost"] == 1 and pipe.counts["relocalized"] == 1
    assert int(pipe.volume.n_blocks) > nb and not bool(pipe.volume.overflow)
    et, er = _err(pipe.T_world_cam, world[15])
    assert et < RELOC_T_LIMIT_M and er < RELOC_R_LIMIT_RAD, (et, er)
