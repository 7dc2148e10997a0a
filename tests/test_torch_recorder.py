"""The port's recorder against the JAX package: ``Telemetry`` and the log
prefixes, ``MotionModel``, the recorder's keyframe and interval steps
(JAX's ``backend="xla"``), the ``Recorder`` over a short orbit and over a
keyframe jump that the fallback ladder must recover, and its saves read
back. Quarter resolution, the SMALL_CFG of tests/test_pipelines.py. Each
tolerance is stated where it is used."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from azurekinect3dreconstruction_tpu import config as jcfg
from azurekinect3dreconstruction_tpu.core import camera as jcamera
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.pipelines.recorder import Recorder as JRecorder
from azurekinect3dreconstruction_tpu.pipelines.recorder import (
    make_raw_recorder_steps as jmake_steps,
)
from azurekinect3dreconstruction_tpu.tracking.motion import MotionModel as JMotionModel
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu.utils import telemetry as jtelemetry
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu_torch.pipelines.recorder import (
    Recorder,
    make_raw_recorder_steps,
)
from azurekinect3dreconstruction_tpu_torch.tracking.motion import MotionModel
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.utils import telemetry
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver, read_geometry

torch.set_num_threads(1)

JINTR = jcamera.Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
INTR = interop.intrinsics_from(JINTR)
# the SMALL_CFG of tests/test_pipelines.py
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
CAMC = JCFG.camera
SCAL = (1.0 / CAMC.depth_scale, CAMC.depth_min, CAMC.depth_trunc)
# B1's tolerances (kernel against plain version): weights equal on >= 99.99 %,
# tsdf and color <= 1e-5 where they agree
B1_WEIGHT_EQUAL_MIN = 0.9999
B1_VALUE_TOL = 1e-5


@pytest.fixture(scope="module")
def cam():
    return JCamera(intrinsics=JINTR)


def _keyed(fields):
    """A volume's blocks by key (numpy field dicts, JAX layout)."""
    n = int(fields["n_blocks"])
    keys = [tuple(k) for k in fields["block_coords"][:n].tolist()]
    rows = {f: fields[f][:n].reshape(n, -1) for f in ("weight", "tsdf", "color")}
    return {k: {f: rows[f][s] for f in rows} for s, k in enumerate(keys)}


def _assert_close_volumes(got, want, edge_share: float = 0.0):
    """The same block keys; weights equal on >= 99.99 % of the voxels and
    tsdf / color within 1e-5 where they agree (B1's tolerances), except on
    at most ``edge_share`` of those voxels: where the two integrated at
    poses a rounding apart, a voxel centre on a half-pixel edge samples the
    neighbouring pixel."""
    kg, kw = _keyed(got), _keyed(want)
    assert kg.keys() == kw.keys() and len(kg) > 50
    keys = sorted(kg)
    stack = lambda d, f: np.stack([d[k][f] for k in keys])
    agree = stack(kg, "weight") == stack(kw, "weight")
    assert agree.mean() >= B1_WEIGHT_EQUAL_MIN
    off = np.abs(stack(kg, "tsdf") - stack(kw, "tsdf")) > B1_VALUE_TOL
    # color rows hold the 3 channels of the voxels one after the other
    off |= (np.abs(stack(kg, "color") - stack(kw, "color")) > B1_VALUE_TOL).reshape(
        len(keys), 3, -1).any(axis=1)
    assert off[agree].mean() <= edge_share, off[agree].sum()


def _jax_numpy(vol):
    return {k: np.asarray(v) for k, v in vol._asdict().items()}


# -- telemetry -------------------------------------------------------------------


def test_telemetry_matches_jax_under_the_same_calls():
    """The same calls give the same counters, gauges, timer means and frame
    count, and the same report line apart from its measured fps."""
    lines = {"jax": [], "port": []}
    tj = jtelemetry.Telemetry(report_interval=0.0, sink=lines["jax"].append)
    tp = telemetry.Telemetry(report_interval=0.0, sink=lines["port"].append)
    for t in (tj, tp):
        for i in range(5):
            t.count("colored_icp_ok")
            t.count("loop_closures", 2)
            t.record_time("keyframe", 0.001 * (i + 1))
            t.gauge("n_blocks", 100 + i)
            t.tick_frame()
        with t.time_block("fallback"):
            pass
        t.maybe_report(extra="mode REC")
    assert tp._counters == tj._counters and tp._gauges == tj._gauges
    assert tp.frame_count == tj.frame_count == 5
    assert tp.mean_time_ms("keyframe") == tj.mean_time_ms("keyframe") == pytest.approx(3.0)
    assert len(tp._timers["fallback"]) == len(tj._timers["fallback"]) == 1
    assert tp.mean_time_ms("absent") == tj.mean_time_ms("absent") == 0.0
    assert tp.fps > 0 and tj.fps > 0
    strip = lambda line: [p for p in line.split(" | ") if not p.startswith(("[INFO] fps",
                                                                            "fallback"))]
    assert strip(lines["port"][0]) == strip(lines["jax"][0])
    assert lines["port"][0].endswith("mode REC")
    slow = telemetry.Telemetry(report_interval=1e9, sink=lines["port"].append)
    assert slow.maybe_report() is None


def test_log_prefixes_match_jax(capsys):
    for name in ("log_info", "log_warning", "log_error"):
        getattr(jtelemetry, name)("message")
        want = capsys.readouterr().out
        getattr(telemetry, name)("message")
        assert capsys.readouterr().out == want


# -- motion model ----------------------------------------------------------------


def _twist(T):
    return scipy.linalg.logm(T).real


def test_motion_model_predictions():
    """Float64 predictions within 1e-9 of a float64 reference (matrix exp /
    log of the relative motion), and within 1e-5 of JAX's, which rounds its
    log and exp through float32 (measured up to ~2e-6)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(4)
    poses = []
    for _ in range(6):  # rigid to float64 precision
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rng.uniform(-0.3, 0.3, 3)).as_matrix()
        T[:3, 3] = rng.uniform(-0.3, 0.3, 3)
        poses.append(T)
    mj, mp = JMotionModel(damping=0.9, max_history=4), MotionModel(damping=0.9, max_history=4)
    for m in (mj, mp):
        assert np.array_equal(m.predict(), np.eye(4))
        assert np.array_equal(m.predict_relative(), np.eye(4))
    for k, T in enumerate(poses):
        mj.update(T)
        mp.update(T)
        rel = mp.predict_relative()
        if k == 0:
            np.testing.assert_array_equal(mp.predict(), T)
            np.testing.assert_array_equal(rel, np.eye(4))
            continue
        M = np.linalg.inv(poses[k - 1]) @ T
        want = scipy.linalg.expm(0.9 * _twist(M))
        np.testing.assert_allclose(rel, want, rtol=0, atol=1e-9)
        np.testing.assert_allclose(mp.predict(), T @ want, rtol=0, atol=1e-9)
        np.testing.assert_allclose(rel, mj.predict_relative(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(mp.predict(), mj.predict(), rtol=0, atol=1e-5)
    assert len(mp.poses) == len(mj.poses) == 4
    mp.reset()
    assert mp.poses == []


# -- the recorder's steps ------------------------------------------------------


@pytest.fixture(scope="module")
def step_runs(cam):
    """Three frames through JAX's steps and the port's: the seed keyframe
    (zero maps), a keyframe against the seed's maps (JAX's maps fed to
    both), then an interval step at JAX's keyframe pose."""
    poses = orbit_trajectory(4, radius=0.2, angle_span=0.3)
    raw = [cam.capture(T) for T in poses[:3]]
    jkf, jint = jmake_steps(JINTR, JCFG, backend="xla")
    kf, intg = make_raw_recorder_steps(INTR, CFG)
    jrays, rays = jcamera.pixel_rays(JINTR), pixel_rays(INTR, "cpu")
    H, W = JINTR.height, JINTR.width
    zeros = (np.zeros((H, W, 3), np.float32),) * 2 + (np.zeros((H, W), np.float32),) * 3
    eye = np.eye(4, dtype=np.float32)
    # W_prev_kf one small motion back: the seed predicts 0.9 of it again
    W_prev = np.asarray(jse3.se3_exp(np.array([-0.004, 0.002, 0.001, 0.003, -0.002, 0.001])),
                        np.float32)
    t = torch.from_numpy

    def snap(jout, pout):
        """Host copies of both outputs: JAX donates its volume to the next
        step, and the port updates its pools in place."""
        jv, *jrest = jout
        pv, *prest = pout
        return ((_jax_numpy(jv), *[np.array(a) for a in jrest]),
                ({k: np.array(v) for k, v in interop.volume_to_numpy(pv).items()},
                 *[a.numpy().copy() for a in prest]))

    out = {}
    jv, pv = jtsdf.create(JCFG.tsdf), tsdf.create(CFG.tsdf, "cpu")
    jo = jkf(jv, eye, eye, *zeros, jnp.asarray(raw[0][0]), jnp.asarray(raw[0][1]), jrays, *SCAL)
    po = kf(pv, t(eye), t(eye), *map(t, zeros), t(raw[0][0]), t(raw[0][1]), rays, *SCAL)
    out["seed"] = snap(jo, po)
    # the next steps start both packages from JAX's volume (and maps, pose)
    maps = out["seed"][0][3:]
    carried = interop.volume_from_jax_arrays(out["seed"][0][0], "cpu")
    jo2 = jkf(jo[0], eye, W_prev, *maps, jnp.asarray(raw[1][0]), jnp.asarray(raw[1][1]), jrays,
              *SCAL)
    po2 = kf(carried, t(eye), t(W_prev), *map(t, maps), t(raw[1][0]), t(raw[1][1]), rays, *SCAL)
    out["keyframe"] = snap(jo2, po2)
    T_kf = out["keyframe"][0][1]
    carried = interop.volume_from_jax_arrays(out["keyframe"][0][0], "cpu")
    jv3 = jint(jo2[0], T_kf, jnp.asarray(raw[2][0]), jnp.asarray(raw[2][1]), jrays, *SCAL)
    pv3 = intg(carried, t(T_kf), t(raw[2][0]), t(raw[2][1]), rays, *SCAL)
    assert not bool(pv3.overflow)
    out["interval"] = snap([jv3], [pv3])
    return out


def test_seed_keyframe_step_matches_jax(step_runs):
    """Zero maps: the gate rejects (fit -1, pose kept) in both; this frame's
    maps within 1e-6 (normals 1e-5) and the volume by block key."""
    jo, po = step_runs["seed"]
    assert float(jo[2]) == float(po[2]) == -1.0
    np.testing.assert_array_equal(po[1], np.eye(4, dtype=np.float32))
    for name, a, b, tol in zip(("points", "normals", "intensity", "grad_u", "grad_v"), jo[3:],
                               po[3:], (1e-6, 1e-5, 1e-6, 1e-6, 1e-6)):
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=name)
    _assert_close_volumes(po[0], jo[0])


def test_keyframe_step_matches_jax(step_runs):
    """Against the seed's maps from a predicted start: pose <= 1e-4,
    fitness <= 1e-3 and accepted in both; the volume by block key, where
    the poses (~1e-7 apart) may put 0.01 % of the voxels on the other side
    of a half-pixel edge (1 of 220,160 at this input)."""
    jo, po = step_runs["keyframe"]
    assert float(jo[2]) >= JCFG.registration.min_fitness_colored
    assert abs(float(po[2]) - float(jo[2])) <= 1e-3
    np.testing.assert_allclose(po[1], jo[1], rtol=0, atol=1e-4)
    assert not np.allclose(jo[1], np.eye(4), atol=1e-3)  # it moved
    _assert_close_volumes(po[0], jo[0], edge_share=1e-4)


def test_interval_step_matches_jax(step_runs):
    """From the same volume at the same pose: B1's tolerances."""
    jv, pv = step_runs["interval"]
    _assert_close_volumes(pv[0], jv[0])


def test_keyframe_step_rejects_a_non_finite_chain(cam):
    """A NaN in the previous keyframe pose must not poison the seed: the
    prediction falls back to the identity and the step still tracks."""
    kf, _ = make_raw_recorder_steps(INTR, CFG)
    poses = orbit_trajectory(4, radius=0.2, angle_span=0.3)
    (d0, c0), (d1, c1) = cam.capture(poses[0]), cam.capture(poses[1])
    t = torch.from_numpy
    rays = pixel_rays(INTR, "cpu")
    H, W = JINTR.height, JINTR.width
    z3, z1 = torch.zeros((H, W, 3)), torch.zeros((H, W))
    vol, _, _, *maps = kf(tsdf.create(CFG.tsdf, "cpu"), torch.eye(4), torch.eye(4), z3, z3, z1,
                          z1, z1, t(d0), t(c0), rays, *SCAL)
    bad = torch.full((4, 4), float("nan"))
    good = kf(vol, torch.eye(4), torch.eye(4), *maps, t(d1), t(c1), rays, *SCAL)
    nan = kf(tsdf.create(CFG.tsdf, "cpu"), torch.eye(4), bad, *maps, t(d1), t(c1), rays, *SCAL)
    assert torch.isfinite(nan[1]).all() and float(nan[2]) >= CFG.registration.min_fitness_colored
    np.testing.assert_allclose(nan[1].numpy(), good[1].numpy(), atol=1e-4)


# -- the Recorder ------------------------------------------------------------------


def test_recorder_pipeline_matches_jax(cam, tmp_path):
    """tests/test_pipelines.py::test_recorder_pipeline through both packages:
    the final pose within 1e-3 of JAX's, equal ``n_blocks``, the test's own
    bounds, and the saves read back."""
    poses = orbit_trajectory(4, radius=0.2, angle_span=0.3)
    raw = [cam.capture(T) for T in poses]
    jp = JRecorder(JINTR, JCFG, backend="xla", output_dir=str(tmp_path / "jax"))
    pp = Recorder(INTR, CFG, device="cpu", output_dir=str(tmp_path / "port"))
    for p in (jp, pp):
        p.toggle_recording()
        for d, c in raw:
            p.process_frame(d, c)
    assert int(pp.volume.n_blocks) == int(jp.volume.n_blocks) > 50
    np.testing.assert_allclose(pp.T_world_cam, jp.T_world_cam, rtol=0, atol=1e-3)
    T_true_rel = np.linalg.inv(poses[0]) @ poses[-1]
    err = np.asarray(jse3.se3_log(np.linalg.inv(T_true_rel) @ pp.T_world_cam))
    assert np.linalg.norm(err[:3]) < 0.05
    assert pp.telemetry._counters == jp.telemetry._counters == {"colored_icp_ok": 3}
    assert len(pp.trajectory) == len(raw) + 1
    assert pp.telemetry.frame_count == len(raw)
    paths = pp.save_model()
    assert set(paths) == {"mesh", "pointcloud", "trajectory"}
    v, _, f = read_geometry(paths["mesh"])
    assert f is not None and len(f) > 500 and np.isfinite(v).all() and f.max() < len(v)
    pts, cols, _ = read_geometry(paths["pointcloud"])
    assert len(pts) > 1000 and cols is not None and np.isfinite(pts).all()
    traj = ResultSaver.load_trajectory(paths["trajectory"])
    np.testing.assert_allclose(np.stack(traj), np.stack(pp.trajectory), atol=1e-6)
    assert pp.toggle_recording() is False
    n = int(pp.volume.n_blocks)
    pp.process_frame(*raw[0])  # not recording: nothing is fused or recorded
    assert int(pp.volume.n_blocks) == n and len(pp.trajectory) == len(raw) + 1


def test_recorder_deferred_fallback_rebases_pose(cam, tmp_path):
    """tests/test_pipelines.py::test_recorder_deferred_fallback_rebases_pose
    in the port: a keyframe jump beyond colored ICP's basin is caught by the
    deferred check and recovered by the FPFH + RANSAC + ICP ladder, which
    rebases the pose chain. The RANSAC draws differ from JAX's, so the test
    holds to that test's own bounds and counters."""
    pipe = Recorder(INTR, CFG, device="cpu", output_dir=str(tmp_path))
    pipe.toggle_recording()
    orbit = orbit_trajectory(8, radius=0.45, angle_span=1.3, height_wobble=0.0)
    poses = orbit[:3] + [orbit[7]]
    for T in poses:
        pipe.process_frame(*cam.capture(T))
    assert pipe._pending  # the rejection is still pending: the check is deferred
    pipe.save_model()
    snap = dict(pipe.telemetry._counters)
    assert snap.get("colored_icp_reject", 0) >= 1, snap
    assert snap.get("fallback_rebase", 0) >= 1, snap
    T_true_rel = np.linalg.inv(poses[0]) @ poses[-1]
    err = np.asarray(jse3.se3_log(np.linalg.inv(T_true_rel) @ pipe.T_world_cam))
    assert np.linalg.norm(err[:3]) < 0.06, f"terr {err[:3]}"
    assert np.linalg.norm(err[3:]) < 0.08, f"rerr {err[3:]}"
    assert os.path.exists(os.path.join(str(tmp_path), "latest_mesh.ply"))


def test_fallback_recovery_does_not_depend_on_the_draw(cam, tmp_path):
    """The keyframe jump from a generator seed whose first ladder round
    fails (the reference's one-round ladder then keeps the wrong pose): the
    ladder draws fresh seeds while the refinement is rejected, and rebases
    within the JAX test's bounds."""
    pipe = Recorder(INTR, CFG, device="cpu", output_dir=str(tmp_path))
    pipe.generator.manual_seed(3)
    pipe.toggle_recording()
    orbit = orbit_trajectory(8, radius=0.45, angle_span=1.3, height_wobble=0.0)
    poses = orbit[:3] + [orbit[7]]
    for T in poses:
        pipe.process_frame(*cam.capture(T))
    pipe._check_keyframes(force=True)
    snap = dict(pipe.telemetry._counters)
    assert snap.get("fallback_retry", 0) >= 1 and snap.get("fallback_rebase", 0) == 1, snap
    err = np.asarray(jse3.se3_log(np.linalg.inv(np.linalg.inv(poses[0]) @ poses[-1])
                                  @ pipe.T_world_cam))
    assert np.linalg.norm(err[:3]) < 0.06 and np.linalg.norm(err[3:]) < 0.08, err


@pytest.mark.parametrize("rounds, expect_retries", [
    # a plane-slid refinement clears the fitness gate at 0.54 beside the true pose's 0.77
    ((("slid", "true", "true", "garbage"),), 0),
    # alone it would be unconfirmed; it fails the free-space gate anyway: another round
    # draws, and the true pose wins there
    ((("slid", "garbage", "garbage", "garbage"), ("true", "garbage", "true", "slid")), 1),
    # the true pose alone is unconfirmed: the next round's draw of it confirms it
    ((("true", "garbage", "garbage", "garbage"), ("true", "garbage", "garbage", "garbage")), 1),
])
def test_fallback_ladder_takes_the_confirmed_refinement_of_highest_fitness(
        cam, tmp_path, monkeypatch, rounds, expect_retries):
    """The ladder refines every RANSAC restart and returns the refinement of
    highest fitness once a second refinement lands on its pose; a wrong pose
    over the fitness gate is never returned while the true pose is drawn.
    RANSAC and ICP are scripted: each seed refines to itself at its fitness.
    The true pose is the pair's own (the free-space gate reads the frames),
    the slid one 0.46 m along x from it."""
    import types

    from azurekinect3dreconstruction_tpu_torch.core.device import upload
    from azurekinect3dreconstruction_tpu_torch.pipelines import recorder as rec_mod
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import ICPResult

    orbit = orbit_trajectory(2, radius=0.2, angle_span=0.1)
    poses = {"true": np.linalg.inv(orbit[0]) @ orbit[1]}
    poses["slid"] = poses["true"].copy()
    poses["slid"][0, 3] += 0.46  # along the plane
    poses["garbage"] = np.eye(4)
    poses["garbage"][:3, 3] = (2.0, 1.0, 0.0)
    fitness = {"true": 0.77, "slid": 0.54, "garbage": 0.1}
    draws = iter([name for r in rounds for name in r])

    def fake_global(*args, **kwargs):
        return types.SimpleNamespace(T=torch.as_tensor(poses[next(draws)], dtype=torch.float32))

    def fake_icp(src, mask, maps, intr, init, cfg):
        name = min(poses, key=lambda k: np.abs(poses[k] - init.numpy()).max())
        return ICPResult(init, torch.tensor(fitness[name]), torch.tensor(0.0),
                         torch.tensor(1, dtype=torch.int32))

    monkeypatch.setattr(rec_mod, "global_registration", fake_global)
    monkeypatch.setattr(rec_mod, "icp_point_to_plane", fake_icp)
    pipe = Recorder(INTR, CFG, device="cpu", output_dir=str(tmp_path))
    raw = [tuple(upload(a, pipe.device) for a in cam.capture(T)) for T in orbit]
    T = pipe._register_fallback(*raw)
    np.testing.assert_allclose(T, poses["true"], atol=1e-6)
    assert pipe.telemetry.counters.get("fallback_retry", 0) == expect_retries
    assert pipe.telemetry.counters["fallback_icp_ok"] == 1


def test_recorder_interval_frames_take_the_interval_step(cam, tmp_path):
    """keyframe_interval 3: frames 0 and 3 are keyframes, the others take
    the interval step; the trajectory holds the pose each frame used."""
    import dataclasses

    cfg = dataclasses.replace(CFG, keyframe_interval=3)
    pipe = Recorder(INTR, cfg, device="cpu", output_dir=str(tmp_path))
    pipe.toggle_recording()
    for T in orbit_trajectory(5, radius=0.2, angle_span=0.3):
        pipe.process_frame(*cam.capture(T))
    assert len(pipe.telemetry._timers["keyframe"]) == 2
    assert len(pipe.telemetry._timers["integrate"]) == 3
    traj = pipe.trajectory
    np.testing.assert_array_equal(traj[2], traj[1])  # frames 1 and 2 hold frame 0's pose
    np.testing.assert_array_equal(traj[3], traj[1])
    assert not np.allclose(traj[4], traj[3], atol=1e-4)
    assert pipe.telemetry._counters == {"colored_icp_ok": 1}


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Recorder(INTR, CFG, device="cuda")
