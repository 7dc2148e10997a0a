"""The port's frame-to-model tracking against the JAX package: one
``make_raw_f2m_step`` from a shared state (volume and model carried across
through ``interop``), the step's ordering contract (the frame is fused at
the pose its refinement gate chose), the class in ``frame_to_model`` mode,
the view-local model refresh, the save path, and a jax-free import of the
modules this slice adds."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu import config as jcfg
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
from azurekinect3dreconstruction_tpu.core.types import RGBDFrame as JRGBDFrame
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
    make_raw_f2m_step as jmake_raw_f2m_step,
)
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as jmc
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu.tsdf.streaming import StreamingTSDF
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
    MonoOdometryTSDF,
    integration_reach,
    make_raw_f2m_step,
)
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver, read_ply

torch.set_num_threads(1)

JINTR = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)
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


def _by_key(v):
    n = int(v["n_blocks"])
    return {tuple(v["block_coords"][s]): s for s in range(n)}


@pytest.fixture(scope="module")
def shared_state():
    """Frame 0 fused at the origin by JAX, and a model sampled from it and
    shifted +5 mm in x, so that the refinement has to move the pose."""
    cam = JCamera(intrinsics=JINTR)
    poses = orbit_trajectory(2, radius=0.2, angle_span=0.3)
    (d0, c0), (d1, c1) = (cam.capture(T) for T in poses)
    f0 = JRGBDFrame.from_raw(d0, c0, CAMC.depth_scale, CAMC.depth_trunc, CAMC.depth_min)
    rays = jpixel_rays(JINTR)
    vol = jtsdf.integrate_frame(jtsdf.create(JCFG.tsdf), f0.depth, f0.color, rays,
                                jnp.eye(4, dtype=jnp.float32), JINTR, JCFG.tsdf, backend="xla")
    mp, mm, _ = jmc.extract_surface_samples(vol, JCFG.tsdf, 32768)
    mp = mp + jnp.asarray([0.005, 0.0, 0.0], jnp.float32)
    state = {k: np.asarray(v) for k, v in vol._asdict().items()}
    return dict(vol=vol, state=state, mp=np.asarray(mp), mm=np.asarray(mm), f0=f0, rays=rays,
                d1=d1, c1=c1)


def _port_step_inputs(st):
    return (interop.volume_from_jax_arrays(st["state"], "cpu"), torch.eye(4),
            torch.from_numpy(np.array(st["f0"].intensity)),
            torch.from_numpy(np.array(st["f0"].depth)), torch.from_numpy(st["d1"]),
            torch.from_numpy(st["c1"]), pixel_rays(INTR, "cpu"),
            *interop.model_to_torch(st["mp"], st["mm"], "cpu"))


def test_f2m_step_matches_jax(shared_state):
    """From one state: pose <= 1e-4, the gate's decision equal (accepted),
    fitness <= 1e-3, ICP inliers within 1 %. The fused volumes hold the same
    block keys and equal weights on >= 99.9 % of the voxels (the poses
    differ by ~1e-5, which moves a few voxels across a half-pixel edge);
    fused at JAX's pose, the port's volume equals JAX's to the bit."""
    st = shared_state
    jstep = jmake_raw_f2m_step(JINTR, JCFG, backend="xla", min_inliers=500)
    vj, Tj, fj, _, _, nj, okj = jstep(jax.tree_util.tree_map(jnp.array, st["vol"]),
                                      jnp.eye(4, dtype=jnp.float32), st["f0"].intensity,
                                      st["f0"].depth, st["d1"], st["c1"], st["rays"],
                                      jnp.asarray(st["mp"]), jnp.asarray(st["mm"]), *SCAL)
    step = make_raw_f2m_step(INTR, CFG, min_inliers=500)
    vt, Tt, ft, _, _, nt, okt = step(*_port_step_inputs(st), *SCAL)
    assert bool(okt) == bool(okj) is True
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4, rtol=0)
    assert abs(float(ft) - float(fj)) <= 1e-3
    assert abs(int(nt) - int(nj)) <= 0.01 * int(nj)
    a, b = interop.volume_to_numpy(vt), {k: np.asarray(v) for k, v in vj._asdict().items()}
    ka, kb = _by_key(a), _by_key(b)
    assert ka.keys() == kb.keys()
    rows = lambda v, keys, f: np.stack([v[f][keys[k]].reshape(-1) for k in ka])
    assert (rows(a, ka, "weight") == rows(b, kb, "weight")).mean() >= 0.999
    inputs = _port_step_inputs(st)
    f1 = RGBDFrame.from_raw(inputs[4], inputs[5], CAMC.depth_scale, CAMC.depth_trunc,
                            CAMC.depth_min)
    at_j = interop.volume_to_numpy(tsdf.integrate_frame(
        inputs[0], f1.depth, f1.color, inputs[6], interop.pose_to_torch(Tj, "cpu"), INTR,
        CFG.tsdf))
    kj = _by_key(at_j)
    for f in ("weight", "tsdf", "color"):
        np.testing.assert_array_equal(rows(at_j, kj, f), rows(b, kb, f))


def test_f2m_step_fuses_at_refined_pose(shared_state):
    """The ordering contract: the refinement moved the pose by about the
    5 mm model shift, away from pure odometry, and the step's volume equals
    integrating the frame at the returned pose (to the bit)."""
    st = shared_state
    inputs = _port_step_inputs(st)
    vol_in = inputs[0]
    before = vol_in._replace(**{k: v.clone() for k, v in vol_in._asdict().items()})
    step = make_raw_f2m_step(INTR, CFG, min_inliers=500)
    vol, T, fit, inten, d, n_in, ok = step(*inputs, *SCAL)
    assert bool(ok) and int(n_in) >= 500
    # with no model the gate rejects and the odometry pose stands
    no_model = (torch.zeros((4, 3)), torch.zeros((4,), dtype=torch.bool))
    fresh = before._replace(**{k: v.clone() for k, v in before._asdict().items()})
    _, T_odo, _, _, _, n0, ok0 = step(fresh, *inputs[1:7], *no_model, *SCAL)
    assert not bool(ok0) and int(n0) == 0
    dx = float((T - T_odo).abs().max())
    assert 2e-3 < dx < 0.02, dx
    c = RGBDFrame.from_raw(inputs[4], inputs[5], CAMC.depth_scale, CAMC.depth_trunc,
                           CAMC.depth_min).color
    want = tsdf.integrate_frame(before, d, c, inputs[6], T, INTR, CFG.tsdf)
    for k in ("n_blocks", "block_coords", "tsdf", "weight", "color", "table_keys"):
        assert torch.equal(getattr(vol, k), getattr(want, k)), k


@pytest.fixture(scope="module")
def orbit_frames():
    cam = JCamera(intrinsics=JINTR)
    poses = orbit_trajectory(8, radius=0.2, angle_span=0.5)
    return poses, [cam.capture(T) for T in poses]


def _max_err(pipe, poses):
    errs = []
    for i, T in enumerate(poses):
        T_true = np.linalg.inv(poses[0]) @ T
        d6 = se3.se3_log(torch.as_tensor(np.linalg.inv(T_true) @ pipe.trajectory[i + 1],
                                          dtype=torch.float32))
        errs.append(float(torch.linalg.vector_norm(d6)))
    return max(errs)


def test_frame_to_model_class_at_least_as_accurate(orbit_frames):
    """The mode's contract (tests/test_pipelines.py): refinement engages,
    and the trajectory is at least as accurate as frame-to-frame (5e-4 of
    float slack), and under 2 cm / rad."""
    poses, frames = orbit_frames
    pipes = {m: MonoOdometryTSDF(INTR, CFG, device="cpu", tracking=m, model_refine_interval=2,
                                 model_min_inliers=500)
             for m in ("frame_to_model", "frame_to_frame")}
    for d, c in frames:
        for p in pipes.values():
            p.process_frame(d, c)
    pm, pf = pipes["frame_to_model"], pipes["frame_to_frame"]
    counts = pm.counts
    assert counts.get("model_icp_ok", 0) > 0, counts
    assert counts.get("model_icp_ok", 0) + counts.get("model_icp_skip", 0) == len(frames) - 2
    assert pf.counts == {}
    err_m, err_f = _max_err(pm, poses), _max_err(pf, poses)
    assert err_m <= err_f + 5e-4, (err_m, err_f)
    assert err_m < 0.02
    assert pm.odometry_failures == 0 and not bool(pm.volume.overflow)
    # the save path of the live entry point: weld -> PLY -> read back
    mesh = pm.extract_mesh()
    assert int(mesh.num_triangles) > 500 and not mesh.overflow
    welded = mc.weld_vertices(mesh.compact())
    pm.reset()
    assert int(pm.volume.n_blocks) == 0 and pm._model is None and len(pm.trajectory) == 1
    assert welded.vertices.shape[0] < 3 * int(mesh.num_triangles)


def test_refresh_cadence_stretches_on_accepts():
    """The adaptive cadence: model_refine_interval accepted refinements in a
    row stretch the next refresh by one frame, up to twice the base; a
    rejection snaps back. Flags are read only once 2 frames old."""
    p = MonoOdometryTSDF(INTR, CFG, device="cpu", tracking="frame_to_model",
                         model_refine_interval=2)
    p.volume = tsdf.create(CFG.tsdf, "cpu")  # an empty model is fine here
    due = []
    for i, flag in enumerate([True] * 8 + [False] + [True] * 3):
        p.frame_index = i
        p._ok_pending.append((i, torch.tensor(flag), None))
        p.frame_index = i + 1
        before = p._next_refresh
        p._maybe_refresh_model()
        if p._next_refresh != before:
            due.append((i + 1, p._ok_streak, p._next_refresh - (i + 1)))
    assert due[0] == (2, 1, 2)
    assert any(interval == 3 for _, _, interval in due)  # stretched
    assert all(interval <= 4 for _, _, interval in due)
    i_reset = next(k for k, (f, streak, _) in enumerate(due) if f > 9 and streak < 2)
    assert due[i_reset][2] == 2  # snapped back after the rejection


def test_refresh_is_view_local():
    """Two frames fused 8 m apart: the class's refresh radius keeps the
    model within reach of the pose, and the reach equals the JAX one."""
    assert integration_reach(CFG) == StreamingTSDF.integration_reach(JCFG)
    cam = JCamera(intrinsics=JINTR)
    rays = pixel_rays(INTR, "cpu")
    vol = tsdf.create(CFG.tsdf, "cpu")
    T_far = np.eye(4)
    T_far[0, 3] = 8.0
    for T in (np.eye(4), T_far):
        d, c = cam.capture(T)
        f = RGBDFrame.from_raw(torch.from_numpy(d), torch.from_numpy(c), CAMC.depth_scale,
                               CAMC.depth_trunc, CAMC.depth_min)
        vol = tsdf.integrate_frame(vol, f.depth, f.color, rays,
                                   torch.as_tensor(T, dtype=torch.float32), INTR, CFG.tsdf)
    nb = int(vol.n_blocks)
    pipe = MonoOdometryTSDF(INTR, CFG, device="cpu", tracking="frame_to_model",
                            model_points=4096)
    reach = pipe._model_reach()
    pts, mask, _ = mc.extract_sampled_surface_model(vol, CFG.tsdf, 4096, torch.eye(4), reach,
                                                    sample_blocks=pipe.model_sample_blocks)
    p = pts[mask].numpy()
    assert len(p) > 100
    assert (np.linalg.norm(p, axis=1) <= reach + CFG.tsdf.block_size).all()
    assert int(vol.n_blocks) == nb


def test_save_path_round_trips(orbit_frames, tmp_path):
    """``weld_vertices(extract_mesh().compact())`` -> ``ResultSaver`` ->
    read back: the same vertices, colors to 1/255 quantization, faces."""
    _, frames = orbit_frames
    pipe = MonoOdometryTSDF(INTR, CFG, device="cpu")
    for d, c in frames[:3]:
        pipe.process_frame(d, c)
    welded = mc.weld_vertices(pipe.extract_mesh().compact())
    saver = ResultSaver(str(tmp_path))
    path = saver.save_mesh(welded)
    v, col, f = read_ply(path)
    np.testing.assert_array_equal(v, welded.vertices)
    np.testing.assert_array_equal(f, welded.triangles)
    np.testing.assert_allclose(col, welded.vertex_colors, atol=1.0 / 255 + 1e-6)
    assert os.path.exists(tmp_path / "latest_mesh.ply")


def test_bad_tracking_mode_raises():
    with pytest.raises(ValueError):
        MonoOdometryTSDF(INTR, CFG, device="cpu", tracking="frame_to_world")


def test_slice_modules_import_without_jax():
    """With jax made unimportable, every module this slice adds imports and
    pulls in no jax."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["core.linalg", "core.types", "ops.backproject", "ops.normals", "tracking.icp",
            "tsdf.mc_tables", "tsdf.marching_cubes", "tsdf.volume", "viz.savers", "interop",
            "pipelines.mono_odometry_tsdf"]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            + "".join(f"importlib.import_module('azurekinect3dreconstruction_tpu_torch.{m}')\n"
                      for m in mods)
            + "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]\n"
            + "assert 'azurekinect3dreconstruction_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr

