"""The live camera's frames through the port against the JAX package: the
color-aligned frames that ``--source k4a`` and ``mkv:`` hand the pipeline
(depth re-projected into the color camera, ``transformed_depth``), with the
color camera's intrinsics, at quarter resolution.

The frame maker renders depth in the 160x144 NFOV depth camera (the JAX
renderer), puts it through the port's ``transformed_depth`` with the
nominal calibration (its 32 mm baseline) into the 320x180 color camera,
quantizes it to u16 mm, and renders color at 320x180 from the color
camera's pose; the truth is the color camera's trajectory. Both packages
get the same numpy frames. Cases: ``transformed_depth`` on an orbit frame
to the bit, the maker's holes, one ``make_raw_slam_step`` against JAX's
Pallas step in interpret mode, the class frame to frame and frame to
model against JAX's, allocation and the frustum cull against JAX's, and
``cli.live_mono --source replay:DIR`` on the aligned frames."""

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
from azurekinect3dreconstruction_tpu.ops.depth_to_color import (
    transformed_depth as jtransformed_depth,
)
from azurekinect3dreconstruction_tpu.ops.pallas.tsdf_kernels import (
    build_worklist as jbuild_worklist,
)
from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
    MonoOdometryTSDF as JMono,
)
from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
    make_raw_slam_step as jmake_raw_slam_step,
)
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu_torch.io.replay import FrameRecorder
from azurekinect3dreconstruction_tpu_torch.ops.depth_to_color import transformed_depth
from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import build_worklist
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
    MonoOdometryTSDF,
    make_raw_slam_step,
)
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.25
_NOMINAL = jcamera.CameraCalibration.azure_kinect_nominal()
JCAL = dataclasses.replace(_NOMINAL, depth=_NOMINAL.depth.scaled(SCALE),
                           color=_NOMINAL.color.scaled(SCALE))
CAL = interop.calibration_from(JCAL)
# the pipeline runs in the color camera: its intrinsics are the color camera's
JINTR, INTR = JCAL.color, CAL.color
RAYS_D = pixel_rays(CAL.depth, "cpu")
T_DEPTH_COLOR = np.linalg.inv(JCAL.color_from_depth)
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
N_F2F = 5


def aligned_frame(cam_d, cam_c, T_world_depth):
    """One color-aligned frame as the live sources yield it: (u16 mm depth
    in the color camera, u8 RGB), and the depth camera's own float render."""
    z, _ = cam_d.render(np.asarray(T_world_depth, np.float32))
    z = np.array(z)
    zc = transformed_depth(torch.from_numpy(z), RAYS_D, CAL).numpy()
    _, color = cam_c.render(np.asarray(T_world_depth @ T_DEPTH_COLOR, np.float32))
    return (np.round(zc * 1000.0).astype(np.uint16),
            np.round(np.asarray(color) * 255.0).astype(np.uint8), z)


@pytest.fixture(scope="module")
def orbit():
    """8 depth-camera poses of a short orbit, their aligned frames, the
    depth renders, and the color camera's poses relative to its first."""
    cam_d, cam_c = JCamera(intrinsics=JCAL.depth), JCamera(intrinsics=JCAL.color)
    poses = orbit_trajectory(8, radius=0.2, angle_span=0.5)
    made = [aligned_frame(cam_d, cam_c, T) for T in poses]
    colors = [T @ T_DEPTH_COLOR for T in poses]
    truth = [np.linalg.inv(colors[0]) @ T for T in colors]
    return poses, [(d, c) for d, c, _ in made], [z for _, _, z in made], truth


def _errors(traj, truth):
    """Per-frame (translation, rotation) error norms against the truth."""
    out = []
    for T, G in zip(traj, truth):
        e = np.asarray(jse3.se3_log(np.linalg.inv(G) @ T))
        out.append((np.linalg.norm(e[:3]), np.linalg.norm(e[3:])))
    return np.asarray(out)


def _by_key(v):
    n = int(v["n_blocks"])
    return {tuple(v["block_coords"][s]): s for s in range(n)}


@pytest.mark.parametrize("fill", [0, 1])
@pytest.mark.parametrize("splat", [1, 2])
def test_transformed_depth_orbit_frame_matches_jax(orbit, fill, splat):
    """An orbit frame's depth into the color camera: the port equals JAX
    to the bit (a scatter-min and a 3x3 min do not depend on order)."""
    _, _, renders, _ = orbit
    z = renders[3]
    want = np.asarray(jtransformed_depth(jnp.asarray(z), jcamera.pixel_rays(JCAL.depth), JCAL,
                                         fill_holes=fill, splat=splat))
    got = transformed_depth(torch.from_numpy(z), RAYS_D, CAL, fill_holes=fill,
                            splat=splat).numpy()
    assert got.shape == (JINTR.height, JINTR.width)
    assert (want > 0).mean() > 0.3  # 0.38 with neither splat nor fill
    np.testing.assert_array_equal(got, want)


def test_aligned_frame_has_holes_only_where_the_depth_camera_is_blind(orbit):
    """Every color pixel whose surface point the depth camera sees (inside
    its image, one pixel clear of the border, not occluded there) has
    depth in the maker's frame; the rest of the frame is holes, the bands
    left and right of the depth camera's narrower field of view."""
    poses, frames, renders, _ = orbit
    cam_c = JCamera(intrinsics=JCAL.color)
    di, ci = JCAL.depth, JCAL.color
    for i in (0, 7):
        depth_mm, z_d = frames[i][0], renders[i]
        direct, _ = cam_c.render(np.asarray(poses[i] @ T_DEPTH_COLOR, np.float32))
        direct = np.asarray(direct, np.float64)
        v, u = np.mgrid[0:ci.height, 0:ci.width]
        pc = np.stack([(u - ci.cx) / ci.fx * direct, (v - ci.cy) / ci.fy * direct, direct], -1)
        pd = pc @ T_DEPTH_COLOR[:3, :3].T + T_DEPTH_COLOR[:3, 3]
        zz = np.maximum(pd[..., 2], 1e-6)
        ud = np.round(pd[..., 0] / zz * di.fx + di.cx).astype(int)
        vd = np.round(pd[..., 1] / zz * di.fy + di.cy).astype(int)
        inside = ((direct > 0) & (ud >= 1) & (vd >= 1) & (ud < di.width - 1)
                  & (vd < di.height - 1))
        z_at = z_d[np.clip(vd, 0, di.height - 1), np.clip(ud, 0, di.width - 1)]
        seen = inside & (np.abs(z_at - pd[..., 2]) < 0.01)
        hole = depth_mm == 0
        assert seen.mean() > 0.4, seen.mean()
        assert not (hole & seen).any(), int((hole & seen).sum())
        # the color camera sees past both sides of the depth camera's field
        assert hole[:, :ci.width // 10].all() and hole[:, -(ci.width // 10):].all()
        valid = ~hole
        err = np.abs(depth_mm[valid & seen] / 1000.0 - direct[valid & seen])
        assert np.median(err) < 0.005, np.median(err)


@pytest.fixture(scope="module")
def port_step(orbit):
    """One port ``make_raw_slam_step`` on aligned frames 0 -> 1 from a JAX
    XLA volume of frame 0: (JAX's config, that volume's arrays, JAX's frame
    0, the port's volume, pose, fitness, intensity and depth after the
    step). JAX's step donates its volume: each test builds its own from
    the arrays (``_jax_volume``)."""
    _, frames, _, _ = orbit
    jc = dataclasses.replace(JCFG, odometry=jcfg.OdometryConfig(pyramid_iters=(2, 2, 2)))
    pc = interop.pipeline_config_from(jc)
    (d0, c0), (d1, c1) = frames[0], frames[1]
    f0 = JRGBDFrame.from_raw(d0, c0, CAMC.depth_scale, CAMC.depth_trunc, CAMC.depth_min)
    eye = np.eye(4, dtype=np.float32)
    vj0 = jtsdf.integrate_frame(jtsdf.create(jc.tsdf), f0.depth, f0.color,
                                jcamera.pixel_rays(JINTR), jnp.asarray(eye), JINTR, jc.tsdf,
                                backend="xla")
    state = {k: np.asarray(v) for k, v in vj0._asdict().items()}
    vt = interop.volume_from_jax_arrays(state, "cpu")
    tstep = make_raw_slam_step(INTR, pc, worklist_size=2048)
    out = tstep(vt, interop.pose_to_torch(eye, "cpu"), torch.from_numpy(np.array(f0.intensity)),
                torch.from_numpy(np.array(f0.depth)), torch.from_numpy(d1),
                torch.from_numpy(c1), pixel_rays(INTR, "cpu"), *SCAL)
    return (jc, state, f0) + tuple(out)


def _jax_volume(state):
    return jtsdf.TSDFVolume(**{k: jnp.asarray(v) for k, v in state.items()})


def _rows(v, by_key, keys, field):
    return np.stack([v[field][by_key[k]].reshape(-1) for k in keys])


def test_raw_slam_step_matches_jax_pallas_step(orbit, port_step):
    """One step on aligned frames from the same state (tests/test_torch_
    slam.py's bounds): pose <= 1e-4, fitness <= 1e-3, the decoded frame
    equal, the same block keys, weights equal on >= 99 % of the blocks,
    tsdf within 1e-5 on >= 99 % of the voxels, and color within 0.51/255
    (JAX's kernel keeps u8 color) on every voxel of the blocks JAX's kernel
    samples at full resolution. The blocks it samples from its half-
    resolution mip level (a TPU approximation the port does not copy) are
    held on weight and tsdf here and on color by the next test: the color
    camera's longer focal length projects more blocks large enough for it,
    and their voxels read a neighbouring pixel's color where the depth is
    the same."""
    _, frames, _, _ = orbit
    jc, state, f0, vt, Tt, fitt, it, dt = port_step
    d1, c1 = frames[1]
    jstep = jmake_raw_slam_step(JINTR, jc, worklist_size=2048, backend="pallas",
                                interpret=True)
    vj, Tj, fitj, ij, dj = jstep(_jax_volume(state), jnp.asarray(np.eye(4, dtype=np.float32)), f0.intensity,
                                 f0.depth, d1, c1, jcamera.pixel_rays(JINTR), *SCAL)

    np.testing.assert_allclose(interop.pose_to_numpy(Tt), np.asarray(Tj), atol=1e-4)
    assert abs(float(fitt) - float(fitj)) <= 1e-3 and float(fitt) > 0.3
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))

    a, b = interop.volume_to_numpy(vt), {k: np.asarray(v) for k, v in vj._asdict().items()}
    ka, kb = _by_key(a), _by_key(b)
    assert ka.keys() == kb.keys() and bool(a["overflow"]) == bool(b["overflow"])
    same_w = _rows(a, ka, ka, "weight") == _rows(b, kb, ka, "weight")
    assert same_w.all(axis=1).mean() >= 0.99, same_w.all(axis=1).mean()
    d_tsdf = np.abs(_rows(a, ka, ka, "tsdf") - _rows(b, kb, ka, "tsdf"))
    assert (same_w & (d_tsdf <= 1e-5)).mean() >= 0.99
    meta, na = jbuild_worklist(vj.block_coords, vj.n_blocks, Tj, JINTR, jc.tsdf)
    meta = np.asarray(meta)[:, : int(na)]
    full_res = {int(s) for s, lvl in zip(meta[0], meta[6]) if lvl == 0}
    keys = [k for k in ka if kb[k] in full_res]
    assert len(keys) >= 0.9 * len(ka), (len(keys), len(ka))
    c_a = np.stack([a["color"][ka[k]].reshape(3, -1) for k in keys])
    c_b = np.stack([b["color"][kb[k]].reshape(3, -1) for k in keys])
    assert (np.abs(c_a - c_b) <= 0.51 / 255).all()


def test_raw_slam_step_fusion_matches_jax_xla_on_every_voxel(orbit, port_step):
    """The step's fusion on every block, color included: JAX's XLA fusion
    (``integrate_frame(backend="xla")``: allocation and the jnp update,
    no mip level) from the same state, with frame 1 decoded by JAX, at
    the port's own pose. JAX's XLA step is no reference for this: its
    odometry is another solver, 1.2e-3 from the Pallas path on this pair,
    and a pose that far apart moves voxels across pixel edges. The same
    block keys, weights equal on every voxel, tsdf within 1e-5 and color
    within 0.51/255 on every voxel."""
    _, frames, _, _ = orbit
    jc, state, _, vt, Tt, _, _, dt = port_step
    f1 = JRGBDFrame.from_raw(*frames[1], CAMC.depth_scale, CAMC.depth_trunc, CAMC.depth_min)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(f1.depth))
    vj = jtsdf.integrate_frame(_jax_volume(state), f1.depth, f1.color, jcamera.pixel_rays(JINTR),
                               jnp.asarray(interop.pose_to_numpy(Tt), jnp.float32), JINTR,
                               jc.tsdf, backend="xla")
    a, b = interop.volume_to_numpy(vt), {k: np.asarray(v) for k, v in vj._asdict().items()}
    ka, kb = _by_key(a), _by_key(b)
    assert ka.keys() == kb.keys() and bool(a["overflow"]) == bool(b["overflow"])
    np.testing.assert_array_equal(_rows(a, ka, ka, "weight"), _rows(b, kb, ka, "weight"))
    np.testing.assert_allclose(_rows(a, ka, ka, "tsdf"), _rows(b, kb, ka, "tsdf"), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(_rows(a, ka, ka, "color"), _rows(b, kb, ka, "color"),
                               atol=0.51 / 255, rtol=0)


def test_mono_class_tracks_aligned_frames_like_jax(orbit):
    """Frame to frame over 5 aligned frames against the JAX class on the
    XLA path (tests/test_torch_slam.py's bounds): per frame within twice
    JAX's error (or 5 mm / 3 mrad), the same gate decisions, ATE < 5 mm
    against the color camera's truth, block-key Jaccard >= 0.98."""
    _, frames, _, truth = orbit
    pj = JMono(JINTR, JCFG, backend="xla")
    pt = MonoOdometryTSDF(INTR, CFG, device="cpu")
    for d, c in frames[:N_F2F]:
        pj.process_frame(d, c)
        pt.process_frame(d, c)
    ej = _errors(pj.trajectory[1:], truth[:N_F2F])
    et = _errors(pt.trajectory[1:], truth[:N_F2F])
    assert (et[:, 0] < np.maximum(2 * ej[:, 0], 5e-3)).all(), (et, ej)
    assert (et[:, 1] < np.maximum(2 * ej[:, 1], 3e-3)).all(), (et, ej)
    assert pt.odometry_failures == pj.odometry_failures == 0
    fj = np.asarray(jnp.stack(pj._fits_dev))
    assert ((pt.fitness > pt.MIN_FITNESS) == (fj > pj.MIN_FITNESS)).all()
    assert ate(pt.trajectory[1:], truth[:N_F2F])["rmse"] < 5e-3
    ka = set(_by_key(interop.volume_to_numpy(pt.volume)))
    kb = set(_by_key({k: np.asarray(v) for k, v in pj.volume._asdict().items()}))
    assert len(ka & kb) >= 0.98 * len(ka | kb)


def test_frame_to_model_on_aligned_frames_like_jax(orbit):
    """Frame to model over the 8 aligned frames, the port's class beside
    JAX's (tests/test_torch_f2m.py's bounds): refinement engages in both,
    the port's worst pose error <= its own frame-to-frame's + 5e-4 and
    <= JAX's frame-to-model's + 5e-4, and under 2 cm / rad."""
    _, frames, _, truth = orbit
    kw = dict(model_refine_interval=2, model_min_inliers=500)
    pm = MonoOdometryTSDF(INTR, CFG, device="cpu", tracking="frame_to_model", **kw)
    pf = MonoOdometryTSDF(INTR, CFG, device="cpu")
    pj = JMono(JINTR, JCFG, backend="xla", tracking="frame_to_model", **kw)
    for d, c in frames:
        for p in (pm, pf, pj):
            p.process_frame(d, c)
    worst = lambda p: float(np.linalg.norm(_errors(p.trajectory[1:], truth), axis=1).max())
    err_m, err_f, err_j = worst(pm), worst(pf), worst(pj)
    assert pm.counts.get("model_icp_ok", 0) > 0, pm.counts
    assert pj.telemetry._counters.get("model_icp_ok", 0) > 0
    assert err_m <= err_f + 5e-4, (err_m, err_f)
    assert err_m <= err_j + 5e-4, (err_m, err_j)
    assert err_m < 0.02
    assert pm.odometry_failures == 0 and not bool(pm.volume.overflow)


def test_allocate_and_cull_match_jax_on_aligned_frames(orbit):
    """At the color camera's true poses: after each frame the allocated
    key set equals JAX's, and the frustum cull counts the same live
    blocks (``n_active``) in the color camera's wider frustum."""
    _, frames, _, truth = orbit
    vj, vt = jtsdf.create(JCFG.tsdf), tsdf.create(CFG.tsdf, "cpu")
    jrays, rays = jcamera.pixel_rays(JINTR), pixel_rays(INTR, "cpu")
    for (d, _), T in zip(frames, truth):
        z = (d.astype(np.float32) * np.float32(1.0 / CAMC.depth_scale))
        T32 = np.asarray(T, np.float32)
        vj = jtsdf.allocate(vj, z, jrays, jnp.asarray(T32), JCFG.tsdf)
        vt = tsdf.allocate(vt, torch.from_numpy(z), rays, torch.from_numpy(T32), CFG.tsdf)
        a = interop.volume_to_numpy(vt)
        b = {k: np.asarray(v) for k, v in vj._asdict().items()}
        assert _by_key(a).keys() == _by_key(b).keys()
        _, na_j = jbuild_worklist(vj.block_coords, vj.n_blocks, jnp.asarray(T32), JINTR,
                                  JCFG.tsdf)
        _, na_t = build_worklist(vt.block_coords, vt.n_blocks, torch.from_numpy(T32), INTR,
                                 CFG.tsdf)
        assert 0 < int(na_t) == int(na_j) <= int(vt.n_blocks)
    assert not bool(vt.overflow)


def test_live_mono_replays_aligned_frames(orbit, tmp_path):
    """``cli.live_mono --source replay:DIR`` on 4 aligned frames whose
    calibration gives the color camera's intrinsics to depth and color, as
    ``io.replay`` describes already-aligned frames: exit 0, every frame
    tracked, the mesh written, the trajectory within 2 cm of the truth."""
    _, frames, _, truth = orbit
    log = tmp_path / "frames"
    rec = FrameRecorder(str(log), dataclasses.replace(CAL, depth=INTR))
    for d, c in frames[:4]:
        rec.write(d, c)
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "azurekinect3dreconstruction_tpu_torch.cli.live_mono",
                        "--source", f"replay:{log}", "--device", "cpu", "--frames", "4",
                        "--voxel", "0.02", "--output", str(out)],
                       capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    said = r.stdout + r.stderr
    assert r.returncode == 0, said[-4000:]
    assert "0 gate rejections" in said and "overflow False" in said, said[-2000:]
    assert os.path.getsize(out / "latest_mesh.ply") > 10000
    traj = np.loadtxt(out / "latest_trajectory.txt").reshape(-1, 4, 4)
    assert traj.shape == (5, 4, 4)  # the identity, then 4 frames
    assert np.abs(traj[1:] - np.stack(truth[:4])).max() < 0.02
