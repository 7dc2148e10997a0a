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
model against JAX's, allocation and the frustum cull against JAX's,
``cli.live_mono --source replay:DIR`` on the aligned frames, and the
default worklist (the whole pool) of every step in a pool whose frustum
holds more live blocks than the JAX class's default worklist of 2,048."""

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
from azurekinect3dreconstruction_tpu.ops.pallas.tsdf_kernels import WORKLIST_SIZES
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
from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import build_worklist
from azurekinect3dreconstruction_tpu_torch.parallel import sharded_volume as sv
from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import (
    DualCameraFusion,
    make_raw_dual_step,
)
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
    MonoOdometryTSDF,
    make_device_slam_batch,
    make_device_slam_step,
    make_raw_f2m_step,
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
# 5 mm voxels in 8^3 blocks: from the second aligned frame on, the frustum holds more live
# blocks (2,258 at frame 1) than the JAX class's default worklist of 2,048 (ROADMAP C18)
JCROWD = dataclasses.replace(
    JCFG, tsdf=jcfg.TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=8,
                               block_capacity=4096, hash_capacity=16384),
    odometry=jcfg.OdometryConfig(pyramid_iters=(2, 2, 2)))
CROWD = interop.pipeline_config_from(JCROWD)
JAX_DEFAULT_WORKLIST = 2048


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


@pytest.fixture(scope="module")
def crowded(orbit):
    """JAX's XLA volume of aligned frame 0 in the ``CROWD`` pool (its
    arrays) and JAX's decoded frame 0."""
    _, frames, _, _ = orbit
    f0 = JRGBDFrame.from_raw(*frames[0], CAMC.depth_scale, CAMC.depth_trunc, CAMC.depth_min)
    vj0 = jtsdf.integrate_frame(jtsdf.create(JCROWD.tsdf), f0.depth, f0.color,
                                jcamera.pixel_rays(JINTR), jnp.asarray(np.eye(4, dtype=np.float32)),
                                JINTR, JCROWD.tsdf, backend="xla")
    return {k: np.asarray(v) for k, v in vj0._asdict().items()}, f0


def _crowded_step(name, state, f0, frames, truth, **wl):
    """Aligned frame 1 (and frame 2 as camera 1 of the dual step) through
    the port's step ``name``, from ``state`` in the ``CROWD`` pool, with the
    worklist keyword ``wl`` (none: the default). Returns the volume."""
    vol = interop.volume_from_jax_arrays(state, "cpu")
    t = lambda a: torch.from_numpy(np.array(a))
    eye = interop.pose_to_torch(np.eye(4, dtype=np.float32), "cpu")
    rays = pixel_rays(INTR, "cpu")
    (dr1, cr1), (dr2, cr2) = frames[1], frames[2]
    i0, d0 = t(f0.intensity), t(f0.depth)
    f1 = JRGBDFrame.from_raw(dr1, cr1, CAMC.depth_scale, CAMC.depth_trunc, CAMC.depth_min)
    i1, d1, c1 = t(f1.intensity), t(f1.depth), t(f1.color)
    T1, T2 = (interop.pose_to_torch(np.asarray(truth[k], np.float32), "cpu") for k in (1, 2))
    if name == "MonoOdometryTSDF":
        pipe = MonoOdometryTSDF(INTR, CROWD, device="cpu", **wl)
        pipe.volume = vol
        pipe._prev_int, pipe._prev_depth = i0, d0
        pipe.process_frame(dr1, cr1)
        return pipe.volume
    if name == "make_raw_slam_step":
        return make_raw_slam_step(INTR, CROWD, **wl)(vol, eye, i0, d0, t(dr1), t(cr1), rays,
                                                     *SCAL)[0]
    if name == "make_raw_f2m_step":
        no_model = (torch.zeros((3, 3)), torch.zeros((3,), dtype=torch.bool))
        return make_raw_f2m_step(INTR, CROWD, **wl)(vol, eye, i0, d0, t(dr1), t(cr1), rays,
                                                    *no_model, *SCAL)[0]
    if name == "make_device_slam_step":
        return make_device_slam_step(INTR, CROWD, **wl)(vol, eye, i0, d0, i1, d1, c1, rays)[0]
    if name == "make_device_slam_batch":
        return make_device_slam_batch(INTR, CROWD, **wl)(
            vol, eye, torch.stack([i0, i1]), torch.stack([d0, d1]),
            torch.stack([torch.zeros_like(c1), c1]), rays)[0]
    if name == "make_fused_batch_fn":
        return tk.make_fused_batch_fn(INTR, CROWD.tsdf, **wl)(vol, d1[None], c1[None], T1[None],
                                                              rays)
    if name == "make_raw_dual_step":
        return make_raw_dual_step(INTR, INTR, CROWD.tsdf, **wl)(
            vol, t(dr1), t(cr1), t(dr2), t(cr2), rays, rays, T1, T2, *SCAL, torch.ones(()))
    if name == "make_sharded_step":
        mesh = sv.make_mesh(1, 1, ["cpu"])
        return sv.make_sharded_step(mesh, INTR, CROWD.tsdf, stride=2, **wl)(
            sv.ShardedTSDF((vol,)), d1[None], c1[None], T1[None], rays).shards[0]
    raise ValueError(name)


CROWDED_STEPS = ["MonoOdometryTSDF", "make_raw_slam_step", "make_raw_f2m_step",
                 "make_device_slam_step", "make_device_slam_batch", "make_fused_batch_fn",
                 "make_raw_dual_step", "make_sharded_step"]


@pytest.mark.parametrize("name", CROWDED_STEPS)
def test_default_worklist_is_the_whole_pool(orbit, crowded, name):
    """ROADMAP C18: each step's default worklist is the whole pool. From
    frame 0's volume in the ``CROWD`` pool, aligned frame 1 leaves more
    live blocks in the frustum than 2,048: the default fuses every one of
    them, equal to the bit to an explicit whole-pool worklist, with no
    overflow, where the JAX class's 2,048 sets the sticky flag."""
    _, frames, _, truth = orbit
    state, f0 = crowded
    default = _crowded_step(name, state, f0, frames, truth)
    whole = _crowded_step(name, state, f0, frames, truth,
                          worklist_size=CROWD.tsdf.block_capacity)
    short = _crowded_step(name, state, f0, frames, truth, worklist_size=JAX_DEFAULT_WORKLIST)
    assert not bool(default.overflow) and not bool(whole.overflow)
    assert bool(short.overflow)
    a, b = interop.volume_to_numpy(default), interop.volume_to_numpy(whole)
    for k in ("block_coords", "n_blocks", "tsdf", "weight", "color"):
        np.testing.assert_array_equal(a[k], b[k])


def test_dual_fusion_fuses_the_whole_pool(orbit, crowded):
    """``DualCameraFusion`` builds its step with no size: the pair of
    aligned frames 1 and 2 into the crowded pool leaves no overflow, and its
    volume equals ``make_raw_dual_step`` with an explicit whole-pool
    worklist to the bit."""
    _, frames, _, truth = orbit
    state, f0 = crowded
    pipe = DualCameraFusion((INTR, INTR), CROWD, device="cpu")
    pipe.volume = interop.volume_from_jax_arrays(state, "cpu")
    pipe.calibrated, pipe.extrinsics = True, [truth[1], truth[2]]
    pipe.process_frames((frames[1], frames[2]))
    whole = _crowded_step("make_raw_dual_step", state, f0, frames, truth,
                          worklist_size=CROWD.tsdf.block_capacity)
    assert not bool(pipe.volume.overflow)
    a, b = interop.volume_to_numpy(pipe.volume), interop.volume_to_numpy(whole)
    for k in ("block_coords", "n_blocks", "tsdf", "weight", "color"):
        np.testing.assert_array_equal(a[k], b[k])


def test_default_step_fuses_every_live_block_like_jax(orbit, crowded):
    """The default step's volume against JAX by block key, on every voxel
    (B1's tolerances): JAX's fusion at the port's pose with the worklist a
    caller of the JAX class would pass, the first of ``WORKLIST_SIZES`` that
    holds the live blocks, through its XLA fusion (the Pallas kernel's
    mip-level color differs at this focal length). Both frustums hold the
    same live blocks, more than 2,048, and neither package overflows."""
    _, frames, _, _ = orbit
    state, f0 = crowded
    vol = interop.volume_from_jax_arrays(state, "cpu")
    out = make_raw_slam_step(INTR, CROWD)(
        vol, interop.pose_to_torch(np.eye(4, dtype=np.float32), "cpu"),
        torch.from_numpy(np.array(f0.intensity)), torch.from_numpy(np.array(f0.depth)),
        torch.from_numpy(frames[1][0]), torch.from_numpy(frames[1][1]), pixel_rays(INTR, "cpu"),
        *SCAL)
    vt, Tt = out[0], interop.pose_to_numpy(out[1])
    f1 = JRGBDFrame.from_raw(*frames[1], CAMC.depth_scale, CAMC.depth_trunc, CAMC.depth_min)
    Tj = jnp.asarray(Tt, jnp.float32)
    vj = jtsdf.allocate(_jax_volume(state), f1.depth, jcamera.pixel_rays(JINTR), Tj, JCROWD.tsdf)
    _, na_j = jbuild_worklist(vj.block_coords, vj.n_blocks, Tj, JINTR, JCROWD.tsdf)
    _, na_t = build_worklist(vt.block_coords, vt.n_blocks, out[1], INTR, CROWD.tsdf)
    ladder = next(m for m in WORKLIST_SIZES if m >= int(na_j))
    assert int(na_t) == int(na_j) > JAX_DEFAULT_WORKLIST and ladder == 4096
    vj = jtsdf.integrate(vj, f1.depth, f1.color, Tj, JINTR, JCROWD.tsdf)
    jover = bool(vj.overflow) or int(na_j) > ladder
    a, b = interop.volume_to_numpy(vt), {k: np.asarray(v) for k, v in vj._asdict().items()}
    ka, kb = _by_key(a), _by_key(b)
    assert ka.keys() == kb.keys() and not bool(a["overflow"]) and not jover
    np.testing.assert_array_equal(_rows(a, ka, ka, "weight"), _rows(b, kb, ka, "weight"))
    np.testing.assert_allclose(_rows(a, ka, ka, "tsdf"), _rows(b, kb, ka, "tsdf"), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(_rows(a, ka, ka, "color"), _rows(b, kb, ka, "color"),
                               atol=0.51 / 255, rtol=0)


def test_explicit_worklist_sets_the_sticky_flag_in_both_packages(orbit, crowded):
    """An explicit worklist of 256 keeps the JAX semantics, a static budget:
    the port's step and JAX's Pallas step (interpret mode) from the same
    crowded state both set the sticky overflow flag."""
    _, frames, _, _ = orbit
    state, f0 = crowded
    eye = np.eye(4, dtype=np.float32)
    vt = make_raw_slam_step(INTR, CROWD, worklist_size=256)(
        interop.volume_from_jax_arrays(state, "cpu"), interop.pose_to_torch(eye, "cpu"),
        torch.from_numpy(np.array(f0.intensity)), torch.from_numpy(np.array(f0.depth)),
        torch.from_numpy(frames[1][0]), torch.from_numpy(frames[1][1]), pixel_rays(INTR, "cpu"),
        *SCAL)[0]
    jstep = jmake_raw_slam_step(JINTR, JCROWD, worklist_size=256, backend="pallas",
                                interpret=True)
    vj = jstep(_jax_volume(state), jnp.asarray(eye), f0.intensity, f0.depth, *frames[1],
               jcamera.pixel_rays(JINTR), *SCAL)[0]
    assert bool(vt.overflow) and bool(vj.overflow)
