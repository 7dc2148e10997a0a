"""The port's SLAM slice against the JAX package: one raw-frame step of
``make_raw_slam_step`` from a shared state (loaded through ``interop``), and
the ``MonoOdometryTSDF`` class over a short orbit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu import config as jcfg
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
from azurekinect3dreconstruction_tpu.core.types import RGBDFrame as JRGBDFrame
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
    MonoOdometryTSDF as JMono,
)
from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
    make_raw_slam_step as jmake_raw_slam_step,
)
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
    MonoOdometryTSDF,
    make_raw_slam_step,
)
from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate

torch.set_num_threads(1)

JINTR = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)
INTR = interop.intrinsics_from(JINTR)
# the SMALL_CFG of tests/test_pipelines.py
JCFG = jcfg.PipelineConfig(
    tsdf=jcfg.TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                         block_capacity=2048, hash_capacity=8192),
    odometry=jcfg.OdometryConfig(pyramid_iters=(8, 8, 8)),
)
CFG = interop.pipeline_config_from(JCFG)


@pytest.fixture(scope="module")
def raw_frames():
    cam = JCamera(intrinsics=JINTR)
    poses = orbit_trajectory(5, radius=0.25, angle_span=0.5)
    return poses, [cam.capture(T) for T in poses]


def _by_key(v):
    n = int(v["n_blocks"])
    return {tuple(v["block_coords"][s]): s for s in range(n)}


def test_raw_slam_step_matches_jax_pallas_step(raw_frames):
    """One step from the same state: pose <= 1e-4; weights equal on >= 99%
    of the blocks, compared by key; the JAX kernel keeps its u8 color, so
    color agrees to 0.51/255."""
    _, frames = raw_frames
    jc = dataclasses.replace(JCFG, odometry=jcfg.OdometryConfig(pyramid_iters=(2, 2, 2)))
    pc = interop.pipeline_config_from(jc)
    camc = jc.camera
    (d0, c0), (d1, c1) = frames[0], frames[1]
    f0 = JRGBDFrame.from_raw(d0, c0, camc.depth_scale, camc.depth_trunc, camc.depth_min)
    jrays = jpixel_rays(JINTR)
    eye = np.eye(4, dtype=np.float32)
    vj = jtsdf.integrate_frame(jtsdf.create(jc.tsdf), f0.depth, f0.color, jrays,
                               jnp.asarray(eye), JINTR, jc.tsdf, backend="xla")
    state = {k: np.asarray(v) for k, v in vj._asdict().items()}
    vt = interop.volume_from_jax_arrays(state, "cpu")

    scal = (1.0 / camc.depth_scale, camc.depth_min, camc.depth_trunc)
    jstep = jmake_raw_slam_step(JINTR, jc, worklist_size=2048, backend="pallas",
                                interpret=True)
    vj, Tj, fitj, ij, dj = jstep(vj, jnp.asarray(eye), f0.intensity, f0.depth, d1, c1, jrays,
                                 *scal)
    tstep = make_raw_slam_step(INTR, pc, worklist_size=2048)
    vt, Tt, fitt, it, dt = tstep(vt, interop.pose_to_torch(eye, "cpu"),
                                 torch.from_numpy(np.array(f0.intensity)),
                                 torch.from_numpy(np.array(f0.depth)),
                                 torch.from_numpy(d1), torch.from_numpy(c1),
                                 pixel_rays(INTR, "cpu"), *scal)

    np.testing.assert_allclose(interop.pose_to_numpy(Tt), np.asarray(Tj), atol=1e-4)
    assert abs(float(fitt) - float(fitj)) <= 1e-3 and float(fitt) > 0.3
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))

    a, b = interop.volume_to_numpy(vt), {k: np.asarray(v) for k, v in vj._asdict().items()}
    ka, kb = _by_key(a), _by_key(b)
    assert ka.keys() == kb.keys() and bool(a["overflow"]) == bool(b["overflow"])
    # blocks present before the step keep their slots
    np.testing.assert_array_equal(a["block_coords"][: int(state["n_blocks"])],
                                  state["block_coords"][: int(state["n_blocks"])])
    rows_a = np.stack([a["weight"][ka[k]].reshape(-1) for k in ka])
    rows_b = np.stack([b["weight"][kb[k]].reshape(-1) for k in ka])
    t_a = np.stack([a["tsdf"][ka[k]].reshape(-1) for k in ka])
    t_b = np.stack([b["tsdf"][kb[k]].reshape(-1) for k in ka])
    c_a = np.stack([a["color"][ka[k]].reshape(3, -1) for k in ka])
    c_b = np.stack([b["color"][kb[k]].reshape(3, -1) for k in ka])
    same_w = rows_a == rows_b
    assert same_w.all(axis=1).mean() >= 0.99, same_w.all(axis=1).mean()
    # the JAX kernel samples a half-res mip level for large blocks and
    # multiplies its projection out in another order, so a few voxels read
    # a neighbouring pixel: same weight, other depth or color
    assert (same_w & (np.abs(t_a - t_b) <= 1e-5)).mean() >= 0.99
    assert (np.abs(c_a - c_b).max(axis=1) <= 0.51 / 255).mean() >= 0.999


def test_mono_class_tracks_like_jax(raw_frames):
    """The class over 5 frames against the JAX class on the XLA path:
    converged-pose bounds per frame, same gate decisions, block-key
    Jaccard >= 0.98."""
    poses, frames = raw_frames
    pj = JMono(JINTR, JCFG, backend="xla")
    pt = MonoOdometryTSDF(INTR, CFG, device="cpu")
    for d, c in frames:
        pj.process_frame(d, c)
        pt.process_frame(d, c)
    gt = [np.linalg.inv(poses[0]) @ T for T in poses]
    tj, tt = pj.trajectory[1:], pt.trajectory[1:]
    for i in range(1, len(gt)):
        ej = np.asarray(jse3.se3_log(np.linalg.inv(gt[i]) @ tj[i]))
        et = np.asarray(jse3.se3_log(np.linalg.inv(gt[i]) @ tt[i]))
        assert np.linalg.norm(et[:3]) < max(2 * np.linalg.norm(ej[:3]), 5e-3)
        assert np.linalg.norm(et[3:]) < max(2 * np.linalg.norm(ej[3:]), 3e-3)
    assert pt.odometry_failures == pj.odometry_failures == 0
    fj = np.asarray(jnp.stack(pj._fits_dev))
    assert ((pt.fitness > pt.MIN_FITNESS) == (fj > pj.MIN_FITNESS)).all()
    assert ate(tt, gt)["rmse"] < 5e-3
    ka = set(_by_key(interop.volume_to_numpy(pt.volume)))
    kb = set(_by_key({k: np.asarray(v) for k, v in pj.volume._asdict().items()}))
    assert len(ka & kb) >= 0.98 * len(ka | kb)
    pts, cols = pt.extract_point_cloud()
    assert pts.shape[0] > 1000 and np.isfinite(pts).all()
    # reset clears everything
    pt.reset()
    assert int(pt.volume.n_blocks) == 0 and len(pt.trajectory) == 1


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        MonoOdometryTSDF(INTR, CFG, device="cuda")
