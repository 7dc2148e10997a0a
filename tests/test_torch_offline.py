"""The port's offline bundle against the JAX package: the plain dense
odometry (``tracking.odometry.compute_odometry``), the pose graph, the
frame log, ``make_raw_batch_fn``, and ``OfflineBundle`` over the out-and-back
scans of tests/test_pipelines.py, its finalize on frames that see more than
2,048 blocks, and its resume. Quarter resolution, the SMALL_CFG of
tests/test_pipelines.py; JAX runs ``backend="xla"``. Each tolerance is
stated where it is used."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu import config as jcfg
from azurekinect3dreconstruction_tpu.core import camera as jcamera
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.core.types import RGBDFrame as JFrame
from azurekinect3dreconstruction_tpu.io import replay as jreplay
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
    make_raw_batch_fn as jmake_raw_batch_fn,
)
from azurekinect3dreconstruction_tpu.pipelines.offline_bundle import OfflineBundle as JBundle
from azurekinect3dreconstruction_tpu.tracking import posegraph as jpg
from azurekinect3dreconstruction_tpu.tracking.odometry import compute_odometry as jodometry
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu.utils.evaluation import ate
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import CameraCalibration, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame
from azurekinect3dreconstruction_tpu_torch.io import replay
from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera
from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import make_raw_batch_fn
from azurekinect3dreconstruction_tpu_torch.pipelines.offline_bundle import OfflineBundle
from azurekinect3dreconstruction_tpu_torch.tracking import posegraph as pg
from azurekinect3dreconstruction_tpu_torch.tracking.odometry import (
    compute_odometry,
    compute_odometry_frames,
)
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

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
# the out-and-back scans of tests/test_pipelines.py
LOOP_KW = dict(loop_min_gap=4, loop_radius=1.0, loop_check_interval=4)


@pytest.fixture(scope="module")
def cam():
    return JCamera(intrinsics=JINTR)


def _decode(raw):
    return JFrame.from_raw(raw[0], raw[1], CAMC.depth_scale, CAMC.depth_trunc, CAMC.depth_min)


# -- dense odometry (the reference's plain form) -------------------------------


@pytest.mark.parametrize("iters", [(2, 2, 2), (8, 8, 8), (0, 4, 2)])
def test_compute_odometry_matches_jax(cam, iters):
    """Consecutive frames of the drift test's scan, from a small initial
    motion: pose <= 1e-4 and fitness <= 1e-3 against JAX's XLA odometry at
    2 and 8 iterations a level (measured ~1e-7 and equal), and with a
    level that does not iterate."""
    poses = orbit_trajectory(6, radius=0.25, angle_span=0.9)
    init = np.asarray(jse3.se3_exp(np.array([0.004, -0.002, 0.003, 0.002, 0.001, -0.003])),
                      np.float32)
    jc = dataclasses.replace(JCFG.odometry, pyramid_iters=iters)
    pc = dataclasses.replace(CFG.odometry, pyramid_iters=iters)
    for a, b in ((0, 1), (1, 2), (3, 4)):
        fa, fb = _decode(cam.capture(poses[a])), _decode(cam.capture(poses[b]))
        arrs = [np.array(x) for x in (fa.intensity, fa.depth, fb.intensity, fb.depth)]
        want = jodometry(*arrs, JINTR, jc, init=init)
        got = compute_odometry(*map(torch.from_numpy, arrs), INTR, pc, init=torch.from_numpy(init))
        np.testing.assert_allclose(got.T_target_source.numpy(), np.asarray(want.T_target_source),
                                   rtol=0, atol=1e-4)
        assert abs(float(got.fitness) - float(want.fitness)) <= 1e-3
        assert float(got.fitness) > 0.5 and got.inliers.dtype == torch.int32
        assert abs(float(got.rmse) - float(want.rmse)) <= 1e-3 * max(1.0, float(want.rmse))
    frames = [RGBDFrame(*(torch.from_numpy(np.array(x)) for x in (f.depth, f.color, f.intensity)))
              for f in (fa, fb)]
    again = compute_odometry_frames(*frames, INTR, pc, init=torch.from_numpy(init))
    assert torch.equal(again.T_target_source, got.T_target_source)


def test_compute_odometry_without_iterations_passes_through():
    """No level iterates: the pose is the initial one and the statistics
    stay zero, as in JAX's."""
    z = torch.full((INTR.height, INTR.width), 1.5)
    i = torch.rand((INTR.height, INTR.width), generator=torch.Generator().manual_seed(0))
    init = torch.eye(4)
    init[:3, 3] = torch.tensor([0.01, 0.0, -0.02])
    cfg = dataclasses.replace(CFG.odometry, pyramid_iters=(0, 0, 0))
    res = compute_odometry(i, z, i, z, INTR, cfg, init=init)
    assert torch.equal(res.T_target_source, init)
    assert float(res.fitness) == 0.0 and int(res.inliers) == 0


# -- pose graph -------------------------------------------------------------------


def _graphs():
    """One graph in both packages: a 12-node chain whose odometry edges
    drift, a consistent loop closure and a wild one (to be pruned)."""
    rng = np.random.RandomState(2)
    truth = [np.eye(4)]
    for _ in range(11):
        truth.append(truth[-1] @ jpg._exp(np.r_[rng.uniform(-0.1, 0.1, 3),
                                                rng.uniform(-0.05, 0.05, 3)]))
    meas = [np.linalg.inv(truth[k - 1]) @ truth[k] @ jpg._exp(rng.normal(0, 0.01, 6))
            for k in range(1, 12)]
    gj, gp = jpg.PoseGraph(), pg.PoseGraph()
    for g in (gj, gp):
        node = np.eye(4)
        g.add_node(node)
        for k, m in enumerate(meas, start=1):
            node = node @ m
            g.add_node(node)
            g.add_edge(k - 1, k, m)
        g.add_edge(0, 11, np.linalg.inv(truth[0]) @ truth[11], uncertain=True)
        g.add_edge(2, 9, jpg._exp(np.r_[1.0, -0.5, 0.3, 0.4, 0.2, 0.1]), uncertain=True)
    return gj, gp


def test_optimize_matches_jax():
    """LM on one graph through both packages: nodes within 1e-9, the same
    edges kept (the wild loop closure pruned), the chain end pulled in."""
    gj, gp = _graphs()
    oj = jpg.optimize(gj, max_iterations=50, edge_prune_threshold=0.25,
                      preference_loop_closure=2.0)
    op = pg.optimize(gp, max_iterations=50, edge_prune_threshold=0.25,
                     preference_loop_closure=2.0)
    assert len(op.nodes) == len(oj.nodes) == 12
    for a, b in zip(op.nodes, oj.nodes):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert [(e.source, e.target) for e in op.edges] == [(e.source, e.target) for e in oj.edges]
    assert len(op.edges) == len(gp.edges) - 1
    assert pg.optimize(pg.PoseGraph()).nodes == []  # nothing to optimize


def test_find_loop_closures_matches_jax():
    rng = np.random.RandomState(5)
    pos = np.cumsum(rng.normal(0, 0.15, (40, 3)), axis=0)
    for radius, gap, excl in ((0.5, 5, None), (0.8, 10, {(0, 25), (3, 30)}), (2.0, 0, set())):
        want = jpg.find_loop_closures(pos, radius, gap, exclude=excl)
        assert pg.find_loop_closures(pos, radius, gap, exclude=excl) == want
        assert all(j - i > gap for i, j in want)
    assert len(pg.find_loop_closures(pos, 0.8, 10)) > 2


def test_pose_graph_json_cross_reads(tmp_path):
    """A graph saved by one package loads in the other unchanged."""
    gj, gp = _graphs()
    pp, pj = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    gp.save(pp)
    gj.save(pj)
    for g, loaded in ((gp, jpg.PoseGraph.load(pp)), (gj, pg.PoseGraph.load(pj))):
        assert len(loaded.nodes) == len(g.nodes)
        for a, b in zip(loaded.nodes, g.nodes):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(loaded.edges, g.edges):
            assert (a.source, a.target, a.uncertain) == (b.source, b.target, b.uncertain)
            np.testing.assert_array_equal(a.transformation, b.transformation)
            np.testing.assert_array_equal(a.information, b.information)
    assert json.loads(gp.to_json()) == json.loads(gj.to_json())


# -- frame log --------------------------------------------------------------------


def test_frame_logs_cross_read(cam, tmp_path):
    """npz frame logs (u16 depth; u8 RGB, and BGRA as a raw capture gives
    it) and their calibration, written by one package and replayed by the
    other: the same frames, BGRA as RGB."""
    frames = [cam.capture(T) for T in orbit_trajectory(3, radius=0.2, angle_span=0.3)]
    d, c = frames[2]
    bgra = np.concatenate([c[..., ::-1], np.full(c.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    logged = frames[:2] + [(d, bgra)]
    calib = CameraCalibration.azure_kinect_nominal("cross")
    for writer, reader in ((replay.FrameRecorder, jreplay.NpzReplaySource),
                           (jreplay.FrameRecorder, replay.NpzReplaySource)):
        out = str(tmp_path / writer.__module__.split(".")[0])
        rec = writer(out)
        for dd, cc in logged:
            rec.write(dd, cc)
        with open(os.path.join(out, "calibration.json"), "w") as fh:
            fh.write(calib.to_json())
        src = reader(out)
        assert len(src) == 3 and src.calibration.serial == "cross"
        assert src.calibration.depth.width == calib.depth.width
        for (dd, cc), (rd, rc) in zip(frames, src):
            np.testing.assert_array_equal(rd, dd)
            np.testing.assert_array_equal(rc, cc)
    assert len(replay.NpzReplaySource(out, limit=2)) == 2


def test_synthetic_source_replays_the_camera():
    pcam = SyntheticCamera(intrinsics=INTR, device="cpu")
    poses = orbit_trajectory(2, radius=0.2, angle_span=0.3)
    src = replay.SyntheticSource(pcam, poses)
    assert len(src) == 2 and src.calibration.serial == "synthetic"
    for (d, c, T), (d2, c2) in zip(src.frames_with_poses(), src):
        np.testing.assert_array_equal(d, d2)
        assert d.dtype == np.uint16 and c.dtype == np.uint8 and T.shape == (4, 4)


# -- raw batch reintegration ------------------------------------------------------


def _by_key(fields):
    n = int(fields["n_blocks"])
    return {tuple(k): s for s, k in enumerate(fields["block_coords"][:n].tolist())}


def _assert_same_voxels(a, b):
    """Two volumes (numpy field dicts, JAX layout) hold the same blocks, and
    block by block the same voxels, to the bit."""
    ka, kb = _by_key(a), _by_key(b)
    assert ka.keys() == kb.keys() and len(ka) > 50
    for f in ("weight", "tsdf", "color"):
        rows = lambda v, keys: np.stack([v[f][keys[k]].reshape(-1) for k in ka])
        np.testing.assert_array_equal(rows(a, ka), rows(b, kb), err_msg=f)


def _numpy(vol):
    return {k: np.array(v) for k, v in interop.volume_to_numpy(vol).items()}


def test_raw_batch_matches_per_frame_and_jax(cam):
    """tests/test_pipelines.py::test_raw_batch_reintegration_matches_per_frame
    in the port: five frames and three zero-depth pad frames through
    ``make_raw_batch_fn`` equal per-frame ``integrate_frame`` pool for pool,
    and JAX's batch (``backend="xla"``) block by block, to the bit (the
    plain B1 equals JAX's integrate to the bit); the pads integrate nothing."""
    poses = orbit_trajectory(5, radius=0.25, angle_span=0.5)
    frames = [cam.capture(T) for T in poses]
    pad = 3
    ds = np.stack([f[0] for f in frames] + [np.zeros_like(frames[0][0])] * pad)
    cs = np.stack([f[1] for f in frames] + [np.zeros_like(frames[0][1])] * pad)
    Ts = np.stack([np.asarray(T, np.float32) for T in poses] + [np.eye(4, dtype=np.float32)] * pad)
    rays = pixel_rays(INTR, "cpu")
    got = make_raw_batch_fn(INTR, CFG.tsdf)(tsdf.create(CFG.tsdf, "cpu"), torch.from_numpy(ds),
                                            torch.from_numpy(cs), torch.from_numpy(Ts), rays,
                                            *SCAL)
    assert not bool(got.overflow)
    ref = tsdf.create(CFG.tsdf, "cpu")
    for (d, c), T in zip(frames, poses):
        f = RGBDFrame.from_raw(torch.from_numpy(d), torch.from_numpy(c), CAMC.depth_scale,
                               CAMC.depth_trunc, CAMC.depth_min)
        ref = tsdf.integrate_frame(ref, f.depth, f.color, rays,
                                   torch.as_tensor(T, dtype=torch.float32), INTR, CFG.tsdf)
    for k in ("n_blocks", "block_coords", "weight", "tsdf", "color"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    jbatch = jmake_raw_batch_fn(JINTR, JCFG.tsdf, backend="xla")
    want = jbatch(jtsdf.create(JCFG.tsdf), ds, cs, Ts, jcamera.pixel_rays(JINTR),
                  *(np.float32(s) for s in SCAL))
    _assert_same_voxels(_numpy(got), {k: np.asarray(v) for k, v in want._asdict().items()})
    empty = make_raw_batch_fn(INTR, CFG.tsdf)(tsdf.create(CFG.tsdf, "cpu"),
                                              torch.from_numpy(ds[-pad:]),
                                              torch.from_numpy(cs[-pad:]),
                                              torch.from_numpy(Ts[-pad:]), rays, *SCAL)
    assert int(empty.n_blocks) == 0 and float(empty.weight.sum()) == 0.0


# -- OfflineBundle ----------------------------------------------------------------


def test_offline_bundle_loop_and_reintegrate(cam, tmp_path):
    """tests/test_pipelines.py::test_offline_bundle_loop_and_reintegrate in
    the port (its bounds), with JAX's pipeline beside it: the same loop
    closures and nodes within 1e-3; then resume."""
    fwd = orbit_trajectory(4, radius=0.2, angle_span=0.4)
    raw = [cam.capture(T) for T in fwd + fwd[::-1]]
    pipe = OfflineBundle(INTR, CFG, device="cpu", output_dir=str(tmp_path / "port"),
                         checkpoint_interval=4, **LOOP_KW)
    jpipe = JBundle(JINTR, JCFG, output_dir=str(tmp_path / "jax"), backend="xla",
                    checkpoint_interval=4, **LOOP_KW)
    for d, c in raw:
        pipe.process_frame(d, c)
        jpipe.process_frame(d, c)
    assert pipe.n_frames == len(raw)
    mesh = pipe.finalize()
    jpipe.finalize(extract=False)
    assert mesh is not None and mesh.triangles.shape[0] > 200
    assert not bool(pipe.volume.overflow)
    assert np.linalg.norm(pipe.graph.nodes[-1][:3, 3] - pipe.graph.nodes[0][:3, 3]) < 0.05
    assert pipe.telemetry._counters == jpipe.telemetry._counters
    for a, b in zip(pipe.graph.nodes, jpipe.graph.nodes):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    assert set(pipe.last_finalize_stats) == {"n_frames", "loops_s", "optimize_s",
                                             "reintegrate_s", "extract_s"}
    for kind in ("optimized_mesh.ply", "optimized_trajectory.txt"):
        assert os.path.exists(os.path.join(str(tmp_path / "port"), "latest_" + kind))
    resumed = OfflineBundle.resume(INTR, str(tmp_path / "port"), CFG, device="cpu", **LOOP_KW)
    assert resumed.n_frames == len(raw)


def test_offline_bundle_optimization_reduces_drift(cam, tmp_path):
    """tests/test_pipelines.py::test_offline_bundle_optimization_reduces_drift
    in the port: with 2 GN iterations a level the raw chain drifts, and the
    loop-closed, optimized trajectory beats it on ATE and final drift."""
    cfg = dataclasses.replace(CFG, odometry=dataclasses.replace(CFG.odometry,
                                                                pyramid_iters=(2, 2, 2)))
    pipe = OfflineBundle(INTR, cfg, device="cpu", output_dir=str(tmp_path),
                         checkpoint_interval=0, **LOOP_KW)
    fwd = orbit_trajectory(6, radius=0.25, angle_span=0.9)
    poses = fwd + fwd[::-1]
    gt = [np.linalg.inv(poses[0]) @ T for T in poses]
    for T in poses:
        pipe.process_frame(*cam.capture(T))
    assert pipe.finalize(extract=False) is None
    raw = [np.eye(4)]
    for e in pipe.graph.edges:
        if not e.uncertain and e.target == e.source + 1:
            raw.append(raw[-1] @ e.transformation)
    assert len(raw) == len(gt)
    a_raw = ate(raw, gt, align=False)
    a_opt = ate(pipe.graph.nodes, gt, align=False)
    assert a_raw["final_drift"] > 0.005, a_raw
    assert pipe.telemetry._counters.get("loop_closures", 0) >= 1
    assert a_opt["rmse"] < a_raw["rmse"], (a_opt, a_raw)
    assert a_opt["final_drift"] < 0.3 * a_raw["final_drift"], (a_opt, a_raw)


# 5 mm voxels in 8^3 blocks: a quarter-resolution frame sees thousands of blocks
FINE = TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=8, block_capacity=8192,
                  hash_capacity=32768)


def test_finalize_keeps_blocks_past_a_2048_row_worklist(cam, tmp_path):
    """Frames that see more than 2,048 blocks: the finalize equals per-frame
    ``integrate_frame`` at the optimized poses and its ``overflow`` stays
    false, where a 2,048-row worklist (the JAX package's finalize) sets the
    flag and loses voxels."""
    cfg = dataclasses.replace(CFG, tsdf=FINE)
    pipe = OfflineBundle(INTR, cfg, device="cpu", output_dir=str(tmp_path),
                         checkpoint_interval=0, **LOOP_KW)
    poses = orbit_trajectory(3, radius=0.2, angle_span=0.3)
    raw = [cam.capture(T) for T in poses]
    for d, c in raw:
        pipe.process_frame(d, c)
    pipe.finalize(extract=False)
    got = pipe.volume
    assert not bool(got.overflow)
    rays = pixel_rays(INTR, "cpu")
    ref = tsdf.create(FINE, "cpu")
    frames = [RGBDFrame.from_raw(torch.from_numpy(d), torch.from_numpy(c), CAMC.depth_scale,
                                 CAMC.depth_trunc, CAMC.depth_min) for d, c in raw]
    for f, T in zip(frames, pipe.graph.nodes):
        ref = tsdf.integrate_frame(ref, f.depth, f.color, rays,
                                   torch.as_tensor(T, dtype=torch.float32), INTR, FINE)
    for k in ("n_blocks", "block_coords", "weight", "tsdf", "color"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    T_last = torch.as_tensor(pipe.graph.nodes[-1], dtype=torch.float32)
    _, n_active = tk.build_worklist(got.block_coords, got.n_blocks, T_last, INTR, FINE)
    assert int(n_active) > 2048
    short = make_raw_batch_fn(INTR, FINE, worklist_size=2048)
    lost = short(tsdf.create(FINE, "cpu"), *(torch.from_numpy(np.stack(a)) for a in zip(*raw)),
                 torch.as_tensor(np.stack(pipe.graph.nodes), dtype=torch.float32), rays, *SCAL)
    assert bool(lost.overflow) and float(lost.weight.sum()) < float(got.weight.sum())


def test_finalize_raises_on_overflow(cam, tmp_path):
    """A pool too small for the scan: finalize raises instead of returning
    a volume that silently lost blocks."""
    tiny = dataclasses.replace(FINE, block_capacity=512, hash_capacity=2048)
    pipe = OfflineBundle(INTR, dataclasses.replace(CFG, tsdf=tiny), device="cpu",
                         output_dir=str(tmp_path), checkpoint_interval=0, **LOOP_KW)
    pipe.process_frame(*cam.capture(orbit_trajectory(1)[0]))
    with pytest.raises(RuntimeError, match="overflow"):
        pipe.finalize()
    assert bool(pipe.volume.overflow)


def test_resume_retracks_frames_logged_after_the_checkpoint(cam, tmp_path):
    """Frames logged after the last pose-graph checkpoint are tracked again
    on resume, and the log keeps each of them as it was written (the JAX
    package's resume rewrites them all into the last file)."""
    poses = orbit_trajectory(6, radius=0.2, angle_span=0.4)
    raw = [cam.capture(T) for T in poses]
    out = str(tmp_path)
    pipe = OfflineBundle(INTR, CFG, device="cpu", output_dir=out, checkpoint_interval=3,
                         **LOOP_KW)
    for d, c in raw:
        pipe.process_frame(d, c)
    assert len(pg.PoseGraph.load(os.path.join(out, "pose_graph.json")).nodes) == 4
    resumed = OfflineBundle.resume(INTR, out, CFG, device="cpu", **LOOP_KW)
    assert resumed.n_frames == len(raw)
    for a, b in zip(resumed.graph.nodes, pipe.graph.nodes):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for (d, c), (rd, rc) in zip(raw, replay.NpzReplaySource(os.path.join(out, "frames"))):
        np.testing.assert_array_equal(rd, d)
        np.testing.assert_array_equal(rc, c)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        OfflineBundle(INTR, CFG, device="cuda")


def test_slice_modules_import_without_jax():
    """With jax made unimportable, every module this slice adds imports and
    pulls in neither jax nor the JAX package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["pipelines.recorder", "pipelines.offline_bundle", "tracking.posegraph",
            "tracking.odometry", "tracking.motion", "io.replay", "utils.telemetry",
            "pipelines.mono_odometry_tsdf"]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            + "".join(f"importlib.import_module('azurekinect3dreconstruction_tpu_torch.{m}')\n"
                      for m in mods)
            + "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]\n"
            + "assert 'azurekinect3dreconstruction_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
