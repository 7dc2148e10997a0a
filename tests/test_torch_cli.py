"""The port's headless entry points, run as
``python -m azurekinect3dreconstruction_tpu_torch.cli.<name>`` in
subprocesses on the CPU: the counterparts of tests/test_scripts.py's tests
of ``live_mono`` (with and without ``--streaming``), ``dual_fusion``
(auto-calibration, the ``--sharded`` fallback on one device,
``--rig-calib``, the route it names when no pair calibrates),
``record_reconstruction``, ``offline_bundle`` and its
``--resume``, ``fragments``, ``cloud_accumulate``, ``depth_to_cloud`` into
``cloud_to_mesh``, ``eval_trajectory`` and ``device_test``, and the
``mkv:`` source's error without pyk4a; and of the live viewer: ``live_mono``'s
loop served to a browser viewer in process (keys over HTTP acting on the
next tick, the served geometry, the preview on save), ``--serve``,
``live_viewer``, ``view_results``, ``generate_checkerboard`` and
``calibrate_rig`` into ``dual_fusion --rig-calib``. Needs no jax."""

import functools
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ("--source", "synthetic", "--device", "cpu", "--scale", "0.25")
QUICK = BASE + ("--frames", "4", "--voxel", "0.02")
CLI = "azurekinect3dreconstruction_tpu_torch.cli"


def _run(name, *args):
    """``cli.<name>`` in a subprocess; its stdout and stderr together."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", f"{CLI}.{name}", *args], capture_output=True,
                       text=True, timeout=600, cwd=REPO, env=env)
    assert r.returncode == 0, f"{name} rc={r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}"
    return r.stdout + r.stderr


def _live_mono(*args):
    return _run("live_mono", *args)


@pytest.mark.parametrize("streaming", [False, True])
def test_live_mono_saves_reconstruction(tmp_path, streaming):
    out = _live_mono(*QUICK, "--output", str(tmp_path), *(["--streaming"] if streaming else []))
    assert ("streaming: reload<" in out) == streaming, out
    assert "0 gate rejections" in out and "overflow False" in out, out
    names = os.listdir(tmp_path)
    for kind in ("latest_mesh.ply", "latest_volume_pcd.ply", "latest_trajectory.txt",
                 "latest_gt_trajectory.txt"):
        assert kind in names, (kind, names)
    traj = np.loadtxt(tmp_path / "latest_trajectory.txt")
    gt = np.loadtxt(tmp_path / "latest_gt_trajectory.txt")
    assert traj.shape == gt.shape == (5, 16)  # the identity, then 4 frames
    assert np.abs(traj - gt).max() < 0.02
    assert os.path.getsize(tmp_path / "latest_mesh.ply") > 10000


def test_live_mono_without_a_card_raises(tmp_path):
    """The entry point runs on the card unless asked for the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "azurekinect3dreconstruction_tpu_torch.cli.live_mono",
                        "--frames", "1", "--scale", "0.25", "--output", str(tmp_path)],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr[-2000:]


def test_streaming_and_cli_modules_import_without_jax():
    """With jax made unimportable, the streaming manager, the pipeline, the
    sources, the feeder and the entry points import and pull in neither jax
    nor the JAX package."""
    mods = ["tsdf", "tsdf.streaming", "tsdf.hash", "pipelines.mono_odometry_tsdf", "cli.common",
            "cli.live_mono", "io", "io.streams", "io.mkv", "io.k4a_live", "cli.device_test",
            "io.native", "viz", "viz.render", "viz.webgl_core", "viz.html_export",
            "viz.live_server", "viz.o3d_bridge", "viz.browsers", "viz.savers", "calib",
            "calib.checkerboard", "calib.checkerboard_np"]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            + "".join(f"importlib.import_module('azurekinect3dreconstruction_tpu_torch.{m}')\n"
                      for m in mods)
            + "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]\n"
            + "assert 'azurekinect3dreconstruction_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_device_test_reports_the_synthetic_camera_and_the_device():
    """tests/test_scripts.py's ``device_test`` on the CPU: no camera, so the
    synthetic source's shapes, then a product on the device."""
    out = _run("device_test", "--source", "synthetic", "--device", "cpu")
    assert "no camera; exercising the synthetic source" in out, out
    assert "depth (576, 640) uint16" in out and "device matmul OK: 16777216.0" in out, out


def test_live_mono_mkv_source_without_pyk4a_exits_clearly(tmp_path):
    """``--source mkv:`` without pyk4a exits non-zero naming the missing
    SDK, before any frame."""
    r = subprocess.run([sys.executable, "-m", f"{CLI}.live_mono", "--source", "mkv:/nonexistent",
                        "--device", "cpu", "--frames", "2", "--output", str(tmp_path)],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode != 0 and "--source mkv:/nonexistent: pyk4a is not installed" in r.stderr, \
        r.stderr[-2000:]
    assert "Traceback" not in r.stderr


@pytest.fixture(scope="module")
def mono_results(tmp_path_factory):
    """One synthetic ``live_mono`` run, for the trajectory scorer."""
    out = tmp_path_factory.mktemp("mono")
    _live_mono(*QUICK, "--output", str(out))
    return out


@pytest.fixture(scope="module")
def cloud_ply(tmp_path_factory):
    """One ``depth_to_cloud --record`` run: a PLY for ``cloud_to_mesh``, and
    the npz frame log beside it."""
    out = tmp_path_factory.mktemp("clouds")
    _run("depth_to_cloud", *BASE, "--frames", "2", "--save-every", "1", "--record",
         "--output", str(out))
    plys = glob.glob(str(out / "cloud_*.ply"))
    assert plys, os.listdir(out)
    assert len(glob.glob(str(out / "frames" / "frame_*.npz"))) == 2
    return plys[0]


@pytest.mark.parametrize("sharded", [False, True])
def test_dual_fusion_auto_calibrates_and_saves(tmp_path, sharded):
    """The synthetic rig calibrates on its first pair and the merged cloud
    and the mesh are saved; ``--sharded`` on one device falls back with the
    JAX script's warning."""
    out = _run("dual_fusion", *QUICK, "--frames", "3", "--output", str(tmp_path),
               *(["--sharded"] if sharded else []))
    assert ("falling back to single-device" in out) == sharded, out
    assert "calibrated True, sharded False" in out and "final extrinsic rpy deg" in out, out
    names = os.listdir(tmp_path)
    for kind in ("latest_merged.ply", "latest_mesh.obj"):
        assert kind in names, (kind, names)


def test_dual_fusion_reads_a_port_rig_calibration(tmp_path):
    """``--rig-calib`` loads a ``RigCalibration`` the port wrote and skips
    the auto-calibration."""
    from azurekinect3dreconstruction_tpu_torch.calib.extrinsics import RigCalibration

    T1 = np.eye(4)
    T1[:3, 3] = (0.12, 0.02, -0.02)
    RigCalibration(["cam0", "cam1"], [np.eye(4), T1]).save(str(tmp_path / "calib"))
    out = _run("dual_fusion", *QUICK, "--frames", "2", "--output", str(tmp_path / "out"),
               "--rig-calib", str(tmp_path / "calib"))
    assert "rig calibration loaded: baseline 0.1233 m" in out, out
    assert "calibrated: overlap" not in out and "calibrated True" in out, out
    assert "latest_mesh.obj" in os.listdir(tmp_path / "out")


def test_dual_fusion_names_the_rig_route_when_uncalibrated(tmp_path, monkeypatch, capsys):
    """In-process, every calibration refinement scripted to land camera 1
    40 cm in front of the truth: no pair passes the free-space gate, and
    the summary line says so and names the checkerboard route."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.cli import dual_fusion
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.pipelines import dual_fusion as pipeline
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import ICPResult

    wrong = se3.se3_exp(torch.tensor(dual_fusion.RIG_XI, dtype=torch.float64)).float()
    wrong[2, 3] -= 0.4
    scripted = lambda *a, **k: ICPResult(T=wrong.clone(), fitness=torch.tensor(0.9),
                                         inlier_rmse=torch.tensor(0.01),
                                         inliers=torch.tensor(1000, dtype=torch.int32))
    monkeypatch.setattr(pipeline, "icp_point_to_plane", scripted)
    monkeypatch.setattr(pipeline, "colored_icp", scripted)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # as the subprocesses' OMP_NUM_THREADS
    try:
        assert dual_fusion.main([*QUICK, "--frames", "1", "--output", str(tmp_path)]) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "calibrated False" in out and '"calib_reject": 1' in out, out
    assert "no pair calibrated" in out and "cli.calibrate_rig" in out and "--rig-calib" in out, out
    assert "latest_mesh.obj" in os.listdir(tmp_path)


def test_record_reconstruction_saves(tmp_path):
    out = _run("record_reconstruction", *QUICK, "--frames", "3", "--autostart",
               "--output", str(tmp_path))
    assert "3 frames recorded" in out, out
    names = os.listdir(tmp_path)
    for kind in ("latest_mesh.ply", "latest_volume_pcd.ply", "latest_trajectory.txt"):
        assert kind in names, (kind, names)
    assert np.loadtxt(tmp_path / "latest_trajectory.txt").shape == (4, 16)


def test_offline_bundle_and_resume(tmp_path):
    """Log, track and finalize; then ``--resume`` rebuilds from the frame
    log and finalizes again."""
    _run("offline_bundle", *QUICK, "--frames", "3", "--output", str(tmp_path))
    assert len(glob.glob(str(tmp_path / "frames" / "frame_*.npz"))) == 3
    out = _run("offline_bundle", *QUICK, "--frames", "3", "--output", str(tmp_path), "--resume")
    assert "resumed with 3 frames" in out and "final mesh:" in out, out
    assert "latest_optimized_mesh.ply" in os.listdir(tmp_path)


def test_fragments(tmp_path, monkeypatch, capsys):
    """In-process, with the fragments' mesh samples cut to 4,000 so that the
    registration stays quick on the CPU."""
    from azurekinect3dreconstruction_tpu_torch.cli import fragments
    from azurekinect3dreconstruction_tpu_torch.pipelines.fragments import FragmentPipeline

    monkeypatch.setattr(fragments, "FragmentPipeline",
                        functools.partial(FragmentPipeline, sample_points=4000))
    assert fragments.main([*QUICK, "--frames", "4", "--capture-every", "2",
                           "--output", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "from 2 fragments" in out, out
    assert "latest_fragments_mesh.ply" in os.listdir(tmp_path)


def test_cloud_accumulate_saves_model(tmp_path):
    out = _run("cloud_accumulate", *BASE, "--frames", "6", "--keyframe-interval", "2",
               "--output", str(tmp_path))
    assert "saved model: pointcloud" in out, out
    assert any("model" in n and n.endswith(".ply") for n in os.listdir(tmp_path))


@pytest.mark.parametrize("method", ["sdf", "ballpivot"])
def test_depth_to_cloud_and_cloud_to_mesh(cloud_ply, tmp_path, method):
    """The recorded cloud meshes through the first-party meshers."""
    from azurekinect3dreconstruction_tpu_torch.viz.savers import read_ply

    mesh = str(tmp_path / "mesh.ply")
    _run("cloud_to_mesh", cloud_ply, mesh, "--voxel", "0.02", "--method", method,
         "--device", "cpu")
    verts, _, faces = read_ply(mesh)
    assert faces is not None and len(faces) > 1000 and np.isfinite(verts).all()


def test_eval_trajectory_scores_synthetic_run(mono_results):
    """The synthetic ``live_mono`` run's trajectory against its ground
    truth: the identity and 4 frames, sub-centimetre ATE; the readable
    report too."""
    est = str(mono_results / "latest_trajectory.txt")
    gt = str(mono_results / "latest_gt_trajectory.txt")
    m = json.loads(_run("eval_trajectory", est, gt, "--json").strip().splitlines()[-1])
    assert m["n_poses"] == 5
    assert m["ate_rmse_m"] < 0.01 and m["rpe_rot_rmse_deg"] < 1.0, m
    assert "ATE rmse" in _run("eval_trajectory", est, gt)


def test_pipeline_cli_modules_import_without_jax():
    """With jax made unimportable, every entry point imports, and
    ``eval_trajectory`` without torch."""
    mods = ["dual_fusion", "record_reconstruction", "offline_bundle", "fragments",
            "cloud_accumulate", "depth_to_cloud", "cloud_to_mesh", "eval_trajectory",
            "live_viewer", "view_results", "calibrate_rig", "generate_checkerboard"]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            "importlib.import_module('azurekinect3dreconstruction_tpu_torch.cli.eval_trajectory')\n"
            "assert 'torch' not in sys.modules\n"
            + "".join(f"importlib.import_module('{CLI}.{m}')\n" for m in mods)
            + "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]\n"
            + "assert 'azurekinect3dreconstruction_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


# -- the live viewer and the calibration entry points -------------------------------


def _http(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _tri_set(verts) -> set:
    """Triangle centroids of a (3n, 3) soup at 5 decimals."""
    return {tuple(x) for x in np.round(np.asarray(verts).reshape(-1, 3, 3).mean(1), 5).tolist()}


def _png_size_and_pixels(path):
    """(width, height, RGB rows) of a PNG written by ``viz.render.write_png``."""
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.rindex(b"IEND") - 4])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)
    return w, h, rows


def test_live_mono_served_loop_keys_act_on_the_next_tick(tmp_path):
    """``cli.live_mono``'s loop in process at quarter resolution, 6 frames,
    a vis frame every 2, served by a ``BrowserLiveViewer`` on a free port:
    ``M``, ``S`` and ``=`` sent over HTTP while the loop runs wait until
    the next ``tick`` and act there (mesh mode from the next vis frame, the
    save with its preview, depth scale 1,100); the served mesh is the
    volume's ``extract_mesh`` (count and centroid set) and the served bytes
    its pack; the status shows the frame and a finite rate; the trajectory
    up to the ``=`` equals a headless run's to the bit."""
    from urllib.parse import quote

    from azurekinect3dreconstruction_tpu_torch.cli.common import NullViewer
    from azurekinect3dreconstruction_tpu_torch.cli.live_mono import LiveSession
    from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
        SyntheticCamera,
        orbit_trajectory,
    )
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
    from azurekinect3dreconstruction_tpu_torch.viz.live_server import (
        BrowserLiveViewer,
        pack_geometry,
    )
    from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver

    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    cam = SyntheticCamera(intrinsics=intr, device="cpu")
    poses = orbit_trajectory(6, radius=0.35, angle_span=1.0)
    frames = [cam.capture(T) for T in poses]
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08), vis_update_interval=2)

    def session(viewer, out):
        return LiveSession(MonoOdometryTSDF(intr, cfg, device="cpu"), viewer,
                           ResultSaver(str(out)), gt_poses=poses)

    headless = session(NullViewer(), tmp_path / "headless")
    headless.run(iter(frames))
    assert headless.vis_frames == [] and headless.keys == []
    viewer = BrowserLiveViewer(port=0)
    seen = {}

    def on_frame(s, i):
        url = viewer.server.url
        if i in s.sent.get("mesh", (None,))[:1]:
            soup = s.sent["mesh"][1]
            blob = _http(url + "geometry.bin?name=surface")
            full = mc.extract_mesh(s.pipe.volume, cfg.tsdf)
            nt = int(full.num_triangles)
            seen[i] = (blob == pack_geometry(soup, int.from_bytes(blob[8:12], "little")),
                       soup.triangles.shape[0] == nt,
                       _tri_set(soup.vertices) == _tri_set(full.vertices[:3 * nt]))
        if i == 4:
            seen["status"] = json.loads(_http(url + "meta.json"))["status"]
        key = {1: "m", 3: "s", 4: "="}.get(i)
        if key:
            before = list(s.keys)
            assert _http(url + "key?c=" + quote(key)) == b"ok"
            assert s.keys == before  # queued until the tick

    try:
        served = session(viewer, tmp_path / "served")
        served.run(iter(frames), on_frame=on_frame)
    finally:
        viewer.close()
    assert served.keys == [(1, "M"), (3, "S"), (4, "=")]
    assert served.vis_frames == [(0, "cloud"), (2, "mesh"), (4, "mesh")]
    assert seen[2] == seen[4] == (True, True, True)
    status = seen["status"].split(" | ")
    assert status[0] == "frame 4" and np.isfinite(float(status[1].split()[0]))
    assert served.pipe.cfg.camera.depth_scale == 1100.0
    names = os.listdir(tmp_path / "served")
    for kind in ("latest_mesh.ply", "latest_volume_pcd.ply", "latest_trajectory.txt",
                 "latest_preview.png"):
        assert kind in names, (kind, names)
    w, h, rows = _png_size_and_pixels(tmp_path / "served" / "latest_preview.png")
    assert (w, h) == (640, 480) and (np.abs(rows.astype(int) - [18, 18, 24]).sum(-1) > 10).any()
    a, b = np.stack(served.pipe.trajectory), np.stack(headless.pipe.trajectory)
    assert a.shape == b.shape == (7, 4, 4)
    assert np.array_equal(a[:6], b[:6])  # frames 0-4; the "=" acts from frame 5


def test_live_mono_serve_flag(tmp_path):
    """``--serve 0`` runs the loop against the browser viewer on a free
    port, and the save writes the preview."""
    out = _live_mono(*QUICK, "--frames", "3", "--serve", "0", "--output", str(tmp_path))
    assert "live viewer serving at http://127.0.0.1:" in out, out
    assert "latest_preview.png" in os.listdir(tmp_path)


def test_live_viewer_headless():
    out = _run("live_viewer", *BASE, "--frames", "2", "--position-colors", "--headless")
    assert "2 frames shown" in out, out


def test_view_results_list_only_and_html(mono_results, tmp_path):
    """``--list-only`` names the newest result; ``--html`` writes the newest
    mesh as a self-contained WebGL page with the geometry embedded."""
    out = _run("view_results", "--mode", "latest", "--dir", str(mono_results), "--list-only")
    assert "newest result" in out, out
    out = _run("view_results", "--mode", "choose", "--dir", str(mono_results), "--list-only")
    assert "latest_mesh.ply" in out, out
    page = str(tmp_path / "viewer.html")
    out = _run("view_results", "--mode", "mesh", "--dir", str(mono_results), "--html", page)
    assert "HTML viewer written" in out, out
    html = open(page).read()
    assert "webgl" in html and 'pos: "' in html and os.path.getsize(page) > 10_000


def test_generate_checkerboard(tmp_path):
    """One board per size, the generator's array (PNG through OpenCV where
    it imports, else .npy)."""
    from azurekinect3dreconstruction_tpu_torch.calib.checkerboard import generate_checkerboard
    from azurekinect3dreconstruction_tpu_torch.cli import generate_checkerboard as gen

    assert gen.main(["--output", str(tmp_path), "--sizes", "60", "20"]) == 0
    for s in (60, 20):
        (path,) = glob.glob(str(tmp_path / f"checkerboard_10x7_{s}px.*"))
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            import cv2

            img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(img, generate_checkerboard(10, 7, s))


def test_calibrate_rig_then_dual_fusion_reads_it(tmp_path):
    """The checkerboard workflow end to end (tests/test_scripts.py's): 8
    synthetic board views -> intrinsics -> stereo extrinsic -> the rig
    JSON, then ``dual_fusion --rig-calib`` loads it instead of
    auto-calibrating."""
    calib = str(tmp_path / "calibration")
    out = _run("calibrate_rig", "--source", "synthetic", "--views", "8", "--calib-dir", calib)
    assert glob.glob(os.path.join(calib, "rig_*.json")), out
    assert "baseline" in out and "synthetic ground-truth baseline error" in out, out
    out = _run("dual_fusion", *QUICK, "--frames", "2", "--output", str(tmp_path / "results"),
               "--rig-calib", calib)
    assert "rig calibration loaded" in out and "calibrated: overlap" not in out, out
    assert 'calibration events {}' in out, out
