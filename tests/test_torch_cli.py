"""The port's headless entry points, run as
``python -m azurekinect3dreconstruction_tpu_torch.cli.<name>`` in
subprocesses on the CPU: the counterparts of tests/test_scripts.py's tests
of ``live_mono`` (with and without ``--streaming``), ``dual_fusion``
(auto-calibration, the ``--sharded`` fallback on one device,
``--rig-calib``), ``record_reconstruction``, ``offline_bundle`` and its
``--resume``, ``fragments``, ``cloud_accumulate``, ``depth_to_cloud`` into
``cloud_to_mesh``, ``eval_trajectory`` and ``device_test``, and the
``mkv:`` source's error without pyk4a. Needs no jax."""

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
            "cli.live_mono", "io", "io.streams", "io.mkv", "io.k4a_live", "cli.device_test"]
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
            "cloud_accumulate", "depth_to_cloud", "cloud_to_mesh", "eval_trajectory"]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            "importlib.import_module('azurekinect3dreconstruction_tpu_torch.cli.eval_trajectory')\n"
            "assert 'torch' not in sys.modules\n"
            + "".join(f"importlib.import_module('{CLI}.{m}')\n" for m in mods)
            + "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]\n"
            + "assert 'azurekinect3dreconstruction_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
