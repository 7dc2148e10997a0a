"""The port's headless ``live_mono`` entry point, run as
``python -m azurekinect3dreconstruction_tpu_torch.cli.live_mono`` in a
subprocess on the CPU: the counterpart of tests/test_scripts.py's
``test_live_mono_saves_reconstruction`` and ``test_live_mono_streaming_mode``.
Needs no jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = ("--source", "synthetic", "--device", "cpu", "--scale", "0.25", "--frames", "4",
         "--voxel", "0.02")


def _live_mono(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "azurekinect3dreconstruction_tpu_torch.cli.live_mono",
                        *args], capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert r.returncode == 0, f"rc={r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}"
    return r.stdout + r.stderr


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
    """With jax made unimportable, the streaming manager, the pipeline and
    the entry point import and pull in neither jax nor the JAX package."""
    mods = ["tsdf", "tsdf.streaming", "tsdf.hash", "pipelines.mono_odometry_tsdf", "cli.common",
            "cli.live_mono"]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            + "".join(f"importlib.import_module('azurekinect3dreconstruction_tpu_torch.{m}')\n"
                      for m in mods)
            + "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]\n"
            + "assert 'azurekinect3dreconstruction_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
