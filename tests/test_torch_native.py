"""The port's native host runtime (``io/native.py``): the six cases of
tests/test_native.py on the port's bindings, its binary PLY bytes against
the port's Python writers', and its build: one compile into a hashed
library under the build directory however many processes load at once, the
compiler's output on a failed build, and the JAX package's
``native/libkinrt.so`` left alone. Each test skips only where ``g++`` is
missing, and says so."""

import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost, TriangleMeshHost
from azurekinect3dreconstruction_tpu_torch.io import native
from azurekinect3dreconstruction_tpu_torch.viz import savers
from azurekinect3dreconstruction_tpu_torch.viz.savers import read_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native runtime is built with g++")


# -- the cases of tests/test_native.py -----------------------------------------------


def test_framelog_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    frames = [(rng.randint(0, 4000, (144, 160)).astype(np.uint16),
               rng.randint(0, 255, (144, 160, 3)).astype(np.uint8)) for _ in range(5)]
    path = str(tmp_path / "log.kinlog")
    with native.NativeFrameLogWriter(path) as w:
        for d, c in frames:
            w.write(d, c)
    assert w.count == 5
    r = native.NativeFrameLogReader(path)
    out = list(r)
    r.close()
    assert len(out) == 5
    for (d0, c0), (d1, c1) in zip(frames, out):
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(c0, c1)


def test_framelog_smaller_than_npz(tmp_path):
    rng = np.random.RandomState(1)
    v, u = np.mgrid[0:288, 0:320]
    depth = (1500 + 0.5 * u + 0.3 * v + rng.randint(0, 3, (288, 320))).astype(np.uint16)
    depth[:40] = 0
    color = np.clip(rng.randint(0, 30, (288, 320, 3)).cumsum(1) % 255, 0, 255).astype(np.uint8)
    klog = str(tmp_path / "a.kinlog")
    with native.NativeFrameLogWriter(klog) as w:
        for _ in range(10):
            w.write(depth, color)
    npz_total = 0
    for i in range(10):
        p = str(tmp_path / f"frame_{i:06d}.npz")
        np.savez(p, color=color, depth=depth)
        npz_total += os.path.getsize(p)
    assert os.path.getsize(klog) < npz_total


def test_ring_latest_wins_threaded():
    ring = native.NativeFrameRing(capacity=4, slot_bytes=400)
    stop = threading.Event()

    def producer():
        i = 0
        while not stop.is_set():
            ring.push(np.full((100,), i, np.float32))
            i += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.05)
    out = np.zeros((100,), np.float32)
    got = []
    for _ in range(50):
        if ring.pop_latest(out):
            got.append(int(out[0]))
        time.sleep(0.001)
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()
    ring.destroy()
    assert len(got) > 5
    assert got == sorted(got), "the consumer must see ever newer frames"
    assert got[-1] > got[0]


def test_ring_never_tears_under_overwrite_pressure():
    """The producer laps a 2-slot ring without pause; every popped frame is
    whole (all lanes carry one frame id)."""
    ring = native.NativeFrameRing(capacity=2, slot_bytes=1024)
    stop = threading.Event()

    def producer():
        i = 0
        buf = np.empty((256,), np.float32)
        while not stop.is_set():
            buf[:] = i
            ring.push(buf)
            i += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    out = np.zeros((256,), np.float32)
    pops = 0
    deadline = time.time() + 2.0
    try:
        while time.time() < deadline:
            if ring.pop_latest(out):
                pops += 1
                assert (out == out[0]).all(), f"torn frame at pop {pops}"
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert ring.dropped > 0, "the test must overwrite"
    ring.destroy()
    assert pops > 100


def test_native_ply_points_roundtrip(tmp_path):
    rng = np.random.RandomState(2)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    nrm = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    path = str(tmp_path / "pts.ply")
    assert native.write_ply_points_native(path, pts, cols, nrm)
    v, c, _ = read_ply(path)
    np.testing.assert_allclose(v, pts, atol=1e-6)
    np.testing.assert_allclose(c, cols, atol=1.0 / 255)


def test_native_ply_mesh_roundtrip(tmp_path):
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    path = str(tmp_path / "mesh.ply")
    assert native.write_ply_mesh_native(path, pts, tris)
    v, _, f = read_ply(path)
    np.testing.assert_allclose(v, pts)
    np.testing.assert_array_equal(f, tris)


# -- the writers' bytes -----------------------------------------------------------------


@pytest.mark.parametrize("colors, normals", [(False, False), (True, False), (True, True)])
def test_native_ply_bytes_equal_the_python_writers(tmp_path, monkeypatch, colors, normals):
    """The savers take the native path when the library loads; with it
    turned off they write the same bytes in Python, for clouds and for
    meshes with and without colors."""
    rng = np.random.RandomState(3)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, pts.shape).astype(np.float32) if colors else None
    nrm = rng.normal(size=pts.shape).astype(np.float32) if normals else None
    tris = rng.randint(0, 3000, (5000, 3)).astype(np.int32)
    cloud = PointCloudHost(points=pts, colors=cols, normals=nrm)
    mesh = TriangleMeshHost(vertices=pts, triangles=tris, vertex_colors=cols)
    assert native.is_available()
    savers.write_ply_point_cloud(str(tmp_path / "nc.ply"), cloud)
    savers.write_ply_mesh(str(tmp_path / "nm.ply"), mesh)
    calls = []
    monkeypatch.setattr(native, "is_available", lambda: calls.append(1) or False)
    savers.write_ply_point_cloud(str(tmp_path / "pc.ply"), cloud)
    savers.write_ply_mesh(str(tmp_path / "pm.ply"), mesh)
    assert len(calls) == 2  # both writers asked for the native path
    for a, b in (("nc", "pc"), ("nm", "pm")):
        assert (tmp_path / f"{a}.ply").read_bytes() == (tmp_path / f"{b}.ply").read_bytes()


# -- the build --------------------------------------------------------------------------


def test_concurrent_loaders_share_one_compile(tmp_path):
    """Six processes load the library at once from an empty build
    directory: each gets it, exactly one compiles (under the lock, into a
    temporary file renamed into place), and one library is left, named by
    the hash, with the lock file and no temporary beside it."""
    build_dir = tmp_path / "native"
    code = ("import sys\n"
            "from azurekinect3dreconstruction_tpu_torch.io import native\n"
            "lib = native.load(sys.argv[1])\n"
            "h = lib.ring_create(2, 64)\n"
            "assert h\n"
            "lib.ring_destroy(h)\n"
            "print('loaded', native.library_path(sys.argv[1]).name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 6, outs
    name = native.library_path(build_dir).name
    assert all(f"loaded {name}" in o for o in outs), outs
    assert sum(o.count("native runtime built") for o in outs) == 1, outs
    assert sorted(os.listdir(build_dir)) == sorted([name, "lock"])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.load(tmp_path / "out")
    assert "bad.cpp" in str(e.value) and "error" in str(e.value)
    assert [p.name for p in (tmp_path / "out").iterdir()] == ["lock"]


def test_the_jax_package_library_is_left_alone(tmp_path, monkeypatch):
    """The port builds under ``build/native`` with g++ alone, never runs
    ``make`` and never writes or loads ``native/libkinrt.so``."""
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    cmds, loaded = [], []
    run, cdll = native.subprocess.run, native.ctypes.CDLL
    monkeypatch.setattr(native.subprocess, "run",
                        lambda cmd, **kw: cmds.append(cmd) or run(cmd, **kw))
    monkeypatch.setattr(native.ctypes, "CDLL", lambda p, *a: loaded.append(p) or cdll(p, *a))
    native.load(tmp_path)
    assert len(cmds) == 1 and os.path.basename(cmds[0][0]) == "g++", cmds
    out = cmds[0][cmds[0].index("-o") + 1]
    assert os.path.dirname(out) == str(tmp_path) and "libkinrt.so" not in out
    assert loaded == [str(native.library_path(tmp_path))]
