"""The port's viewer modules against the JAX package's on seeded numpy
inputs: the preview renderer (arrays and PNG bytes equal), the HTML export
(file bytes equal), the live server's wire pack (bytes equal in all three
modes) and its HTTP endpoints, revisions, 404s, ``/snapshot.ply`` and key
dispatch (the mirrors of tests/test_live_server.py), the Open3D bridge
without Open3D and the saved-result browsers. Every server binds to
127.0.0.1 on a free port and is closed in ``finally``."""

import json
import os
import struct
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from azurekinect3dreconstruction_tpu.core import types as jtypes
from azurekinect3dreconstruction_tpu.viz import html_export as jhtml
from azurekinect3dreconstruction_tpu.viz import live_server as jserver
from azurekinect3dreconstruction_tpu.viz import render as jrender
from azurekinect3dreconstruction_tpu_torch.core import types as ptypes
from azurekinect3dreconstruction_tpu_torch.viz import browsers, html_export, live_server, render
from azurekinect3dreconstruction_tpu_torch.viz import o3d_bridge
from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:  # 4xx raise in urllib
        return e.code, e.read()


def _sphere(n_lat=24, n_lon=48, seed=0):
    """A UV sphere of radius 0.15 at z = 0.5 with seeded vertex colors:
    (vertices, triangles, colors) numpy."""
    th = np.linspace(0.05, np.pi - 0.05, n_lat)
    ph = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], -1).reshape(-1, 3)
    v = (0.15 * v + [0.0, 0.0, 0.5]).astype(np.float32)
    i, j = np.meshgrid(np.arange(n_lat - 1), np.arange(n_lon), indexing="ij")
    a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
    c, d = a + n_lon, b + n_lon
    tris = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)]).reshape(-1, 3)
    cols = np.random.RandomState(seed).uniform(0, 1, v.shape).astype(np.float32)
    return v, tris.astype(np.int32), cols


def _meshes(v, t, c=None, n=None):
    """The same mesh in both packages' host types."""
    return (jtypes.TriangleMeshHost(vertices=v.copy(), triangles=t.copy(),
                                    vertex_colors=None if c is None else c.copy(),
                                    vertex_normals=None if n is None else n.copy()),
            ptypes.TriangleMeshHost(vertices=v.copy(), triangles=t.copy(),
                                    vertex_colors=None if c is None else c.copy(),
                                    vertex_normals=None if n is None else n.copy()))


def _clouds(p, c=None, n=None):
    return (jtypes.PointCloudHost(points=p, colors=c, normals=n),
            ptypes.PointCloudHost(points=p, colors=c, normals=n))


def _soup(n_tris=600, seed=3):
    rng = np.random.RandomState(seed)
    v = rng.uniform(-0.5, 0.5, (3 * n_tris, 3)).astype(np.float32)
    c = rng.uniform(0, 1, v.shape).astype(np.float32)
    return _meshes(v, np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3), c)


# -- the renderer ----------------------------------------------------------------


@pytest.mark.parametrize("colors, posed", [(True, False), (False, True)])
def test_render_mesh_and_png_match_jax(tmp_path, colors, posed):
    """``render_mesh`` (auto-framed, or from a given orbit pose) equal to
    JAX's array to the bit, the PNG bytes too, and a shaded object on the
    background."""
    v, t, c = _sphere()
    jm, pm = _meshes(v, t, c if colors else None)
    kw = dict(size=(160, 120))
    if posed:
        kw["T_world_cam"] = jrender._orbit_pose(np.array([0.0, 0.0, 0.5]), 0.6, 1.1)
    want, got = jrender.render_mesh(jm, **kw), render.render_mesh(pm, **kw)
    assert got.dtype == np.uint8 and got.shape == (120, 160, 3)
    np.testing.assert_array_equal(got, want)
    is_obj = np.abs(got.astype(int) - [18, 18, 24]).sum(-1) > 10
    assert 0.05 < is_obj.mean() < 0.95
    pj = jrender.write_png(str(tmp_path / "j.png"), want)
    pp = render.write_png(str(tmp_path / "p.png"), got)
    assert open(pp, "rb").read() == open(pj, "rb").read()


def test_render_points_matches_jax():
    """The z-buffered splat of a seeded cloud, with and without colors and
    with a wider splat, equal to JAX's to the bit."""
    rng = np.random.RandomState(1)
    pts = rng.uniform([-0.3, -0.3, 0.4], [0.3, 0.3, 1.2], (5000, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, pts.shape).astype(np.float32)
    T = np.eye(4)
    for c, px in ((cols, 2), (None, 3)):
        want = jrender.render_points(pts, c, T, size=(128, 96), point_px=px)
        got = render.render_points(pts, c, T, size=(128, 96), point_px=px)
        np.testing.assert_array_equal(got, want)


def test_save_turntable_matches_jax(tmp_path):
    v, t, c = _sphere(12, 24)
    jm, pm = _meshes(v, t, c)
    want = jrender.save_turntable(jm, str(tmp_path / "j"), n_views=3, size=(96, 72))
    got = render.save_turntable(pm, str(tmp_path / "p"), n_views=3, size=(96, 72))
    assert [os.path.basename(p) for p in got] == ["p_00.png", "p_01.png", "p_02.png"]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_save_preview_writes_the_render(tmp_path):
    """``ResultSaver.save_preview``: the timestamped and ``latest_`` PNGs,
    each the bytes of ``save_mesh_preview``."""
    v, t, c = _sphere(12, 24)
    _, pm = _meshes(v, t, c)
    p = ResultSaver(str(tmp_path)).save_preview(pm)
    ref = render.save_mesh_preview(pm, str(tmp_path / "ref.png"))
    data = open(ref, "rb").read()
    assert open(p, "rb").read() == data == open(tmp_path / "latest_preview.png", "rb").read()


# -- the HTML export ---------------------------------------------------------------


def _geometries(kind):
    rng = np.random.RandomState(2)
    if kind == "mesh":
        v, t, c = _sphere()
        return _meshes(v, t, c), {}
    if kind == "decimated mesh":
        v, t, c = _sphere()
        return _meshes(v, t, c), {"max_vertices": 300}
    if kind == "cloud":
        p = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
        c = rng.uniform(0, 1, p.shape).astype(np.float32)
        n = rng.normal(size=p.shape).astype(np.float32)
        return _clouds(p, c, n), {"max_vertices": 700}
    return _soup(), {"max_vertices": 900}


@pytest.mark.parametrize("kind", ["mesh", "cloud", "decimated mesh", "soup"])
def test_save_html_viewer_matches_jax(tmp_path, kind):
    (jg, pg), kw = _geometries(kind)
    want = jhtml.save_html_viewer(str(tmp_path / "j" / "v.html"), jg, title=kind, **kw)
    got = html_export.save_html_viewer(str(tmp_path / "p" / "v.html"), pg, title=kind, **kw)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert b"makeViewer" in data and len(data) > 1000


def test_geometry_helpers_match_jax():
    """``decimate_geometry``, ``geometry_arrays`` and ``soup_arrays`` give
    JAX's arrays, and ``soup_arrays`` is None for an indexed mesh."""
    (jm, pm), _ = _geometries("mesh")
    for mv in (10 ** 6, 500):
        for a, b in zip(html_export.geometry_arrays(pm, mv), jhtml.geometry_arrays(jm, mv)):
            np.testing.assert_array_equal(a, b)
    assert html_export.soup_arrays(pm, 100) is None
    js, ps = _soup()
    for a, b in zip(html_export.soup_arrays(ps, 300), jhtml.soup_arrays(js, 300)):
        np.testing.assert_array_equal(a, b)


# -- the live server ----------------------------------------------------------------


@pytest.mark.parametrize("kind, max_vertices", [("mesh", 2_000_000), ("cloud", 2_000_000),
                                                ("soup", 2_000_000), ("mesh", 400),
                                                ("soup", 500)])
def test_pack_geometry_matches_jax(kind, max_vertices):
    """The ``K3DL`` v1 wire bytes of an indexed mesh (mode 1), a cloud
    (mode 0) and a soup (mode 2), whole and decimated, equal JAX's."""
    (jg, pg), _ = _geometries(kind)
    want = jserver.pack_geometry(jg, 7, max_vertices)
    got = live_server.pack_geometry(pg, 7, max_vertices)
    assert got == want
    magic, version, rev, mode = struct.unpack_from("<4I", got)
    assert (magic, version, rev) == (live_server.MAGIC, 1, 7)
    assert mode == {"cloud": 0, "mesh": 1, "soup": 2}[kind]


def test_server_endpoints_and_revisions():
    """The page, ``/meta.json`` (objects, status, revisions that bump on
    each update), ``/geometry.bin`` (the pack of the current revision),
    404s for an unknown object or path, and ``/snapshot.ply``."""
    (_, mesh), _ = _geometries("mesh")
    srv = live_server.LiveViewerServer(host="127.0.0.1", port=0, title="t")
    try:
        status, page = _get(srv.url)
        assert status == 200 and b"makeViewer" in page
        meta = json.loads(_get(srv.url + "meta.json")[1])
        assert meta["objects"] == {} and meta["title"] == "t"
        srv.update("surface", mesh)
        srv.set_status("frame 3 | 31.0 fps")
        meta = json.loads(_get(srv.url + "meta.json")[1])
        assert meta["status"] == "frame 3 | 31.0 fps"
        obj = meta["objects"]["surface"]
        assert obj["n_vertices"] == mesh.vertices.shape[0]
        status, blob = _get(srv.url + "geometry.bin?name=surface")
        assert status == 200 and blob == live_server.pack_geometry(mesh, obj["rev"])
        srv.update("surface", mesh)
        assert json.loads(_get(srv.url + "meta.json")[1])["objects"]["surface"]["rev"] > obj["rev"]
        assert _get(srv.url + "geometry.bin?name=nope")[0] == 404
        assert _get(srv.url + "nothing-here")[0] == 404
        status, ply = _get(srv.url + "snapshot.ply?name=surface")
        assert status == 200 and ply.startswith(b"ply")
        assert f"element face {mesh.triangles.shape[0]}".encode() in ply
        assert _get(srv.url + "snapshot.ply?name=nope")[0] == 404
        srv.remove("surface")
        assert json.loads(_get(srv.url + "meta.json")[1])["objects"] == {}
    finally:
        srv.close()


def test_browser_viewer_dispatches_keys_on_tick():
    """Keys the page forwards to ``/key`` wait in the queue until ``tick``
    runs their handlers on the caller's thread, in order; an unregistered
    key is ignored; a closed viewer ends the loop."""
    (_, mesh), _ = _geometries("mesh")
    v = live_server.BrowserLiveViewer(port=0, window_name="adapter")
    try:
        hits = []
        v.register_key("C", lambda: hits.append("reset"), "reset volume")
        v.register_key("S", lambda: hits.append("save"), "save")
        v.update_mesh("surface", mesh)
        v.update_cloud("traj", ptypes.PointCloudHost(points=np.zeros((3, 3), np.float32)))
        meta = json.loads(_get(v.server.url + "meta.json")[1])
        assert set(meta["objects"]) == {"surface", "traj"}
        assert meta["keys"] == {"c": "reset volume", "s": "save"}
        for k in ("c", "s", "x"):
            assert _get(v.server.url + f"key?c={k}")[0] == 200
        assert hits == []
        assert v.tick() is True
        assert hits == ["reset", "save"]
        v.remove("traj")
        assert set(json.loads(_get(v.server.url + "meta.json")[1])["objects"]) == {"surface"}
        assert not v.headless
    finally:
        v.close()
    assert v.tick() is False


# -- Open3D and the browsers -----------------------------------------------------------


def test_o3d_bridge_without_open3d(tmp_path):
    """Without Open3D the bridge is headless: no window, updates are no-ops,
    keys still dispatch when pressed, ``view_geometry`` returns False."""
    try:
        import open3d  # noqa: F401
        pytest.skip("Open3D is installed")
    except ImportError:
        pass
    assert o3d_bridge.is_available() is False
    v = o3d_bridge.LiveViewer()
    hits = []
    v.register_key("s", lambda: hits.append(1))
    v.press("S")
    (_, mesh), _ = _geometries("mesh")
    v.update_mesh("m", mesh)
    assert v.headless and hits == [1] and v.tick() is True
    v.close()
    assert o3d_bridge.view_geometry(str(tmp_path / "x.ply")) is False


def test_browsers_list_and_load_a_saved_run(tmp_path):
    """A saved mesh and cloud: ``list_results`` newest first,
    ``load_latest_reconstruction`` the newest .ply with its kind,
    ``load_latest_mesh`` the mesh; nothing in an empty directory."""
    (_, mesh), _ = _geometries("mesh")
    (_, cloud), _ = _geometries("cloud")
    saver = ResultSaver(str(tmp_path))
    saver.save_mesh(mesh, kind="mesh")
    time.sleep(0.01)
    saver.save_point_cloud(cloud, kind="volume_pcd")
    os.utime(tmp_path / "latest_volume_pcd.ply", (time.time() + 5,) * 2)
    files = browsers.list_results(str(tmp_path))
    assert len(files) == 4 and files[0].endswith("latest_volume_pcd.ply")
    assert browsers.load_latest_reconstruction(str(tmp_path)) == (files[0], "pointcloud")
    assert "mesh" in os.path.basename(browsers.load_latest_mesh(str(tmp_path)))
    assert browsers.ReconstructionBrowser(str(tmp_path)).list() == files
    assert browsers.load_latest_reconstruction(str(tmp_path / "empty")) is None
    assert browsers.load_latest_mesh(str(tmp_path / "empty")) is None
