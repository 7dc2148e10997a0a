"""The port's PLY/OBJ writers and readers against the JAX package's.

The JAX writers try the C++ runtime first; with ``native.is_available``
patched to ``False`` they take their pure-Python path, which is what the
port copies, and the files must then be equal byte for byte."""

import numpy as np
import pytest

from azurekinect3dreconstruction_tpu.core import types as jtypes
from azurekinect3dreconstruction_tpu.io import native
from azurekinect3dreconstruction_tpu.viz import savers as jsavers
from azurekinect3dreconstruction_tpu_torch.core import types
from azurekinect3dreconstruction_tpu_torch.viz import savers


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(native, "is_available", lambda: False)


def _cloud(rng, n, colors, normals):
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32) if colors else None
    nrm = rng.normal(size=(n, 3)).astype(np.float32) if normals else None
    return (types.PointCloudHost(pts, col, nrm), jtypes.PointCloudHost(pts, col, nrm))


def _mesh(rng, colors):
    v = rng.normal(size=(40, 3)).astype(np.float32)
    t = rng.randint(0, 40, (60, 3)).astype(np.int32)
    c = rng.uniform(0, 1, (40, 3)).astype(np.float32) if colors else None
    return types.TriangleMeshHost(v, t, c), jtypes.TriangleMeshHost(v, t, c)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("colors,normals", [(False, False), (True, False), (True, True)])
def test_ply_point_cloud_bytes_equal_jax(tmp_path, binary, colors, normals):
    cp, cj = _cloud(np.random.RandomState(0), 50, colors, normals)
    savers.write_ply_point_cloud(str(tmp_path / "p.ply"), cp, binary=binary)
    jsavers.write_ply_point_cloud(str(tmp_path / "j.ply"), cj, binary=binary)
    assert _same_bytes(tmp_path / "p.ply", tmp_path / "j.ply")
    v, c, f = savers.read_ply(str(tmp_path / "p.ply"))
    np.testing.assert_allclose(v, cp.points, rtol=1e-6)  # ASCII prints the shortest repr
    assert f is None and (c is None) == (not colors)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("colors", [True, False])
def test_ply_mesh_bytes_equal_jax_and_read_back(tmp_path, binary, colors):
    mp, mj = _mesh(np.random.RandomState(1), colors)
    savers.write_ply_mesh(str(tmp_path / "p.ply"), mp, binary=binary)
    jsavers.write_ply_mesh(str(tmp_path / "j.ply"), mj, binary=binary)
    assert _same_bytes(tmp_path / "p.ply", tmp_path / "j.ply")
    v, c, f = savers.read_ply(str(tmp_path / "p.ply"))
    np.testing.assert_allclose(v, mp.vertices, rtol=1e-6)
    np.testing.assert_array_equal(f, mp.triangles)
    if colors:
        # u8 quantization on write: within 1/255
        np.testing.assert_allclose(c, mp.vertex_colors, atol=1.0 / 255 + 1e-6)


@pytest.mark.parametrize("colors", [True, False])
def test_obj_mesh_bytes_equal_jax_and_read_back(tmp_path, colors):
    mp, mj = _mesh(np.random.RandomState(2), colors)
    savers.write_obj_mesh(str(tmp_path / "p.obj"), mp)
    jsavers.write_obj_mesh(str(tmp_path / "j.obj"), mj)
    assert _same_bytes(tmp_path / "p.obj", tmp_path / "j.obj")
    v, c, f = savers.read_geometry(str(tmp_path / "p.obj"))
    np.testing.assert_array_equal(v, mp.vertices)
    np.testing.assert_array_equal(f, mp.triangles)
    for got, want in zip((v, c, f), jsavers.read_obj(str(tmp_path / "p.obj"))):
        assert (got is None and want is None) or np.array_equal(got, want)
    if colors:
        np.testing.assert_array_equal(c, mp.vertex_colors)
    else:
        assert c is None


def test_readers_match_jax_on_foreign_files(tmp_path):
    """Negative OBJ indices, polygon fans, v/vt/vn faces; ASCII PLY with a
    face list; an unknown extension raises."""
    obj = tmp_path / "f.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1/1 2/2/2 3/3/3 4/4/4\nf -4 -3 -2\n")
    for got, want in zip(savers.read_obj(str(obj)), jsavers.read_obj(str(obj))):
        np.testing.assert_array_equal(got, want)
    ply = tmp_path / "f.ply"
    ply.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\nproperty float y\n"
                   "property float z\nelement face 1\nproperty list uchar int vertex_indices\n"
                   "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    got, want = savers.read_geometry(str(ply)), jsavers.read_geometry(str(ply))
    for g, w in zip(got, want):
        assert (g is None and w is None) or np.array_equal(g, w)
    with pytest.raises(ValueError):
        savers.read_geometry(str(tmp_path / "f.stl"))


def test_result_saver_dual_saves(tmp_path):
    """Timestamped + latest_* files, the same bytes as JAX's saver, and the
    trajectory round trip."""
    rng = np.random.RandomState(3)
    mp, mj = _mesh(rng, True)
    cp, cj = _cloud(rng, 30, True, False)
    sp, sj = savers.ResultSaver(str(tmp_path / "p")), jsavers.ResultSaver(str(tmp_path / "j"))
    for save in ("save_mesh", "save_point_cloud"):
        arg_p, arg_j = (mp, mj) if save == "save_mesh" else (cp, cj)
        a, b = getattr(sp, save)(arg_p), getattr(sj, save)(arg_j)
        assert _same_bytes(a, b)
    assert sp.save_mesh(mp, obj=True).endswith(".obj")
    poses = [np.eye(4), np.diag([1.0, -1.0, -1.0, 1.0])]
    path = sp.save_trajectory(poses)
    assert _same_bytes(path, sj.save_trajectory(poses))
    back = savers.ResultSaver.load_trajectory(str(tmp_path / "p" / "latest_trajectory.txt"))
    np.testing.assert_array_equal(np.stack(back), np.stack(poses))
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert {"latest_mesh.ply", "latest_mesh.obj", "latest_pointcloud.ply",
            "latest_trajectory.txt"} <= set(names)
