"""The port's cloud meshers against the JAX package: the fixed-capacity
``PointCloud`` and ``flatten_organized``, uniform mesh sampling, ball
pivoting (a copy), ``transfer_colors``, the SDF splat and its mesher, and
the Poisson -> ball pivot -> SDF chain without Open3D; and the mirrors of
tests/test_sdf_mesh.py and tests/test_ball_pivot.py on the port. JAX's
Pallas-free splat runs as compiled XLA on the CPU. Each tolerance is stated
where it is used."""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu.config import TSDFConfig as JTSDFConfig
from azurekinect3dreconstruction_tpu.core import types as jtypes
from azurekinect3dreconstruction_tpu.meshing.ball_pivot import ball_pivot as jball_pivot
from azurekinect3dreconstruction_tpu.meshing import poisson as jpoisson
from azurekinect3dreconstruction_tpu.meshing import sampling as jsampling
from azurekinect3dreconstruction_tpu.meshing import sdf_mesh as jsdf
from azurekinect3dreconstruction_tpu.ops import backproject as jbackproject
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.types import (
    PointCloud,
    PointCloudHost,
    TriangleMeshHost,
)
from azurekinect3dreconstruction_tpu_torch.meshing import ball_pivot, poisson, sampling, sdf_mesh
from azurekinect3dreconstruction_tpu_torch.ops.backproject import flatten_organized
from test_ball_pivot import _fib_sphere
from test_sdf_mesh import _sphere_cloud

torch.set_num_threads(1)

SPLAT_TOL = 1e-6  # tsdf, weight and color of the splat (the two agree to the bit here)
VERTEX_TOL = 1e-5  # the SDF mesh's welded vertices, as sorted sets


def _t(a):
    return torch.from_numpy(np.array(a))


def _jhost(cloud: PointCloudHost):
    """The port's host cloud as the JAX package's."""
    return jtypes.PointCloudHost(points=cloud.points, colors=cloud.colors, normals=cloud.normals)


def _jmesh(mesh: TriangleMeshHost):
    return jtypes.TriangleMeshHost(vertices=mesh.vertices.copy(), triangles=mesh.triangles.copy(),
                                   vertex_colors=None if mesh.vertex_colors is None
                                   else mesh.vertex_colors.copy(),
                                   vertex_normals=None if mesh.vertex_normals is None
                                   else mesh.vertex_normals.copy())


def _random_mesh(seed=0, n_v=300, n_t=500):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_v, 3)).astype(np.float32)
    return TriangleMeshHost(vertices=v, triangles=rng.integers(0, n_v, (n_t, 3)).astype(np.int32),
                            vertex_colors=rng.random((n_v, 3)).astype(np.float32),
                            vertex_normals=(v / np.linalg.norm(v, axis=1, keepdims=True)))


# -- containers -----------------------------------------------------------------------


@pytest.mark.parametrize("attrs", [False, True])
def test_point_cloud_matches_jax(attrs):
    """``from_numpy`` pads to the capacity as JAX's does; capacity, count
    and compact agree; a JAX cloud carried across by interop equals it; a
    capacity under the point count raises in both."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(25, 3)).astype(np.float32)
    cols = rng.random((25, 3)).astype(np.float32) if attrs else None
    nrm = rng.normal(size=(25, 3)).astype(np.float32) if attrs else None
    want = jtypes.PointCloud.from_numpy(pts, cols, nrm, capacity=40)
    got = PointCloud.from_numpy(pts, cols, nrm, capacity=40, device="cpu")
    carried = interop.point_cloud_from(want, "cpu")
    for cloud in (got, carried):
        assert cloud.capacity == want.capacity == 40
        assert int(cloud.count()) == int(want.count()) == 25
        for f in ("points", "mask", "colors", "normals"):
            w, g = getattr(want, f), getattr(cloud, f)
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hw, hg = want.compact(), got.compact()
    for f in ("points", "colors", "normals"):
        w, g = getattr(hw, f), getattr(hg, f)
        assert (w is None) == (g is None) and (w is None or np.array_equal(w, g))
    with pytest.raises(ValueError):
        jtypes.PointCloud.from_numpy(pts, capacity=10)
    with pytest.raises(ValueError):
        PointCloud.from_numpy(pts, capacity=10, device="cpu")


def test_flatten_organized_matches_jax():
    """(H, W, 3) maps -> flat (H*W) cloud, field for field."""
    rng = np.random.default_rng(2)
    pts, cols, nrm = (rng.normal(size=(6, 5, 3)).astype(np.float32) for _ in range(3))
    mask = rng.random((6, 5)) > 0.3
    want = jbackproject.flatten_organized(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(cols),
                                          jnp.asarray(nrm))
    got = flatten_organized(_t(pts), _t(mask), _t(cols), _t(nrm))
    assert got.capacity == want.capacity == 30
    for f in ("points", "mask", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    bare = flatten_organized(_t(pts), _t(mask))
    assert bare.colors is None and bare.normals is None


# -- sampling -------------------------------------------------------------------------


@pytest.mark.parametrize("seed,attrs", [(0, True), (7, False)])
def test_sample_points_uniformly_is_bit_equal(seed, attrs):
    """Host numpy copied: the same mesh and seed give the same samples,
    colors and normals to the bit."""
    mesh = _random_mesh()
    if not attrs:
        mesh.vertex_colors = mesh.vertex_normals = None
    want = jsampling.sample_points_uniformly(_jmesh(mesh), 5000, seed=seed)
    got = sampling.sample_points_uniformly(mesh, 5000, seed=seed)
    for f in ("points", "colors", "normals"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None) and (w is None or np.array_equal(w, g))
    empty = TriangleMeshHost(vertices=mesh.vertices, triangles=np.zeros((0, 3), np.int32))
    assert len(sampling.sample_points_uniformly(empty, 10)) == 0


def test_transfer_colors_matches_jax():
    """Each vertex takes its nearest cloud point's color within 3x the
    radius, 0.6 gray beyond: the same colors as JAX's."""
    pts, nrm = _fib_sphere(1500, 0.3)
    rng = np.random.default_rng(4)
    cloud = PointCloudHost(points=pts.astype(np.float32),
                           colors=rng.random((len(pts), 3)).astype(np.float32))
    verts = pts[::3] * rng.uniform(0.97, 1.08, (len(pts[::3]), 1))
    verts[:20] *= 1.5  # out of reach
    verts = verts.astype(np.float32)
    mesh = TriangleMeshHost(vertices=verts, triangles=np.zeros((0, 3), np.int32))
    want = jsampling.transfer_colors(_jmesh(mesh), _jhost(cloud), radius=0.01)
    got = sampling.transfer_colors(mesh, cloud, radius=0.01, device="cpu")
    assert (want.vertex_colors == np.float32(0.6)).all(axis=1).any()  # some vertices out of reach
    np.testing.assert_array_equal(got.vertex_colors, want.vertex_colors)


# -- ball pivoting (a copy) -----------------------------------------------------------


def _plane_ladder():
    """The half-dense, half-sparse plane of test_ball_pivot.py."""
    rng = np.random.default_rng(3)
    Pd = np.stack(np.meshgrid(np.arange(0.0, 0.2, 0.005), np.arange(0.0, 0.2, 0.005),
                              indexing="ij"), -1).reshape(-1, 2)
    Ps = np.stack(np.meshgrid(np.arange(0.2, 0.4, 0.015), np.arange(0.0, 0.2, 0.015),
                              indexing="ij"), -1).reshape(-1, 2)
    P = np.concatenate([Pd, Ps])
    pts = np.concatenate([P, np.zeros((len(P), 1))], 1) + rng.normal(0.0, 1e-4, (len(P), 3))
    return pts, np.tile([0.0, 0.0, 1.0], (len(P), 1)), len(Pd)


@pytest.mark.parametrize("case", ["sphere", "sphere_ladder", "plane_ladder"])
def test_ball_pivot_matches_jax(case):
    """The same triangles in the same order on tests/test_ball_pivot.py's
    inputs."""
    if case == "plane_ladder":
        pts, nrm, _ = _plane_ladder()
        radii = [0.008, 0.016, 0.032]
    else:
        pts, nrm = _fib_sphere(1500, 0.3) if case == "sphere" else _fib_sphere(800, 0.2)
        radii = [0.03] if case == "sphere" else [0.025, 0.05]
    want = jball_pivot(pts, nrm, radii=radii)
    got = ball_pivot.ball_pivot(pts, nrm, radii=radii)
    assert len(want) > 1000
    np.testing.assert_array_equal(got, want)


def test_ball_pivot_sphere_watertight_manifold():
    """Mirror: one radius closes a uniform sphere into a watertight genus-0
    2-manifold, every face wound outward."""
    pts, nrm = _fib_sphere(1500, 0.3)
    tris = ball_pivot.ball_pivot(pts, nrm, radii=[0.03])
    n = len(pts)
    assert len(np.unique(tris)) == n
    assert len(tris) == 2 * n - 4
    cnt = Counter()
    for a, b, c in tris:
        for u, v in ((a, b), (b, c), (c, a)):
            cnt[(min(u, v), max(u, v))] += 1
    assert set(cnt.values()) == {2} and len(cnt) == 3 * n - 6
    fn = np.cross(pts[tris[:, 1]] - pts[tris[:, 0]], pts[tris[:, 2]] - pts[tris[:, 0]])
    assert (np.einsum("ij,ij->i", fn, pts[tris].mean(1)) > 0).all()


def test_ball_pivot_interpolates_no_new_vertices():
    """Mirror: the vertices are the cloud itself, so a noiseless sphere has
    zero radial error."""
    pts, nrm = _fib_sphere(800, 0.2)
    mesh = ball_pivot.ball_pivot_mesh(PointCloudHost(points=pts.astype(np.float32),
                                                     normals=nrm.astype(np.float32)),
                                      radii=[0.025, 0.05])
    assert mesh is not None
    np.testing.assert_array_equal(mesh.vertices, pts.astype(np.float32))
    rad = np.linalg.norm(mesh.vertices[np.unique(mesh.triangles)], axis=1)
    assert float(np.sqrt(((rad - 0.2) ** 2).mean())) < 1e-6


def test_ball_pivot_radius_ladder_bridges_sparse_regions():
    """Mirror: the small ball cannot cross the sparse half; the ladder does."""
    pts, nrm, n_dense = _plane_ladder()
    small = ball_pivot.ball_pivot(pts, nrm, radii=[0.008])
    ladder = ball_pivot.ball_pivot(pts, nrm, radii=[0.008, 0.016, 0.032])
    sparse = np.arange(n_dense, len(pts))
    assert np.isin(sparse, np.unique(small)).mean() < 0.5
    assert np.isin(sparse, np.unique(ladder)).mean() > 0.95
    assert np.isin(np.arange(n_dense), np.unique(small)).mean() > 0.95


def test_ball_pivot_mesh_guards():
    """Mirror: under 3 points, or without normals, no mesh."""
    assert ball_pivot.ball_pivot_mesh(PointCloudHost(points=np.zeros((2, 3), np.float32))) is None
    pts, _ = _fib_sphere(200, 0.1)
    assert ball_pivot.ball_pivot_mesh(PointCloudHost(points=pts.astype(np.float32))) is None


def test_ball_pivot_fallback_chain_without_open3d(monkeypatch):
    """Mirror: without Open3D the chain's ball-pivot rung is the
    first-party one."""
    monkeypatch.setattr(poisson, "_o3d", lambda: None)
    pts, nrm = _fib_sphere(600, 0.15)
    mesh = poisson.ball_pivot_mesh_from_cloud(
        PointCloudHost(points=pts.astype(np.float32), normals=nrm.astype(np.float32)),
        radii=(0.02, 0.04), device="cpu")
    assert mesh is not None and mesh.triangles.shape[0] > 1000


# -- the SDF splat and its mesher ------------------------------------------------------


def test_exp32_is_xlas_exp():
    """``fmath.exp32`` equals the compiled ``jnp.exp`` to the bit, over the
    splat's weights' range and beyond: the overflow clamp, the flush of
    subnormal results to zero, and the ~10 % of inputs where XLA's
    polynomial is an ulp off a correctly rounded exp."""
    import jax

    from azurekinect3dreconstruction_tpu_torch.core.fmath import exp32

    rng = np.random.default_rng(5)
    x = np.concatenate([-rng.random(200_000) * 100.0, rng.random(50_000) * 95.0 - 5.0,
                        [-1e30, -87.9, -87.8, 0.0, 88.7, 88.8, 1e30]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = exp32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (torch.exp(torch.from_numpy(x)).numpy() != want).mean() > 0.01


def _keyed(coords, n, pool):
    rows = pool.reshape(pool.shape[0], -1)
    return {tuple(k): rows[s] for s, k in enumerate(coords[:n].tolist())}


def test_splat_cloud_matches_jax():
    """From one oriented, colored cloud: the same block keys and counts,
    tsdf / weight / color within 1e-6 by block key (the port's hash numbers
    slots in another order)."""
    cloud, _, _ = _sphere_cloud(n=6000)
    kw = dict(voxel_size=0.01, sdf_trunc=0.015, block_resolution=8, block_capacity=1024,
              hash_capacity=4096)
    mask = np.ones(len(cloud.points), bool)
    want = jsdf.splat_cloud(jnp.asarray(cloud.points), jnp.asarray(cloud.normals),
                            jnp.asarray(cloud.colors), jnp.asarray(mask), JTSDFConfig(**kw),
                            jnp.float32(0.01), jnp.float32(0.015))
    got = sdf_mesh.splat_cloud(_t(cloud.points), _t(cloud.normals), _t(cloud.colors), _t(mask),
                               TSDFConfig(**kw), torch.tensor(0.01), torch.tensor(0.015))
    n = int(want.n_blocks)
    assert int(got.n_blocks) == n > 50 and not bool(got.overflow) and not bool(want.overflow)
    for f in ("tsdf", "weight", "color"):
        kw_, kg = (_keyed(np.asarray(want.block_coords), n, np.asarray(getattr(want, f))),
                   _keyed(got.block_coords.numpy(), n, getattr(got, f).numpy()))
        assert kw_.keys() == kg.keys()
        for k in kw_:
            np.testing.assert_allclose(kg[k], kw_[k], rtol=0, atol=SPLAT_TOL)


def test_splat_cloud_sets_overflow_on_a_full_pool():
    """A pool too small for the cloud fills to its last allocatable row
    (the trash row stays free) and sets the sticky flag, as JAX's does."""
    cloud, _, _ = _sphere_cloud(n=3000)
    kw = dict(voxel_size=0.01, sdf_trunc=0.015, block_resolution=8, block_capacity=32,
              hash_capacity=128)
    mask = np.ones(len(cloud.points), bool)
    want = jsdf.splat_cloud(jnp.asarray(cloud.points), jnp.asarray(cloud.normals),
                            jnp.asarray(cloud.colors), jnp.asarray(mask), JTSDFConfig(**kw),
                            jnp.float32(0.01), jnp.float32(0.015))
    got = sdf_mesh.splat_cloud(_t(cloud.points), _t(cloud.normals), _t(cloud.colors), _t(mask),
                               TSDFConfig(**kw), torch.tensor(0.01), torch.tensor(0.015))
    assert bool(got.overflow) and bool(want.overflow)
    assert int(got.n_blocks) == int(want.n_blocks) == 31


def _vertex_set(mesh):
    v = np.asarray(mesh.vertices)
    return v[np.lexsort(v.T[::-1])]


@pytest.mark.parametrize("normals", [True, False])
def test_sdf_mesh_from_cloud_matches_jax(normals):
    """Normals given, or estimated toward the viewpoint: the same vertex and
    triangle counts, the welded vertices as sorted sets within 1e-5, colors
    present exactly where JAX's are."""
    cloud, _, _ = _sphere_cloud(n=8000, with_normals=normals, with_colors=normals)
    kw = dict(voxel=0.01, viewpoint=(0.0, 0.0, -2.0))
    want = jsdf.sdf_mesh_from_cloud(_jhost(cloud), **kw)
    got = sdf_mesh.sdf_mesh_from_cloud(cloud, device="cpu", **kw)
    assert want.triangles.shape[0] > 1000
    assert got.triangles.shape == want.triangles.shape
    assert got.vertices.shape == want.vertices.shape
    np.testing.assert_allclose(_vertex_set(got), _vertex_set(want), rtol=0, atol=VERTEX_TOL)
    assert (got.vertex_colors is None) == (want.vertex_colors is None)
    assert got.vertex_normals is not None


def test_sdf_mesh_reconstructs_sphere():
    """Mirror: radius RMSE under 2 mm at 8 mm voxels, colors from the
    splats, normals outward."""
    cloud, center, r = _sphere_cloud()
    mesh = sdf_mesh.sdf_mesh_from_cloud(cloud, voxel=0.008, device="cpu")
    assert mesh is not None and mesh.triangles.shape[0] > 2000
    rad = np.linalg.norm(mesh.vertices - center, axis=1)
    assert np.sqrt(((rad - r) ** 2).mean()) < 0.002
    dirs = (mesh.vertices - center) / rad[:, None]
    assert np.abs(mesh.vertex_colors - (dirs * 0.5 + 0.5)).mean() < 0.08
    assert ((mesh.vertex_normals * dirs).sum(1) > 0).mean() > 0.95


def test_sdf_mesh_estimates_normals_when_missing():
    """Mirror: normals estimated toward a viewpoint outside the sphere."""
    cloud, center, r = _sphere_cloud(with_normals=False, with_colors=False)
    mesh = sdf_mesh.sdf_mesh_from_cloud(cloud, voxel=0.01, viewpoint=(0.0, 0.0, -2.0),
                                        device="cpu")
    assert mesh is not None and mesh.triangles.shape[0] > 1000
    rad = np.linalg.norm(mesh.vertices - center, axis=1)
    assert np.sqrt(((rad - r) ** 2).mean()) < 0.004
    assert mesh.vertex_colors is None


def test_sdf_mesh_too_few_points():
    """Mirror."""
    assert sdf_mesh.sdf_mesh_from_cloud(PointCloudHost(points=np.zeros((3, 3), np.float32)),
                                        device="cpu") is None


# -- the Poisson chain without Open3D -------------------------------------------------


@pytest.mark.parametrize("size", ["ball_pivot", "sdf"])
def test_mesh_with_fallback_without_open3d_matches_jax(monkeypatch, size):
    """With Open3D patched away in both packages Poisson gives None; a cloud
    of up to 60k points goes to ball pivoting (the same triangles as JAX's),
    a larger one to the SDF mesher (the same counts, vertices as sorted sets
    within 1e-5)."""
    monkeypatch.setattr(poisson, "_o3d", lambda: None)
    monkeypatch.setattr(jpoisson, "_o3d", lambda: None)
    if size == "ball_pivot":
        pts, nrm = _fib_sphere(600, 0.15)
        cloud = PointCloudHost(points=pts.astype(np.float32), normals=nrm.astype(np.float32))
    else:
        cloud, _, _ = _sphere_cloud(n=poisson.BALL_PIVOT_MAX_POINTS + 1000)
    assert poisson.poisson_mesh_from_cloud(cloud) is None
    want = jpoisson.mesh_with_fallback(_jhost(cloud), voxel=0.01)
    got = poisson.mesh_with_fallback(cloud, voxel=0.01, device="cpu")
    assert want.triangles.shape[0] > 1000 and got.triangles.shape == want.triangles.shape
    if size == "ball_pivot":
        np.testing.assert_array_equal(got.triangles, want.triangles)
        np.testing.assert_array_equal(got.vertices, want.vertices)
    else:
        np.testing.assert_allclose(_vertex_set(got), _vertex_set(want), rtol=0, atol=VERTEX_TOL)


def test_ball_pivot_chain_estimates_normals_as_jax(monkeypatch):
    """A cloud without normals: PCA normals oriented below the centroid,
    then the same triangles as JAX's rung."""
    monkeypatch.setattr(poisson, "_o3d", lambda: None)
    monkeypatch.setattr(jpoisson, "_o3d", lambda: None)
    pts, _ = _fib_sphere(600, 0.15)
    cloud = PointCloudHost(points=pts.astype(np.float32))
    want = jpoisson.ball_pivot_mesh_from_cloud(_jhost(cloud), radii=(0.02, 0.04))
    got = poisson.ball_pivot_mesh_from_cloud(cloud, radii=(0.02, 0.04), device="cpu")
    assert want is not None and want.triangles.shape[0] > 500
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_allclose(got.vertex_normals, want.vertex_normals, rtol=0, atol=1e-5)


@pytest.mark.parametrize("entry", ["sdf_mesh_from_cloud", "transfer_colors",
                                   "mesh_with_fallback", "ball_pivot_mesh_from_cloud",
                                   "point_cloud"])
def test_meshing_entry_points_default_to_the_card(entry):
    """Without a card, each entry point's default device raises; nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cloud, _, _ = _sphere_cloud(n=200)
    calls = {
        "sdf_mesh_from_cloud": lambda: sdf_mesh.sdf_mesh_from_cloud(cloud),
        "transfer_colors": lambda: sampling.transfer_colors(_random_mesh(), cloud),
        "mesh_with_fallback": lambda: poisson.mesh_with_fallback(cloud),
        "ball_pivot_mesh_from_cloud": lambda: poisson.ball_pivot_mesh_from_cloud(cloud),
        "point_cloud": lambda: PointCloud.from_numpy(cloud.points),
    }
    with pytest.raises(RuntimeError):
        calls[entry]()
