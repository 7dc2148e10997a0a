"""The port's marching cubes, surface samplers and volume queries against the
JAX package.

The hash gives the two packages other slot orders, and the mesh path's
thinning follows pool order, so each comparison starts both from the same
pool: built in JAX and carried across with ``interop``. From one pool the
port must give the same triangles in the same order. The port's sampled
model ranks its blocks by key, JAX's by slot, so its comparisons start from
a pool whose slots are in key order (``_key_ordered``), where the two
orders agree; under any other slot order the port's model stays the same,
to the bit. Unless a test says otherwise, the tolerance is 0: the port
rounds as the compiled JAX stage does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu.config import TSDFConfig as JTSDFConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.tsdf import hash as jhash
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as jmc
from azurekinect3dreconstruction_tpu.tsdf import mc_tables as jmt
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import mc_tables as mt
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.tsdf.hash import pack_key, pack_key_np
from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import _compact
from test_marching_cubes import build_volume_from_field
from test_mc_tables import numpy_marching_cubes

torch.set_num_threads(1)

# the CFG of tests/test_marching_cubes.py
KW = dict(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=512,
          hash_capacity=2048)
JCFG, CFG = JTSDFConfig(**KW), TSDFConfig(**KW)


def _carry(vj):
    """A JAX volume -> the port's volume on the CPU (same slots)."""
    return interop.volume_from_jax_arrays({k: np.asarray(v) for k, v in vj._asdict().items()},
                                          "cpu")


def _key_ordered(vj):
    """A JAX volume with its alive rows moved into block-key order and its
    table rebuilt (``hash.build_table``): the pool on which JAX's slot
    stride and the port's key stride pick the same blocks."""
    n, cap = int(vj.n_blocks), vj.block_coords.shape[0]
    bc = np.asarray(vj.block_coords)
    perm = np.concatenate([np.argsort(pack_key_np(bc[:n]), kind="stable"), np.arange(n, cap)])
    rows = {f: jnp.asarray(np.asarray(getattr(vj, f))[perm])
            for f in ("block_coords", "tsdf", "weight", "color")}
    keys = np.where(np.arange(cap) < n, pack_key_np(bc[perm]), jhash.EMPTY_KEY).astype(np.int32)
    table, ok = jhash.build_table(jnp.asarray(keys), jnp.arange(cap, dtype=jnp.int32),
                                  vj.table_keys.shape[0])
    assert bool(ok)
    return vj._replace(table_keys=table.keys, table_vals=table.vals, **rows)


def _sphere_field(n_blocks, radius, cfg=JCFG):
    n = n_blocks * cfg.block_resolution
    g = (np.arange(n) + 0.5) * cfg.voxel_size
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    c = n * cfg.voxel_size / 2
    f = (np.sqrt((X - c) ** 2 + (Y - c) ** 2 + (Z - c) ** 2) - radius) / cfg.sdf_trunc
    return np.clip(f, -1, 1).astype(np.float32)


def _colored(vj, seed=0):
    """Give every voxel a random color (build_volume_from_field paints 0.5)."""
    rng = np.random.RandomState(seed)
    return vj._replace(color=jnp.asarray(rng.uniform(0, 1, vj.color.shape).astype(np.float32)))


@pytest.fixture(scope="module")
def sphere():
    """4^3 blocks of 8^3 voxels holding a sphere of radius 0.22 m, colored."""
    field = _sphere_field(4, 0.22)
    vj = _colored(build_volume_from_field(field, JCFG))
    return field, vj, _carry(vj)


@pytest.fixture(scope="module")
def slab():
    """A 2.56 m slab (the long-surface scene of test_marching_cubes.py)."""
    R = JCFG.block_resolution
    nx, nyz = 16 * R, 2 * R
    g = lambda n: (np.arange(n) + 0.5) * JCFG.voxel_size
    X, Y, Z = np.meshgrid(g(nx), g(nyz), g(nyz), indexing="ij")
    mid = nyz * JCFG.voxel_size / 2
    field = np.clip((Y - mid + 0.05 * np.sin(X * 7.0)) / JCFG.sdf_trunc, -1, 1).astype(np.float32)
    vj = build_volume_from_field(field, JCFG)
    return vj, _carry(vj)


@pytest.fixture(scope="module")
def sphere_by_key(sphere):
    """The sphere's pool with its slots in key order, in both packages."""
    vj = _key_ordered(sphere[1])
    return vj, _carry(vj)


@pytest.fixture(scope="module")
def slab_by_key(slab):
    """The slab's pool with its slots in key order, in both packages."""
    vj = _key_ordered(slab[0])
    return vj, _carry(vj)


def _arrays(out):
    v, c, n, ovf = out
    return np.asarray(v), None if c is None else np.asarray(c), int(n), bool(ovf)


def _same_soup(mp, mj):
    """The port's soup (live triangles only) equals the live prefix of
    JAX's padded soup, to the bit; both compact to the same host mesh."""
    nt = int(mj.num_triangles)
    assert int(mp.num_triangles) == nt and mp.vertices.shape == (3 * nt, 3)
    np.testing.assert_array_equal(mp.vertices, np.asarray(mj.vertices)[: 3 * nt])
    np.testing.assert_array_equal(mp.vertex_colors, np.asarray(mj.vertex_colors)[: 3 * nt])
    a, b = mp.compact(), interop.mesh_from(mj).compact()
    for f in ("vertices", "triangles", "vertex_colors"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_mc_tables_equal_jax():
    for name in ("TRI_TABLE", "TRI_COUNT", "EDGE_ENDPOINTS", "CORNER_OFFSETS"):
        np.testing.assert_array_equal(getattr(mt, name), getattr(jmt, name))
    assert mt.MAX_TRIS_PER_CELL == jmt.MAX_TRIS_PER_CELL


def test_dense_sphere_matches_numpy_and_jax_in_order(sphere):
    """Same triangles as the dense numpy MC (canonical sort, 1e-5 as in
    test_marching_cubes.py) and as JAX's extract_mesh in the same order,
    vertices and colors to the bit."""
    field, vj, vt = sphere
    mj = jmc.extract_mesh(vj, JCFG, max_cells=16384, max_tris=32768)
    mp = mc.extract_mesh(vt, CFG, max_cells=16384, max_tris=32768)
    nt = int(mp.num_triangles)
    assert nt == int(mj.num_triangles) > 100 and not mp.overflow
    _same_soup(mp, mj)
    ref = numpy_marching_cubes(field, origin=0.5 * CFG.voxel_size, spacing=CFG.voxel_size)
    assert nt == len(ref)

    def canon(tris):
        v = np.round(tris.reshape(-1, 3), 6)
        return v[np.lexsort(v.T)]

    np.testing.assert_allclose(canon(mp.vertices[: 3 * nt]), canon(ref), atol=1e-5)
    host = mp.compact()
    assert host.vertices.shape == (3 * nt, 3) and host.triangles.shape == (nt, 3)


def test_fused_volume_mesh_matches_jax():
    """A volume fused from rendered frames at 16^3 blocks (the chip's block
    size), carried across: same soup in the same order, to the bit."""
    kw = dict(KW, block_resolution=16, voxel_size=0.02, sdf_trunc=0.08, block_capacity=512,
              hash_capacity=2048)
    jc = JTSDFConfig(**kw)
    intr = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)
    cam, rays = JCamera(intrinsics=intr), jpixel_rays(intr)
    vj = jtsdf.create(jc)
    for T in orbit_trajectory(3, radius=0.3, angle_span=0.8):
        z, col = cam.render(np.asarray(T, np.float32))
        vj = jtsdf.integrate_frame(vj, z, col, rays, jnp.asarray(T, jnp.float32), intr, jc,
                                   backend="xla")
    mj = jmc.extract_mesh(vj, jc, max_cells=65536, max_tris=65536)
    mp = mc.extract_mesh(_carry(vj), TSDFConfig(**kw), max_cells=65536, max_tris=65536)
    assert int(mp.num_triangles) > 1000
    _same_soup(mp, mj)


@pytest.mark.parametrize("max_cells,max_tris", [(64, 64), (64, 100000), (100000, 64)])
def test_small_budget_truncates_like_jax(sphere, max_cells, max_tris):
    """A budget too small (groups, triangles or both) truncates in emission
    order and sets the flag, as JAX's extract_mesh_arrays does."""
    _, vj, vt = sphere
    vj_, cj, nj, oj = _arrays(jmc.extract_mesh_arrays(vj, JCFG, max_cells=max_cells,
                                                      max_tris=max_tris))
    vp, cp, np_, op = _arrays(mc.extract_mesh_arrays(vt, CFG, max_cells=max_cells,
                                                     max_tris=max_tris))
    assert oj and op and nj == np_
    np.testing.assert_array_equal(vp, vj_)
    np.testing.assert_array_equal(cp, cj)
    m = mc.extract_mesh(vt, CFG, max_cells=max_cells, max_tris=max_tris, auto_grow=False)
    assert m.overflow and int(m.num_triangles) == np_
    np.testing.assert_array_equal(m.vertices, vp.transpose(2, 0, 1).reshape(-1, 3)[: 3 * np_])


def test_auto_grow_recovers_full_mesh():
    field = _sphere_field(2, 0.1)
    vj = build_volume_from_field(field, JCFG)
    vt = _carry(vj)
    assert bool(mc.extract_mesh_arrays(vt, CFG, max_cells=64, max_tris=64)[3])
    mp = mc.extract_mesh(vt, CFG, max_cells=64, max_tris=64, auto_grow=True)
    mj = jmc.extract_mesh(vj, JCFG, max_cells=64, max_tris=64, auto_grow=True)
    ref = numpy_marching_cubes(field, origin=0.5 * CFG.voxel_size, spacing=CFG.voxel_size)
    assert int(mp.num_triangles) == len(ref) and not mp.overflow
    _same_soup(mp, mj)


def test_weld_vertices_matches_jax_and_is_closed():
    vj = build_volume_from_field(_sphere_field(2, 0.1), JCFG)
    soup = mc.extract_mesh(_carry(vj), CFG, max_cells=16384, max_tris=32768).compact()
    welded = mc.weld_vertices(soup)
    wj = jmc.weld_vertices(jmc.extract_mesh(vj, JCFG, max_cells=16384,
                                            max_tris=32768).compact())
    np.testing.assert_array_equal(welded.vertices, wj.vertices)
    np.testing.assert_array_equal(welded.triangles, wj.triangles)
    np.testing.assert_array_equal(welded.vertex_colors, wj.vertex_colors)
    assert welded.vertices.shape[0] < soup.vertices.shape[0]
    edges = np.sort(np.concatenate([welded.triangles[:, [0, 1]], welded.triangles[:, [1, 2]],
                                    welded.triangles[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts % 2 == 0).all()
    normals = welded.compute_vertex_normals().vertex_normals
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-5)


def test_count_active_bricks_matches_jax_and_overflow_boundary():
    R = JCFG.block_resolution
    n = 3 * R
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    field = np.clip(np.minimum(np.linalg.norm(g - n / 2.0, axis=0) - n / 4.0, 1.0) / 4.0, -1, 1)
    vj = build_volume_from_field(field.astype(np.float32), JCFG)
    vt = _carry(vj)
    E = mc.snap_extract_blocks(int(vt.n_blocks), CFG.block_capacity)
    nb = int(mc.count_active_bricks(vt, CFG, extract_blocks=E))
    assert nb == int(jmc.count_active_bricks(vj, JCFG, extract_blocks=E)) > 2
    assert not bool(mc.extract_mesh_arrays(vt, CFG, max_cells=nb * 64, max_tris=1 << 16,
                                           extract_blocks=E)[3])
    assert bool(mc.extract_mesh_arrays(vt, CFG, max_cells=(nb - 1) * 64, max_tris=1 << 16,
                                       extract_blocks=E)[3])


@pytest.mark.parametrize("budget", [512, 4096, 65536])
def test_surface_samples_match_jax(sphere, budget):
    """The prefix samplers at budgets that give strides 4, 2 and 1."""
    _, vj, vt = sphere
    E = mc.snap_extract_blocks(int(vt.n_blocks), CFG.block_capacity)
    jp, jm, jo = jmc.extract_surface_samples_device(vj, JCFG, budget, extract_blocks=E,
                                                     max_cells=16384)
    tp, tm, to = mc.extract_surface_samples_device(vt, CFG, budget, extract_blocks=E,
                                                   max_cells=16384)
    hp, hm, ho = mc.extract_surface_samples(vt, CFG, budget, max_cells=16384)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy()[tm.numpy()], np.asarray(jp)[np.asarray(jm)])
    np.testing.assert_array_equal(hm.numpy(), tm.numpy())
    np.testing.assert_array_equal(hp.numpy(), tp.numpy())
    assert bool(to) == bool(jo) == bool(ho)


def test_sampled_model_unthinned_matches_jax_and_prefix(sphere_by_key):
    """Nothing thins: on a key-ordered pool the block-sampled model equals
    JAX's and the prefix sampler's."""
    vj, vt = sphere_by_key
    E = mc.snap_extract_blocks(int(vt.n_blocks), CFG.block_capacity)
    n_points = 3 * 65536
    kw = dict(reach=50.0, sample_blocks=128, bricks_per_block=CFG.block_resolution ** 3 // 64)
    jp, jm, jo = jmc.extract_sampled_surface_model(vj, JCFG, n_points,
                                                    jnp.eye(4, dtype=jnp.float32), **kw)
    tp, tm, to = mc.extract_sampled_surface_model(vt, CFG, n_points, torch.eye(4), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy()[tm.numpy()], np.asarray(jp)[np.asarray(jm)])
    hp, hm, _ = mc.extract_surface_samples_device(vt, CFG, n_points, extract_blocks=E,
                                                  max_cells=64 * 4096)
    np.testing.assert_array_equal(hm.numpy(), tm.numpy())
    np.testing.assert_array_equal(hp.numpy()[hm.numpy()], tp.numpy()[tm.numpy()])
    assert not bool(to) and not bool(jo)


# (n_points, sample_blocks, bricks_per_block, supplier_rows, reach) and
# which thinning each case engages: the block stride (more near blocks than
# sample_blocks), the group stride (more active groups than the budget), the
# triangle stride (more triangles than n_points // 3), the supplier overflow
STRIDES = [
    pytest.param(384, 16, 2, 112, 50.0, (True, True, True, False), id="block+group+triangle"),
    pytest.param(3000, 8, 1, 4, 50.0, (True, True, False, True), id="block+group+suppliers"),
    pytest.param(900, 64, 4, None, 1.2, (False, False, True, False), id="view-local+triangle"),
]


@pytest.mark.parametrize("n_points,B,bpb,S,reach,engaged", STRIDES)
def test_sampled_model_every_stride_matches_jax(slab_by_key, n_points, B, bpb, S, reach,
                                                engaged):
    """On a key-ordered pool, where JAX's slot stride and the port's key
    stride agree: the selection and the model equal JAX's."""
    vj, vt = slab_by_key
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.7, 0.2, 0.1)
    S_rows = S if S else 3 * B
    sel_j = jmc.sample_block_selection(vj, jnp.asarray(T), jnp.float32(reach),
                                       jnp.float32(JCFG.block_size), B, S_rows)
    sel_t = mc.sample_block_selection(vt, torch.from_numpy(T), reach, CFG.block_size, B, S_rows)
    for a, b in zip(sel_t, sel_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jp, jm, jo = jmc.extract_sampled_surface_model(vj, JCFG, n_points, jnp.asarray(T), reach,
                                                    sample_blocks=B, bricks_per_block=bpb,
                                                    supplier_rows=S)
    tp, tm, to = mc.extract_sampled_surface_model(vt, CFG, n_points, torch.from_numpy(T),
                                                  reach, sample_blocks=B, bricks_per_block=bpb,
                                                  supplier_rows=S)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert bool(to) == bool(jo) and tm.numpy().sum() > 30
    # the thinning this case engages, counted on the port's own selection
    centers = (vt.block_coords[: int(vt.n_blocks)].numpy() + 0.5) * CFG.block_size
    near = int((np.linalg.norm(centers - T[:3, 3], axis=1) <= reach).sum())
    sv = mc._survey(vt, CFG, emit_mask=sel_t[2], sel=sel_t[0], nbr_sel=sel_t[1], colors=False)
    groups = int((sv.case.view(-1, mc.GROUP) != 0).any(dim=1).sum())
    tris = int(torch.from_numpy(mt.TRI_COUNT)[sv.case].sum())
    assert (near > B, groups > B * bpb, tris > n_points // 3, bool(sel_t[3])) == engaged


def _model_by_key(vol, n_points, B, bpb, S, reach, T):
    """The selection's rows as block keys (-1 = padding), its neighbor rows,
    emit mask and flag, and the sampled model: everything a slot order could
    move."""
    S_rows = S if S else 3 * B
    sel, nbr, emit, ovf = mc.sample_block_selection(vol, T, reach, CFG.block_size, B, S_rows)
    keys = torch.where(sel >= 0, pack_key(vol.block_coords[sel.clamp_min(0)]), -1)
    pts, mask, m_ovf = mc.extract_sampled_surface_model(vol, CFG, n_points, T, reach,
                                                        sample_blocks=B, bricks_per_block=bpb,
                                                        supplier_rows=S)
    return [keys, nbr, emit, ovf, pts, mask, m_ovf]


@pytest.mark.parametrize("scene,n_points,B,bpb,S,reach", [
    pytest.param("slab", *p.values[:5], id=p.id) for p in STRIDES] + [
    pytest.param("sphere", 3 * 65536, 128, CFG.block_resolution ** 3 // 64, None, 50.0,
                 id="unthinned")])
def test_sampled_model_is_independent_of_slot_order(request, scene, n_points, B, bpb, S, reach):
    """The same blocks in other slots (a random permutation and the
    reversal, each with its table rebuilt, as host streaming's compaction
    does): the selection's keys and the model's points and mask are equal
    to the bit. Ranking by slot, a streamed pool sampled other blocks than
    a plain one that holds the same voxels."""
    vt = request.getfixturevalue(scene)[-1]
    T = torch.eye(4)
    if scene == "slab":
        T[:3, 3] = torch.tensor((0.7, 0.2, 0.1))
    n = int(vt.n_blocks)
    want = _model_by_key(vt, n_points, B, bpb, S, reach, T)
    assert int(want[5].sum()) > 30
    for perm in (np.random.default_rng(5).permutation(n), np.arange(n)[::-1]):
        moved = _compact(vt, np.concatenate([perm, np.arange(n, vt.tsdf.shape[0])]), n)
        assert not bool(moved.overflow) and not torch.equal(moved.block_coords, vt.block_coords)
        for a, b in zip(_model_by_key(moved, n_points, B, bpb, S, reach, T), want):
            assert torch.equal(a, b)


def test_sample_tsdf_matches_jax(sphere):
    _, vj, vt = sphere
    rng = np.random.RandomState(3)
    pts = rng.uniform(-0.1, 0.75, (500, 3)).astype(np.float32)  # inside and outside the pool
    tj, wj = jtsdf.sample_tsdf(vj, pts, JCFG)
    tt, wt = tsdf.sample_tsdf(vt, torch.from_numpy(pts), CFG)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert (wt.numpy() == 0).any() and (wt.numpy() > 0).any()


@pytest.mark.parametrize("max_points", [2000, 65536])
def test_point_cloud_device_matches_jax(sphere, max_points):
    """Points and colors <= 1e-6 (a float32 ulp at these magnitudes; the
    compiled JAX loop may round its interpolation once or twice), mask
    equal; 2000 points truncates."""
    _, vj, vt = sphere
    jp, jc, jm = jtsdf.extract_point_cloud_device(vj, JCFG, max_points=max_points)
    tp, tc, tm = tsdf.extract_point_cloud_device(vt, CFG, max_points=max_points)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    assert tm.numpy().sum() == min(max_points, tm.numpy().sum()) > 1000


def test_pow2_bucket_and_snap_match_jax():
    for n in (0, 1, 63, 64, 65, 1000, 70000):
        assert mc.pow2_bucket(n) == jmc.pow2_bucket(n)
        assert mc.pow2_bucket(n, cap=4096) == jmc.pow2_bucket(n, cap=4096)
        assert mc.snap_extract_blocks(n, 16384) == jmc.snap_extract_blocks(n, 16384)

