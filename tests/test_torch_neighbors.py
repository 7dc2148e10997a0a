"""The port's grid-hash neighbor machinery and normals (``ops/neighbors.py``,
``ops/normals.py``) against the JAX package, from the same seeded numpy
inputs. Each later stage starts from the JAX package's own output of the
stage before, carried across by ``interop.cloud_to_torch``. Each tolerance
is stated where it is used."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.ops import neighbors as jnb
from azurekinect3dreconstruction_tpu.ops import normals as jnormals
from azurekinect3dreconstruction_tpu.ops.backproject import backproject_depth as jbackproject
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.ops import neighbors as nb
from azurekinect3dreconstruction_tpu_torch.ops import normals

torch.set_num_threads(1)

JINTR = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)


def _np(a):
    return None if a is None else np.array(a)


def _rows_sorted(a):
    return a[np.lexsort(a.T[::-1])]


@pytest.fixture(scope="module")
def frame_cloud():
    """A rendered quarter-resolution frame as a flat masked cloud, with
    seeded per-point colors and unit normals to average."""
    z, _ = JCamera(intrinsics=JINTR).render(np.eye(4, dtype=np.float32))
    pts = np.array(jbackproject(z, jpixel_rays(JINTR))).reshape(-1, 3)
    rng = np.random.RandomState(0)
    cols = rng.uniform(0, 1, pts.shape).astype(np.float32)
    nrm = rng.normal(size=pts.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mask = (pts[:, 2] > 0) & (rng.uniform(size=len(pts)) > 0.1)
    return pts, mask, cols, nrm


@pytest.fixture(scope="module")
def downsampled(frame_cloud):
    """JAX's 2 cm downsample of the frame (the calibration's first stage)."""
    pts, mask, _, _ = frame_cloud
    p, m, _, _ = jnb.voxel_downsample_arrays(pts, mask, 0.02, 8192)
    return _np(p), _np(m)


@pytest.mark.parametrize("voxel, capacity", [(0.02, 16384), (0.05, 4096)])
def test_voxel_downsample_matches_jax(frame_cloud, voxel, capacity):
    """The same cells (rows compared as sets: the port's hash may number
    them in another order), voxel means of points, colors and normals
    within 1e-6 relative (the sums may run in another order)."""
    pts, mask, cols, nrm = frame_cloud
    jp, jm, jc, jn = map(_np, jnb.voxel_downsample_arrays(pts, mask, voxel, capacity,
                                                           colors=cols, normals=nrm))
    t = lambda a: torch.from_numpy(a)
    tp, tm, tc, tn = (x.numpy() for x in nb.voxel_downsample_arrays(
        t(pts), t(mask), voxel, capacity, colors=t(cols), normals=t(nrm)))
    assert tm.sum() == jm.sum() > 100
    a = _rows_sorted(np.concatenate([jp, jc, jn], 1)[jm])
    b = _rows_sorted(np.concatenate([tp, tc, tn], 1)[tm])
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cell", [0.01, 0.02, 0.05])
def test_count_occupied_cells_exact(frame_cloud, cell):
    pts, mask, _, _ = frame_cloud
    want = int(jnb.count_occupied_cells(pts, mask, cell))
    got = int(nb.count_occupied_cells(torch.from_numpy(pts), torch.from_numpy(mask), cell))
    assert got == want > 100


def test_build_cell_lists_keeps_the_same_points(frame_cloud):
    """Cell by cell (matched by key), the lists hold the same point
    indices, overflowing cells included: the lowest indices of the cell."""
    pts, mask, _, _ = frame_cloud
    jc = jnb.build_cell_lists(pts, mask, 0.05, 4096, max_per_cell=8)
    tc = nb.build_cell_lists(torch.from_numpy(pts), torch.from_numpy(mask), 0.05, 4096,
                             max_per_cell=8)

    def by_key(keys, vals, lists):
        keys, vals, lists = np.asarray(keys), np.asarray(vals), np.asarray(lists)
        live = (keys >= 0) & (vals >= 0)
        return {int(k): tuple(sorted(lists[v])) for k, v in zip(keys[live], vals[live])}

    a = by_key(jc.table_keys, jc.table_vals, jc.lists)
    b = by_key(tc.table_keys.numpy(), tc.table_vals.numpy(), tc.lists.numpy())
    assert a == b
    assert any(-1 not in row for row in a.values())  # some cells are full


@pytest.mark.parametrize("k, max_per_cell", [(6, 16), (12, 8), (16, 8)])
def test_knn_matches_jax(downsampled, k, max_per_cell):
    """From JAX's downsample: the same neighbor found at every rank that is
    not a tie, distances within 1e-6 (an ulp or two of the square root),
    and the same empty slots."""
    p, m = downsampled
    jn_, jd = map(_np, jnb.knn(p, m, 0.06, k=k, max_per_cell=max_per_cell))
    tp, tm, _, _ = interop.cloud_to_torch(p, m)
    tn_, td = (x.numpy() for x in nb.knn(tp, tm, 0.06, k=k, max_per_cell=max_per_cell))
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(np.where(fin, td, 0), np.where(fin, jd, 0), rtol=0, atol=1e-6)
    # a tie: the distance equals its left or right neighbor's in the row
    tie = np.zeros_like(fin)
    close = np.abs(np.diff(np.where(fin, jd, 0), axis=1)) <= 1e-6
    tie[:, 1:] |= close
    tie[:, :-1] |= close
    decided = fin & ~tie
    assert decided.sum() > 0.5 * fin.sum()
    np.testing.assert_array_equal(tn_[decided], jn_[decided])
    np.testing.assert_array_equal(tn_[~fin], -1)


def test_knn_gather_matches_bruteforce():
    """Port only: with roomy cells, the neighbors are the brute-force ones."""
    rng = np.random.RandomState(1)
    pts = rng.uniform(0, 0.5, (300, 3)).astype(np.float32)
    nn, dist = nb.knn(torch.from_numpy(pts), torch.ones(300, dtype=torch.bool), 0.08, k=6,
                      capacity=4096, max_per_cell=16)
    d_all = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    np.fill_diagonal(d_all, np.inf)
    for i in range(300):
        true = np.sort(d_all[i][d_all[i] <= 0.08])[:6]
        got = dist[i].numpy()
        np.testing.assert_allclose(got[np.isfinite(got)], true, atol=1e-6)
        assert set(nn[i][nn[i] >= 0].tolist()) <= set(np.nonzero(d_all[i] <= 0.08)[0])


def _floaters():
    rng = np.random.RandomState(2)
    cloud = rng.uniform(0, 0.3, (500, 3)).astype(np.float32)
    floaters = np.array([[2.0, 2, 2], [-3, 1, 0], [0, 5, 1]], np.float32)
    return np.concatenate([cloud, floaters]), np.ones(503, bool), 10, 0.15


@pytest.mark.parametrize("case", ["frame", "floaters"])
def test_outlier_mask_matches_jax(downsampled, case):
    """The same mask (exactly)."""
    p, m, k, r = (*downsampled, 12, 0.06) if case == "frame" else _floaters()
    want = _np(jnb.remove_statistical_outliers(p, m, k=k, radius=r))
    got = nb.remove_statistical_outliers(*interop.cloud_to_torch(p, m)[:2], k=k, radius=r)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (m & ~want).sum() < 0.2 * m.sum()


@pytest.mark.parametrize("orient", [True, False])
def test_estimate_normals_knn_matches_jax(downsampled, orient):
    """Oriented toward the camera: within 1e-4, except where the normal is
    at right angles to the view direction (|cos| < 1e-3), whose sign the
    orientation cannot decide. Unoriented: within 1e-4 up to sign."""
    p, m = downsampled
    eye = np.zeros(3, np.float32) if orient else None
    want = _np(jnb.estimate_normals_knn(p, m, radius=0.04, k=12, orient_to=eye))
    got = nb.estimate_normals_knn(*interop.cloud_to_torch(p, m)[:2], radius=0.04, k=12,
                                  orient_to=eye).numpy()
    have = np.linalg.norm(want, axis=1) > 0.5
    assert have.sum() > 0.5 * m.sum()
    np.testing.assert_array_equal(np.linalg.norm(got, axis=1) > 0.5, have)
    if orient:
        view = np.abs((want * p).sum(1)) / np.maximum(np.linalg.norm(p, axis=1), 1e-9)
        sure = have & (view > 1e-3)
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-4)
    else:
        cos = np.abs((got * want).sum(1))[have]
        assert cos.min() >= 1 - 1e-4


def test_pca_normal_matches_jax_up_to_sign():
    """Seeded noisy planar neighborhoods with random masks: |n . n_jax| >=
    1 - 1e-4 (eigenvectors are defined up to sign)."""
    rng = np.random.RandomState(5)
    B, K = 200, 16
    normal = rng.normal(size=(B, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    a = np.cross(normal, rng.normal(size=(B, 3)))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = np.cross(normal, a)
    uv = rng.uniform(-0.05, 0.05, (B, K, 2))
    nb_pts = (uv[..., :1] * a[:, None] + uv[..., 1:] * b[:, None]
              + 1e-3 * rng.normal(size=(B, K, 1)) * normal[:, None]).astype(np.float32)
    mask = rng.uniform(size=(B, K)) > 0.2
    want = np.array(jnormals.pca_normal(jnp.asarray(nb_pts), jnp.asarray(mask)))
    got = normals.pca_normal(torch.from_numpy(nb_pts), torch.from_numpy(mask)).numpy()
    assert np.abs((got * want).sum(1)).min() >= 1 - 1e-4
    assert np.abs((got * normal).sum(1)).min() > 0.99


def test_orient_normals_consistent_matches_jax():
    """A sphere whose normals are 30 % flipped: the same signs as the JAX
    pass (from the same input), and the majority orientation everywhere."""
    rng = np.random.RandomState(3)
    n = 3000
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 0.2).astype(np.float32)
    nr0 = (d * np.where(rng.rand(n) < 0.3, -1.0, 1.0)[:, None]).astype(np.float32)
    mask = np.ones(n, bool)
    want = np.array(jnormals.orient_normals_consistent(jnp.asarray(pts), jnp.asarray(nr0),
                                                       jnp.asarray(mask), radius=0.05))
    tp, tm, tn, _ = interop.cloud_to_torch(pts, mask, normals=nr0)
    got = normals.orient_normals_consistent(tp, tn, tm, radius=0.05).numpy()
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    assert ((got * d).sum(1) > 0).mean() > 0.99


def test_auto_capacity():
    assert nb.auto_capacity(10) == jnb.auto_capacity(10) == 4096
    assert nb.auto_capacity(10000) == jnb.auto_capacity(10000) == 16384
