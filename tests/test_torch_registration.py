"""The port's global registration stack against the JAX package: FPFH
(``tracking/features.py``), feature matching and RANSAC
(``tracking/ransac.py``), and the cloud-to-cloud ICPs and
``evaluate_registration`` (``tracking/icp.py``). Each stage starts from the
JAX package's own output of the stage before (points, mask, normals, FPFH,
correspondences), carried across by ``interop.cloud_to_torch``; RANSAC gets
JAX's drawn samples. Each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu.config import RegistrationConfig as JRegistrationConfig
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.ops.neighbors import estimate_normals_knn as jnormals
from azurekinect3dreconstruction_tpu.tracking import icp as jicp
from azurekinect3dreconstruction_tpu.tracking import ransac as jransac
from azurekinect3dreconstruction_tpu.tracking.features import compute_fpfh as jfpfh
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.config import RegistrationConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.tracking import icp, ransac
from azurekinect3dreconstruction_tpu_torch.tracking.features import compute_fpfh
from test_registration import VIEWPOINT, make_structured_cloud

torch.set_num_threads(1)

POSE_TOL = 1e-4  # sums over ~1k points in another order


def _np(a):
    return np.array(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    """The structured cloud of tests/test_registration.py and its rigid
    copy, with JAX's oriented normals and FPFH (radius 0.15, k 16)."""
    src = make_structured_cloud()
    xi = np.array([0.2, -0.1, 0.15, 0.3, 0.2, -0.4])
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))
    tgt = (src @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    mask = np.ones(len(src), bool)
    eye_t = (T_true[:3, :3] @ VIEWPOINT + T_true[:3, 3]).astype(np.float32)
    n_s = _np(jnormals(jnp.asarray(src), mask, radius=0.12, k=16,
                       orient_to=VIEWPOINT.astype(np.float32)))
    n_t = _np(jnormals(jnp.asarray(tgt), mask, radius=0.12, k=16, orient_to=eye_t))
    f_s = _np(jfpfh(src, n_s, mask, radius=0.15, k=16))
    f_t = _np(jfpfh(tgt, n_t, mask, radius=0.15, k=16))
    return dict(src=src, tgt=tgt, T=T_true, mask=mask, n_s=n_s, n_t=n_t, f_s=f_s, f_t=f_t)


def _err(T, T_true):
    d = se3.se3_log(torch.as_tensor(np.linalg.inv(T_true) @ np.asarray(T), dtype=torch.float32))
    return float(torch.linalg.vector_norm(d[:3])), float(torch.linalg.vector_norm(d[3:]))


@pytest.mark.parametrize("side", ["src", "tgt"])
def test_fpfh_matches_jax(pair, side):
    """From JAX's points and normals: descriptors within 1e-5."""
    n = pair["n_s" if side == "src" else "n_t"]
    want = pair["f_s" if side == "src" else "f_t"]
    p, m, nr, _ = interop.cloud_to_torch(pair[side], pair["mask"], normals=n)
    got = compute_fpfh(p, nr, m, radius=0.15, k=16).numpy()
    assert (np.abs(want).sum(1) > 0).mean() > 0.9
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _margins(fs, ft, ms, mt):
    """Per source row and target column: the gap between the nearest and
    the second-nearest feature distance (float64)."""
    d = ((fs[:, None, :].astype(np.float64) - ft[None].astype(np.float64)) ** 2).sum(-1)
    d = np.where(ms[:, None] & mt[None], d, 1e9)
    r, c = np.sort(d, axis=1), np.sort(d, axis=0)
    return r[:, 1] - r[:, 0], c[1] - c[0]


@pytest.mark.parametrize("mutual", [True, False])
def test_match_features_matches_jax(pair, mutual):
    """The same correspondences wherever the nearest feature is decided: a
    gap of more than 1e-5 between the two nearest (feature distances of
    flat regions tie to float32 rounding, and then either package may pick
    either one)."""
    ok_s = pair["mask"] & (np.abs(pair["f_s"]).sum(1) > 0)
    ok_t = pair["mask"] & (np.abs(pair["f_t"]).sum(1) > 0)
    want = _np(jransac.match_features(pair["f_s"], pair["f_t"], ok_s, ok_t, mutual=mutual))
    got = ransac.match_features(_t(pair["f_s"]), _t(pair["f_t"]), _t(ok_s), _t(ok_t),
                                mutual=mutual).numpy()
    row_gap, col_gap = _margins(pair["f_s"], pair["f_t"], ok_s, ok_t)
    decided = row_gap > 1e-5
    if mutual:
        decided &= col_gap[np.maximum(want, 0)] > 1e-5
    assert decided.mean() > 0.4 and (want[decided] >= 0).sum() > 50
    np.testing.assert_array_equal(got[decided], want[decided])


def test_ransac_with_jax_samples_matches_jax(pair):
    """JAX's correspondences and JAX's drawn ranks fed to both: T within
    1e-4, fitness equal, inlier RMSE within 1e-6."""
    ok_s = pair["mask"] & (np.abs(pair["f_s"]).sum(1) > 0)
    ok_t = pair["mask"] & (np.abs(pair["f_t"]).sum(1) > 0)
    corr = _np(jransac.match_features(pair["f_s"], pair["f_t"], ok_s, ok_t))
    jcfg = JRegistrationConfig(ransac_hypotheses=2048)
    key = jax.random.PRNGKey(0)
    want = jransac.ransac_registration(pair["src"], pair["tgt"], corr, key, jcfg, 0.05)
    n_corr = int((corr >= 0).sum())
    ranks = _np(jax.random.randint(key, (jcfg.ransac_hypotheses, jcfg.ransac_n), 0, n_corr))
    got = ransac.ransac_registration(_t(pair["src"]), _t(pair["tgt"]), _t(corr),
                                     RegistrationConfig(ransac_hypotheses=2048), 0.05,
                                     samples=_t(ranks))
    np.testing.assert_allclose(got.T.numpy(), _np(want.T), rtol=0, atol=POSE_TOL)
    assert float(got.fitness) == float(want.fitness) > 0.1
    assert int(got.n_correspondences) == int(want.n_correspondences) == n_corr
    assert abs(float(got.inlier_rmse) - float(want.inlier_rmse)) <= 1e-6


def test_ransac_sampler_is_seeded():
    """Ranks come from the generator alone: the same seed gives the same
    ranks, all inside [0, n_corr); without a generator or samples it raises."""
    draw = lambda s: ransac.draw_samples(torch.tensor(37), 512, 4,
                                         torch.Generator().manual_seed(s))
    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) == 0 and int(a.max()) == 36
    with pytest.raises(ValueError):
        ransac.ransac_registration(torch.zeros((4, 3)), torch.zeros((4, 3)),
                                   torch.zeros(4, dtype=torch.int64))


def test_global_registration_recovers_pose(pair):
    """The bound of tests/test_registration.py: fitness > 0.1, the pose
    within 3 cm / 0.05 rad, with the port's own seeded sampler."""
    p_s, m, n_s, f_s = interop.cloud_to_torch(pair["src"], pair["mask"], features=pair["f_s"])
    p_t, _, _, f_t = interop.cloud_to_torch(pair["tgt"], pair["mask"], features=pair["f_t"])
    res = ransac.global_registration(p_s, f_s, m, p_t, f_t, m,
                                     RegistrationConfig(ransac_hypotheses=2048),
                                     distance_threshold=0.05,
                                     generator=torch.Generator().manual_seed(0))
    assert float(res.fitness) > 0.1
    et, er = _err(res.T.numpy(), pair["T"])
    assert et < 0.03 and er < 0.05


@pytest.mark.parametrize("repeats", [1, 2], ids=["unique", "repeated"])
def test_ransac_rival_sees_a_repeat(repeats):
    """``rival``: 300 points matched to their rigid copy (``unique``) hold
    no hypothesis outside the winner's inliers; matched half to that copy
    and half to a second one 1 m along x (``repeated``, a scene that
    repeats), the best hypothesis outside the winner's inliers holds at
    least 3/4 as many as the winner."""
    rng = np.random.default_rng(0)
    src = rng.uniform(-0.25, 0.25, (300, 3)).astype(np.float32)
    tgt = src + np.float32([0.1, -0.05, 0.2])
    copies = np.concatenate([tgt + np.float32([k, 0.0, 0.0]) for k in range(repeats)])
    corr = torch.arange(300) + 300 * (torch.arange(300) % repeats)
    res = ransac.ransac_registration(torch.from_numpy(src), torch.from_numpy(copies), corr,
                                     RegistrationConfig(ransac_hypotheses=2048),
                                     distance_threshold=0.01,
                                     generator=torch.Generator().manual_seed(0))
    n_f = round(float(res.fitness) * 300)
    assert n_f == 300 // repeats, n_f
    if repeats == 1:
        assert int(res.rival) == 0
    else:
        assert int(res.rival) >= 0.75 * n_f, (int(res.rival), n_f)


def _perturbed(pair, xi):
    return (np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32))) @ pair["T"]).astype(
        np.float32)


def test_icp_grid_matches_jax(pair):
    """Point-to-plane over 30 iterations from the same start: T within
    1e-4, fitness within 1e-3; and the pose recovered (5 mm / 5 mrad)."""
    init = _perturbed(pair, np.array([0.01, -0.015, 0.01, 0.02, -0.01, 0.015]))
    n_t = _np(jnormals(jnp.asarray(pair["tgt"]), pair["mask"], radius=0.12, k=16))
    want = jicp.icp_grid(pair["src"], pair["mask"], pair["tgt"], n_t, pair["mask"],
                         init=jnp.asarray(init), max_iters=30, dist_thr=0.06)
    p_s, m, _, _ = interop.cloud_to_torch(pair["src"], pair["mask"])
    p_t, _, nr, _ = interop.cloud_to_torch(pair["tgt"], pair["mask"], normals=n_t)
    got = icp.icp_grid(p_s, m, p_t, nr, m, init=_t(init), max_iters=30, dist_thr=0.06)
    np.testing.assert_allclose(got.T.numpy(), _np(want.T), rtol=0, atol=POSE_TOL)
    assert abs(float(got.fitness) - float(want.fitness)) <= 1e-3
    et, er = _err(got.T.numpy(), pair["T"])
    assert et < 5e-3 and er < 5e-3 and float(got.fitness) > 0.8


@pytest.mark.parametrize("cell_size", [None, 0.04])
def test_icp_point_to_point_matches_jax(pair, cell_size):
    """Kabsch ICP over 30 iterations from the same start: T within 1e-4,
    fitness within 1e-3, the rotation orthonormal to 1e-5."""
    init = _perturbed(pair, np.array([0.015, -0.01, 0.012, 0.025, -0.015, 0.02]))
    want = jicp.icp_point_to_point(pair["src"], pair["mask"], pair["tgt"], pair["mask"],
                                   init=jnp.asarray(init), max_iters=30, dist_thr=0.06,
                                   cell_size=cell_size)
    p_s, m, _, _ = interop.cloud_to_torch(pair["src"], pair["mask"])
    got = icp.icp_point_to_point(p_s, m, _t(pair["tgt"]), m, init=_t(init), max_iters=30,
                                 dist_thr=0.06, cell_size=cell_size)
    np.testing.assert_allclose(got.T.numpy(), _np(want.T), rtol=0, atol=POSE_TOL)
    assert abs(float(got.fitness) - float(want.fitness)) <= 1e-3
    R = got.T.numpy()[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    et, er = _err(got.T.numpy(), pair["T"])
    assert et < 2e-3 and er < 2e-3


@pytest.mark.parametrize("which", ["true", "identity"])
def test_evaluate_registration_matches_jax(pair, which):
    """Fitness equal, inlier RMSE within 1e-6, at the true pose and at the
    identity."""
    T = pair["T"].astype(np.float32) if which == "true" else np.eye(4, dtype=np.float32)
    jf, jr = jicp.evaluate_registration(pair["src"], pair["mask"], pair["tgt"], pair["mask"],
                                        jnp.asarray(T), dist_thr=0.02)
    p_s, m, _, _ = interop.cloud_to_torch(pair["src"], pair["mask"])
    tf, tr = icp.evaluate_registration(p_s, m, _t(pair["tgt"]), m, _t(T), dist_thr=0.02)
    assert float(tf) == float(jf)
    assert abs(float(tr) - float(jr)) <= 1e-6
    if which == "true":
        assert float(tf) > 0.9 and float(tr) < 0.01
