"""The port's projective ICP and its frame ops (back-projection, samplers,
organized normals, the 6x6 solve) against the JAX package, from the same
numpy inputs. Each tolerance is stated where it is used."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu.config import RegistrationConfig as JRegistrationConfig
from azurekinect3dreconstruction_tpu.core import linalg as jlinalg
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.ops import backproject as jbp
from azurekinect3dreconstruction_tpu.ops.image import rgb_to_intensity as jrgb_to_intensity
from azurekinect3dreconstruction_tpu.ops.normals import organized_normals as jnormals
from azurekinect3dreconstruction_tpu.tracking import icp as jicp
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.config import RegistrationConfig
from azurekinect3dreconstruction_tpu_torch.core import linalg
from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu_torch.ops import backproject as bp
from azurekinect3dreconstruction_tpu_torch.ops.normals import organized_normals
from azurekinect3dreconstruction_tpu_torch.tracking import icp

torch.set_num_threads(1)

JINTR = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)
INTR = interop.intrinsics_from(JINTR)
POSE_TOL = 1e-4  # GN over ~20k points: sums in another order, and a few
# correspondences may flip at a rounding edge


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """Two rendered frames 0.2 rad apart; the source cloud is frame 0's
    points, the target maps frame 1's, and the initial guess perturbs the
    true motion by a few millimetres and milliradians."""
    cam = JCamera(intrinsics=JINTR)
    poses = orbit_trajectory(4, radius=0.25, angle_span=0.4)
    (z0, c0), (z1, c1) = (tuple(np.asarray(x) for x in cam.render(np.asarray(T, np.float32)))
                          for T in poses[:2])
    rays = np.asarray(jpixel_rays(JINTR))
    src = np.asarray(jbp.backproject_depth(z0, rays)).reshape(-1, 3)
    mask = z0.reshape(-1) > 0
    true = (np.linalg.inv(poses[1]) @ poses[0]).astype(np.float32)
    rng = np.random.RandomState(0)
    xi = np.concatenate([rng.uniform(-4e-3, 4e-3, 3), rng.uniform(-4e-3, 4e-3, 3)])
    init = (np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32))) @ true).astype(np.float32)
    return dict(z0=z0, c0=c0, z1=z1, c1=c1, rays=rays, src=src, mask=mask, init=init, true=true)


def _maps(sc, colored):
    i1 = np.asarray(jrgb_to_intensity(sc["c1"])) if colored else None
    jm = jicp.TargetMaps.from_depth(sc["z1"], JINTR, intensity=i1, rays=sc["rays"])
    tm = icp.TargetMaps.from_depth(_t(sc["z1"]), _t(sc["rays"]),
                                   intensity=None if i1 is None else _t(i1))
    return jm, tm


def test_backproject_and_project_match_jax(scene):
    z, rays = scene["z0"], scene["rays"]
    np.testing.assert_array_equal(bp.backproject_depth(_t(z), _t(rays)).numpy(),
                                  np.asarray(jbp.backproject_depth(z, rays)))
    np.testing.assert_array_equal(pixel_rays(INTR, "cpu").numpy(), rays)
    pts = scene["src"][scene["mask"]]
    uv_j, z_j = jbp.project_points(jnp.asarray(pts), JINTR)
    uv_t, z_t = bp.project_points(_t(pts), INTR)
    # the port fuses the multiply-add as the compiled JAX callers do; the
    # eager JAX function rounds twice: 1 ulp at ~160 px
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=3e-5, rtol=0)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))


@pytest.mark.parametrize("channels", [0, 3])
def test_bilinear_sample_matches_jax(scene, channels):
    """In-bounds test ``u0 < W-1``, values to 1e-6; sample points at the
    image edges, outside it and at integer coordinates."""
    img = scene["c1"] if channels else scene["z1"]
    h, w = img.shape[:2]
    rng = np.random.RandomState(1)
    uv = np.concatenate([rng.uniform(-2, w + 1, (400, 1)), rng.uniform(-2, h + 1, (400, 1))], 1)
    edges = np.array([[w - 1, 3], [w - 1.0001, 3], [w - 2, h - 2], [0, 0], [-0.0001, 5],
                      [5, h - 1], [2.0, 3.0]])
    uv = np.concatenate([uv, edges]).astype(np.float32)
    vj, inj = jbp.bilinear_sample(img, jnp.asarray(uv))
    vt, int_ = bp.bilinear_sample(_t(img), _t(uv))
    np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6, rtol=0)
    assert int_.numpy().any() and not int_.numpy().all()


def test_nearest_sample_matches_jax(scene):
    """Half-pixel coordinates round half to even in both: bit-equal."""
    img = scene["c1"]
    h, w = img.shape[:2]
    rng = np.random.RandomState(2)
    uv = np.concatenate([rng.uniform(-2, w + 1, (300, 1)), rng.uniform(-2, h + 1, (300, 1))], 1)
    halves = np.array([[0.5, 0.5], [1.5, 2.5], [w - 0.5, 3.5], [-0.5, 4], [4, h - 0.5]])
    uv = np.concatenate([uv, halves]).astype(np.float32)
    for a in (img, scene["z1"]):
        vj, inj = jbp.nearest_sample(a, jnp.asarray(uv))
        vt, int_ = bp.nearest_sample(_t(a), _t(uv))
        np.testing.assert_array_equal(int_.numpy(), np.asarray(inj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_organized_normals_match_jax(scene):
    """Unit normals to 1e-6 (the cross product and norm may contract into
    fused multiply-adds in the compiled reference); the zero pattern, the
    border included, equal."""
    pts = np.asarray(jbp.backproject_depth(scene["z1"], scene["rays"]))
    nj = np.asarray(jnormals(jnp.asarray(pts)))
    nt = organized_normals(_t(pts)).numpy()
    np.testing.assert_array_equal(np.abs(nt).sum(-1) > 0, np.abs(nj).sum(-1) > 0)
    np.testing.assert_allclose(nt, nj, atol=1e-6, rtol=0)
    assert (np.abs(nt[0]).sum() == 0) and (np.abs(nt[:, -1]).sum() == 0)
    assert (np.abs(nt).sum(-1) > 0).mean() > 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_spd6_matches_jax(seed):
    """A damped normal-equation system as ICP builds it: x to 1e-5
    relative (the float32 Cholesky, once with and once without contracted
    multiply-adds)."""
    rng = np.random.RandomState(seed)
    J = rng.normal(size=(500, 6)).astype(np.float32) * np.float32(10.0 ** (seed - 1))
    A = (J.T @ J + 1e-6 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    xj = np.asarray(jlinalg.solve_spd6(jnp.asarray(A), jnp.asarray(b)))
    xt = linalg.solve_spd6(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(A.astype(np.float64) @ xt, b, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("rel_tol,max_iters", [(0.0, 12), (1e-6, 30), (1e-3, 30)])
def test_icp_projective_matches_jax(scene, rel_tol, max_iters):
    """Point-to-plane ICP from the same start: pose <= POSE_TOL, inlier
    count within 0.5 %, fitness and rmse close. rel_tol 1e-3 stops after a
    few iterations, which the port's frozen-state loop must reproduce."""
    jm, tm = _maps(scene, colored=False)
    rj = jicp.icp_projective(scene["src"], scene["mask"], jm, JINTR, init=scene["init"],
                             max_iters=max_iters, dist_thr=0.05, rel_tol=rel_tol)
    rt = icp.icp_projective(_t(scene["src"]), _t(scene["mask"]), tm, INTR,
                            init=_t(scene["init"]), max_iters=max_iters, dist_thr=0.05,
                            rel_tol=rel_tol)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=POSE_TOL, rtol=0)
    assert abs(int(rt.inliers) - int(rj.inliers)) <= 0.005 * int(rj.inliers)
    assert abs(float(rt.fitness) - float(rj.fitness)) <= 5e-3
    assert abs(float(rt.inlier_rmse) - float(rj.inlier_rmse)) <= 1e-4
    # it converged onto the true motion (the scene is easy)
    np.testing.assert_allclose(rt.T.numpy(), scene["true"], atol=2e-3 if rel_tol < 1e-3 else 5e-3)
    if rel_tol == 1e-3:
        # the early exit: fewer steps than the budget, and running exactly
        # those steps with no tolerance gives the same pose
        steps = next(k for k in range(1, max_iters + 1) if np.allclose(
            icp.icp_projective(_t(scene["src"]), _t(scene["mask"]), tm, INTR,
                               init=_t(scene["init"]), max_iters=k, dist_thr=0.05,
                               rel_tol=0.0).T.numpy(), rt.T.numpy(), atol=0, rtol=0))
        assert steps < max_iters


def test_colored_icp_matches_jax(scene):
    jm, tm = _maps(scene, colored=True)
    i0 = np.asarray(jrgb_to_intensity(scene["c0"])).reshape(-1)
    jc = JRegistrationConfig(colored_icp_max_iters=15)
    rj = jicp.colored_icp(scene["src"], i0, scene["mask"], jm, JINTR, init=scene["init"],
                          cfg=jc)
    rt = icp.colored_icp(_t(scene["src"]), _t(i0), _t(scene["mask"]), tm, INTR,
                         init=_t(scene["init"]), cfg=RegistrationConfig(colored_icp_max_iters=15))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=POSE_TOL, rtol=0)
    assert abs(int(rt.inliers) - int(rj.inliers)) <= 0.005 * int(rj.inliers)
    rp = icp.icp_point_to_plane(_t(scene["src"]), _t(scene["mask"]), tm, INTR,
                                init=_t(scene["init"]), cfg=RegistrationConfig(icp_max_iters=15))
    rpj = jicp.icp_point_to_plane(scene["src"], scene["mask"], jm, JINTR, init=scene["init"],
                                  cfg=JRegistrationConfig(icp_max_iters=15))
    np.testing.assert_allclose(rp.T.numpy(), np.asarray(rpj.T), atol=POSE_TOL, rtol=0)


def test_projective_overlap_matches_jax(scene):
    """matched/visible counts within 0.5 % (a point may sit on a rounding
    edge of the projection), rmse to 1e-5."""
    jm, tm = _maps(scene, colored=False)
    for T in (scene["init"], scene["true"], np.eye(4, dtype=np.float32)):
        mj, vj, ej = jicp.projective_overlap(scene["src"], scene["mask"], jm, JINTR, T)
        mt_, vt, et = icp.projective_overlap(_t(scene["src"]), _t(scene["mask"]), tm, INTR, _t(T))
        assert abs(int(mt_) - int(mj)) <= 0.005 * int(mj) + 1
        assert abs(int(vt) - int(vj)) <= 0.005 * int(vj) + 1
        assert abs(float(et) - float(ej)) <= 1e-5
    assert int(mt_) > 1000


def test_icp_keeps_pose_under_tf32_request(scene):
    """The module forms its products in full float32 whatever the caller
    asked for, and restores the caller's setting."""
    _, tm = _maps(scene, colored=False)
    args = (_t(scene["src"]), _t(scene["mask"]), tm, INTR)
    ref = icp.icp_projective(*args, init=_t(scene["init"]), max_iters=5)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = icp.icp_projective(*args, init=_t(scene["init"]), max_iters=5)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got.T, ref.T)
