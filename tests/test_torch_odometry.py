"""The plain version of the port's odometry kernel against the JAX package:
the Pallas level kernel (interpret mode, as its own tests run it) at a short
schedule, the XLA reference at convergence, identity, ``init`` and the
convergence early exit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu.config import OdometryConfig as JOdometryConfig
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.ops.image import rgb_to_intensity
from azurekinect3dreconstruction_tpu.ops.pallas.odometry_kernels import compute_odometry_tpu
from azurekinect3dreconstruction_tpu.tracking.odometry import compute_odometry
from azurekinect3dreconstruction_tpu_torch.config import OdometryConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.ops.kernels.odometry_kernels import (
    compute_odometry_fast,
)

torch.set_num_threads(1)

INTR = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
JINTR = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)


@pytest.fixture(scope="module")
def pair():
    """The frame pair of tests/test_pallas_odometry.py, as numpy."""
    cam = JCamera(intrinsics=JINTR)
    rng = np.random.RandomState(3)
    xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.02, 0.02, 3)])
    T_motion = np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)))
    z0, c0 = cam.render(np.eye(4, dtype=np.float32))
    z1, c1 = cam.render(np.asarray(T_motion, np.float32))
    arrs = [np.asarray(a) for a in (rgb_to_intensity(c0), z0, rgb_to_intensity(c1), z1)]
    return arrs, np.linalg.inv(T_motion)


def _port(arrs, cfg, init=None):
    t = [torch.from_numpy(np.array(a)) for a in arrs]
    init = None if init is None else torch.from_numpy(np.array(init, np.float32))
    return compute_odometry_fast(*t, INTR, cfg, init=init)


def _err(T_est, T_true):
    d = np.asarray(jse3.se3_log(jnp.asarray(
        np.linalg.inv(T_true) @ np.asarray(T_est), jnp.float32)))
    return np.linalg.norm(d[:3]), np.linalg.norm(d[3:])


def test_plain_matches_pallas_kernel(pair):
    """Same GN path as the Pallas kernel (source-gradient swap, same gates,
    same solve): pose <= 1e-4, fitness <= 1e-3 after a (2,2,2) schedule."""
    arrs, _ = pair
    res_j = compute_odometry_tpu(*arrs, JINTR, JOdometryConfig(pyramid_iters=(2, 2, 2)),
                                 interpret=True)
    res_t = _port(arrs, OdometryConfig(pyramid_iters=(2, 2, 2)))
    np.testing.assert_allclose(res_t.T_target_source.numpy(),
                               np.asarray(res_j.T_target_source), atol=1e-4)
    assert abs(float(res_t.fitness) - float(res_j.fitness)) <= 1e-3
    assert abs(float(res_t.rmse) - float(res_j.rmse)) <= 1e-3
    assert abs(int(res_t.inliers) - int(res_j.inliers)) <= 0.001 * int(res_j.inliers)


def test_plain_converges_like_reference(pair):
    """The bounds of tests/test_pallas_odometry.py against the XLA reference."""
    arrs, T_true = pair
    ref = compute_odometry(*arrs, JINTR, JOdometryConfig(pyramid_iters=(8, 8, 8)))
    res = _port(arrs, OdometryConfig(pyramid_iters=(8, 8, 8)))
    t_ref, r_ref = _err(ref.T_target_source, T_true)
    t_port, r_port = _err(res.T_target_source.numpy(), T_true)
    assert t_port < max(2.0 * t_ref, 5e-3), (t_port, t_ref)
    assert r_port < max(2.0 * r_ref, 3e-3), (r_port, r_ref)
    assert abs(float(res.fitness) - float(ref.fitness)) < 0.1


def test_plain_identity(pair):
    (i0, z0, _, _), _ = pair
    res = _port([i0, z0, i0, z0], OdometryConfig(pyramid_iters=(8, 8, 8)))
    t, r = _err(res.T_target_source.numpy(), np.eye(4))
    assert t < 1e-4 and r < 1e-4
    assert float(res.fitness) > 0.95


def test_plain_respects_init(pair):
    arrs, T_true = pair
    init = np.asarray(jse3.se3_exp(jnp.asarray(
        np.asarray(jse3.se3_log(jnp.asarray(T_true, jnp.float32))) * 0.7, jnp.float32)))
    res = _port(arrs, OdometryConfig(pyramid_iters=(6, 4, 2)), init=init)
    t, r = _err(res.T_target_source.numpy(), T_true)
    assert t < 6e-3 and r < 4e-3


def test_convergence_early_exit_matches_iteration_cap(pair):
    """A huge tolerance stops each level after one applied step: the same
    pose and fitness as a (1,1,1) schedule with the exit disabled."""
    arrs, _ = pair
    cfg = OdometryConfig(pyramid_iters=(8, 8, 8))
    r_one = _port(arrs, dataclasses.replace(cfg, pyramid_iters=(1, 1, 1)))
    r_early = _port(arrs, dataclasses.replace(cfg, convergence_delta=1e9))
    np.testing.assert_allclose(r_early.T_target_source.numpy(), r_one.T_target_source.numpy(),
                               atol=1e-6)
    assert abs(float(r_early.fitness) - float(r_one.fitness)) <= 1e-6


def test_color_term_matches_pallas_kernel(pair):
    """The term switch: photometric rows only."""
    arrs, _ = pair
    res_j = compute_odometry_tpu(*arrs, JINTR,
                                 JOdometryConfig(pyramid_iters=(1, 1, 1), term="color"),
                                 interpret=True)
    res_t = _port(arrs, OdometryConfig(pyramid_iters=(1, 1, 1), term="color"))
    np.testing.assert_allclose(res_t.T_target_source.numpy(),
                               np.asarray(res_j.T_target_source), atol=1e-4)
