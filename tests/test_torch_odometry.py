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
from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid
from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
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


def test_plain_matches_pallas_kernel_at_five_levels(pair):
    """A 5-level pyramid (the kernel takes up to 16): the plain version
    against the Pallas kernel at a (2, 2, 2, 2, 2) schedule, at the bounds
    of the 3-level case, and ``pack_levels`` takes the 5 levels."""
    arrs, _ = pair
    cfg = OdometryConfig(pyramid_iters=(2,) * 5)
    res_j = compute_odometry_tpu(*arrs, JINTR, JOdometryConfig(pyramid_iters=(2,) * 5),
                                 interpret=True)
    res_t = _port(arrs, cfg)
    np.testing.assert_allclose(res_t.T_target_source.numpy(),
                               np.asarray(res_j.T_target_source), atol=1e-4)
    assert abs(float(res_t.fitness) - float(res_j.fitness)) <= 1e-3
    assert abs(float(res_t.rmse) - float(res_j.rmse)) <= 1e-3
    assert abs(int(res_t.inliers) - int(res_j.inliers)) <= 0.001 * int(res_j.inliers)
    pyr_s, pyr_t = _pyramids(arrs, 5)
    _, dims, _ = odo.pack_levels(pyr_s, pyr_t, INTR, cfg, torch.device("cpu"))
    assert dims[-3:] == [INTR.height >> 4, INTR.width >> 4, 2]


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


def _pyramids(arrs, levels):
    t = [torch.from_numpy(np.array(a)) for a in arrs]
    return build_pyramid(t[0], t[1], levels), build_pyramid(t[2], t[3], levels)


def _per_level_route(arrs, cfg, init):
    """The route of the per-level runner: level_inputs + level_plain per
    level, coarse to fine, on one state vector."""
    levels = len(cfg.pyramid_iters)
    pyr_s, pyr_t = _pyramids(arrs, levels)
    state = torch.zeros(odo.STATE)
    state[:12] = torch.from_numpy(np.array(init, np.float32))[:3].reshape(-1)
    for lvl in reversed(range(levels)):
        src, tgt = odo.level_inputs(*pyr_s[lvl], *pyr_t[lvl])
        state[12] = 0.0
        odo.level_plain(state, src, tgt, INTR.scaled(1.0 / (1 << lvl)), cfg,
                        cfg.pyramid_iters[lvl], 1.0, 1.0)
    return state


@pytest.mark.parametrize("iters", [(2, 2, 2), (1, 0, 3)])
def test_pyramid_plain_equals_per_level_route(pair, iters):
    """The whole-pyramid plain runner is the per-level route, to the bit."""
    arrs, _ = pair
    cfg = OdometryConfig(pyramid_iters=iters)
    init = np.eye(4)
    init[:3, 3] = [0.004, -0.003, 0.002]
    want = _per_level_route(arrs, cfg, init)
    t = [torch.from_numpy(np.array(a)) for a in arrs]
    got = odo.odometry_pyramid(odo.pyramid_plain, *t, INTR, cfg,
                               init=torch.from_numpy(init.astype(np.float32)))
    assert torch.equal(got.T_target_source[:3].reshape(-1), want[:12])
    assert torch.equal(got.fitness, want[13]) and torch.equal(got.rmse, want[14])
    assert int(got.inliers) == int(want[15])


def test_zero_iteration_levels_pass_the_pose_through(pair):
    """A level with no iterations leaves the pose as it found it: all-zero
    levels return ``init`` to the bit, and empty coarse levels in front of
    level 0 change nothing against a one-level pyramid."""
    arrs, T_true = pair
    init = np.asarray(jse3.se3_exp(jnp.asarray(
        np.asarray(jse3.se3_log(jnp.asarray(T_true, jnp.float32))) * 0.5, jnp.float32)))
    init_t = torch.from_numpy(np.array(init, np.float32))
    res = _port(arrs, OdometryConfig(pyramid_iters=(0, 0, 0)), init=init)
    assert torch.equal(res.T_target_source, init_t)
    assert float(res.fitness) == 0.0 and int(res.inliers) == 0
    padded = _port(arrs, OdometryConfig(pyramid_iters=(2, 0, 0)), init=init)
    alone = _port(arrs, OdometryConfig(pyramid_iters=(2,)), init=init)
    assert torch.equal(padded.T_target_source, alone.T_target_source)
    assert torch.equal(padded.fitness, alone.fitness)
    assert not torch.equal(padded.T_target_source, init_t)


def test_pack_levels_order(pair):
    """The kernel's per-level arguments: plane pointers [I_s, D_s, I_t, D_t],
    [H, W, iterations] and the scaled [fx, fy, cx, cy], finest level first."""
    arrs, _ = pair
    cfg = OdometryConfig(pyramid_iters=(4, 3, 2))
    pyr_s, pyr_t = _pyramids(arrs, 3)
    ptrs, dims, intr = odo.pack_levels(pyr_s, pyr_t, INTR, cfg, torch.device("cpu"))
    assert ptrs == [t.data_ptr() for lvl in range(3) for t in (*pyr_s[lvl], *pyr_t[lvl])]
    assert dims == [144, 160, 4, 72, 80, 3, 36, 40, 2]
    for lvl in range(3):
        li = INTR.scaled(1.0 / (1 << lvl))
        assert intr[4 * lvl:4 * lvl + 4] == [li.fx, li.fy, li.cx, li.cy]


def _bad_inputs(arrs):
    """(state, pyr_s, pyr_t, cfg, message) cases pyramid_cuda must refuse."""
    cfg = OdometryConfig(pyramid_iters=(1, 1, 1))
    pyr_s, pyr_t = _pyramids(arrs, 3)
    state = torch.zeros(odo.STATE)
    wrong_shape = list(pyr_s)
    wrong_shape[1] = (pyr_s[1][0], torch.zeros((72, 81)))
    wrong_dtype = list(pyr_t)
    wrong_dtype[0] = (pyr_t[0][0].double(), pyr_t[0][1])
    strided = list(pyr_s)
    strided[2] = (pyr_s[2][0], torch.zeros((40, 36)).t())
    # pack_levels checks the configured count before the pyramids' depth
    seventeen = OdometryConfig(pyramid_iters=(1,) * 17)
    deep_s, deep_t = _pyramids(arrs, 5)
    return {
        "cpu": (state, pyr_s, pyr_t, cfg, "needs CUDA tensors"),
        "shape": (state, wrong_shape, pyr_t, cfg, "level 1 source depth"),
        "dtype": (state, pyr_s, wrong_dtype, cfg, "level 0 target intensity"),
        "contiguity": (state, strided, pyr_t, cfg, "non-contiguous"),
        "levels": (state, deep_s, deep_t, seventeen, "17 pyramid levels"),
        "depth": (state, pyr_s[:2], pyr_t[:2], cfg, "pyramids of 2 and 2"),
        "state": (torch.zeros(12), pyr_s, pyr_t, cfg, "state"),
    }


@pytest.mark.parametrize("case", ["cpu", "shape", "dtype", "contiguity", "levels", "depth",
                                  "state"])
def test_pyramid_cuda_refuses_before_building(pair, monkeypatch, case):
    """pyramid_cuda checks every level before it builds or launches: CPU
    tensors, a wrong shape, dtype, stride, level count or pyramid depth, or
    a wrong state vector raise ``ValueError`` and launch nothing."""
    arrs, _ = pair

    def no_build():
        raise AssertionError("built the kernels before checking the inputs")

    monkeypatch.setattr(build, "library", no_build)
    state, pyr_s, pyr_t, cfg, msg = _bad_inputs(arrs)[case]
    before = build.launches[odo.KERNEL]
    with pytest.raises(ValueError, match=msg):
        odo.pyramid_cuda(state, pyr_s, pyr_t, INTR, cfg, 1.0, 1.0)
    assert build.launches[odo.KERNEL] == before


# an H100's grid and band (132 CTAs; 930,072 / 132 = 7,046 pixels of 8 planes a CTA), the
# large route's resident pixels (2 x band: 4 planes of each) and shorthands for the plan
H100_GRID, H100_BAND = 132, 7046
RESIDENT = 2 * H100_BAND
S = odo.SHARED


@pytest.mark.parametrize("dims, routes", [
    ([576, 640, 20, 288, 320, 10, 144, 160, 5], [S, S, S]),  # NFOV unbinned
    ([1024, 1024, 20, 512, 512, 10, 256, 256, 5], [7944, S, S]),  # WFOV unbinned
    ([1024, 1024, 0, 512, 512, 10, 256, 256, 5], [S, S, S]),  # level 0 not iterated
    ([1080, 1920, 20, 540, 960, 10, 270, 480, 5], [RESIDENT, S, S]),  # k4arecorder's 1080p
    ([2160, 3840, 20, 1080, 1920, 10, 540, 960, 5], [RESIDENT, RESIDENT, S]),  # RES_2160P
], ids=["nfov", "wfov", "wfov-level0-idle", "1080p", "2160p"])
def test_check_band_refuses_a_level_over_the_shared_memory(dims, routes):
    """The per-level plan at an H100's grid and band: a level whose band
    fits the shared memory takes the shared route, each larger one the
    large-frame route with as many band pixels resident as 4 gradient
    planes fit (all 7,944 at 1024x1024, 14,092 of 15,710 at 1080p and of
    2160p's 62,837), so levels 1 and 2 of 1080p and WFOV go back to shared
    memory. No route
    sizes a scratch: every iterated level's planes fit one CTA's shared
    memory."""
    assert odo.level_routes(dims, H100_GRID, H100_BAND) == routes
    assert not hasattr(odo, "scratch_floats")
    for lvl, r in enumerate(routes):
        if dims[3 * lvl + 2] <= 0:
            continue  # skipped: no planes
        band_px = -(-dims[3 * lvl] * dims[3 * lvl + 1] // H100_GRID)
        floats = band_px * odo.PLANES if r == S else r * odo.RESIDENT_PLANES
        assert floats <= H100_BAND * odo.PLANES


def test_level_routes_resident_pixels_and_refused():
    """``resident_pixels``, the large route's resident count the plan
    gives an oversized level and the checks clip to force the route: a
    whole band where its gradients fit (640x576's levels, 1024x1024), else
    what 4 planes of the shared route's band fit (1080p). A level past
    ``MAX_PIXELS`` has no route and raises, iterated or not, as the kernel
    refuses it either way."""
    levels = [(576, 640), (288, 320), (144, 160), (1024, 1024), (1080, 1920)]
    assert [odo.resident_pixels(H, W, H100_GRID, H100_BAND) for H, W in levels] == [
        2793, 699, 175, 7944, RESIDENT]
    huge = [4097, 4096, 20, 2048, 2048, 10]
    for iters in (20, 0):
        with pytest.raises(ValueError, match="over the"):
            odo.level_routes([4097, 4096, iters] + huge[3:], H100_GRID, H100_BAND)
    assert odo.level_routes([4096, 4096, 20] + huge[3:], H100_GRID, H100_BAND) == [RESIDENT,
                                                                                   RESIDENT]


def test_color_term_matches_pallas_kernel(pair):
    """The term switch: photometric rows only."""
    arrs, _ = pair
    res_j = compute_odometry_tpu(*arrs, JINTR,
                                 JOdometryConfig(pyramid_iters=(1, 1, 1), term="color"),
                                 interpret=True)
    res_t = _port(arrs, OdometryConfig(pyramid_iters=(1, 1, 1), term="color"))
    np.testing.assert_allclose(res_t.T_target_source.numpy(),
                               np.asarray(res_j.T_target_source), atol=1e-4)
