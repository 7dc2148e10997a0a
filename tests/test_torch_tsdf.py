"""The port's TSDF volume against the JAX package: allocation, the plain
version of the integrate kernel (``tsdf.volume.integrate`` and the worklist
integrate on CPU tensors) and the frustum cull.

Hash slots may differ between the packages (colliding scatters pick another
winner), so voxels are compared by block key; one case loads the same state
into both through ``interop`` and compares slot by slot."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu.config import TSDFConfig as JTSDFConfig
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import (
    build_worklist,
    integrate_worklist,
)
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

torch.set_num_threads(1)

# the CFG of tests/test_pallas_integrate.py
KW = dict(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=2048,
          hash_capacity=8192)
CFG, JCFG = TSDFConfig(**KW), JTSDFConfig(**KW)
INTR = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
JINTR = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)
RAYS = pixel_rays(INTR, "cpu")


@pytest.fixture(scope="module")
def frames():
    """Frames rendered once (by the JAX renderer) and fed to both packages."""
    cam = JCamera(intrinsics=JINTR)
    poses = [np.eye(4, dtype=np.float32)] + [
        np.asarray(T, np.float32) for T in orbit_trajectory(3, radius=0.35, angle_span=1.2)]
    return [(T, *(np.asarray(x) for x in cam.render(T))) for T in poses]


def _t(a):
    return torch.from_numpy(np.array(a))


def _by_key(vol_np):
    """{block key: (tsdf, weight, color)} of the allocated blocks."""
    n = int(vol_np["n_blocks"])
    out = {}
    for s in range(n):
        k = tuple(vol_np["block_coords"][s])
        out[k] = (vol_np["tsdf"][s].reshape(-1), vol_np["weight"][s].reshape(-1),
                  vol_np["color"][s].reshape(3, -1))
    return out


def _jax_np(vol):
    return {k: np.asarray(v) for k, v in vol._asdict().items()}


def _compare_by_key(vt, vj):
    """Same block key set; per block, tsdf, weight and color equal to the
    bit (the port rounds as the reference's compiled integrate does)."""
    a, b = _by_key(interop.volume_to_numpy(vt)), _by_key(_jax_np(vj))
    assert a.keys() == b.keys()
    assert len(a) > 50
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)


def _run_both(frames, use_worklist):
    vt, vj = tsdf.create(CFG, "cpu"), jtsdf.create(JCFG)
    jrays = jpixel_rays(JINTR)
    for T, z, c in frames:
        vj = jtsdf.allocate(vj, z, jrays, jnp.asarray(T), JCFG)
        vj = jtsdf.integrate(vj, z, c, jnp.asarray(T), JINTR, JCFG)
        vt = tsdf.allocate(vt, _t(z), RAYS, _t(T), CFG)
        if use_worklist:
            vt = integrate_worklist(vt, _t(z), _t(c), _t(T), INTR, CFG)
        else:
            vt = tsdf.integrate(vt, _t(z), _t(c), _t(T), INTR, CFG)
        assert int(vt.n_blocks) == int(vj.n_blocks)
        assert bool(vt.overflow) == bool(vj.overflow)
    return vt, vj


@pytest.mark.parametrize("use_worklist", [False, True], ids=["integrate", "worklist"])
def test_single_frame_matches_jax_by_key(frames, use_worklist):
    _compare_by_key(*_run_both(frames[:1], use_worklist))


@pytest.mark.parametrize("use_worklist", [False, True], ids=["integrate", "worklist"])
def test_orbit_matches_jax_by_key(frames, use_worklist):
    _compare_by_key(*_run_both(frames[1:], use_worklist))


def test_worklist_integrate_slot_by_slot_from_shared_state(frames):
    """Load the JAX volume after two frames into the port, integrate the
    third frame in both, compare every pool row."""
    vj = jtsdf.create(JCFG)
    jrays = jpixel_rays(JINTR)
    for T, z, c in frames[1:3]:
        vj = jtsdf.allocate(vj, z, jrays, jnp.asarray(T), JCFG)
        vj = jtsdf.integrate(vj, z, c, jnp.asarray(T), JINTR, JCFG)
    T, z, c = frames[3]
    vj = jtsdf.allocate(vj, z, jrays, jnp.asarray(T), JCFG)
    vt = interop.volume_from_jax_arrays(_jax_np(vj), "cpu")
    np.testing.assert_array_equal(interop.volume_to_numpy(vt)["tsdf"], np.asarray(vj.tsdf))
    vj = jtsdf.integrate(vj, z, c, jnp.asarray(T), JINTR, JCFG)
    vt = integrate_worklist(vt, _t(z), _t(c), _t(T), INTR, CFG, worklist_size=1024)
    back = interop.volume_to_numpy(vt)
    ref = _jax_np(vj)
    trash = CFG.block_capacity - 1
    for k in ("table_keys", "table_vals", "n_blocks", "block_coords", "overflow"):
        np.testing.assert_array_equal(back[k], ref[k])
    for k in ("weight", "tsdf", "color"):
        np.testing.assert_array_equal(back[k][:trash], ref[k][:trash])


def test_worklist_overflow_sets_the_sticky_flag(frames):
    T, z, c = frames[0]
    vol = tsdf.allocate(tsdf.create(CFG, "cpu"), _t(z), RAYS, _t(T), CFG)
    assert int(vol.n_blocks) > 16
    vol = integrate_worklist(vol, _t(z), _t(c), _t(T), INTR, CFG, worklist_size=16)
    assert bool(vol.overflow)


def test_worklist_culls_out_of_view_blocks(frames):
    T, z, _ = frames[0]
    vol = tsdf.allocate(tsdf.create(CFG, "cpu"), _t(z), RAYS, _t(T), CFG)
    n = int(vol.n_blocks)
    # looking straight at the scene: every allocated block is visible
    wl, n_active = build_worklist(vol.block_coords, vol.n_blocks, _t(T), INTR, CFG)
    assert int(n_active) == n
    assert sorted(wl[:n, 0].tolist()) == list(range(n))
    np.testing.assert_array_equal(wl[:n, 1:].numpy(), vol.block_coords[wl[:n, 0].long()].numpy())
    # camera turned 180 degrees: nothing visible, all rows padded with the trash slot
    T_back = se3.se3_exp(torch.tensor([0, 0, 0, 0.0, np.pi, 0.0]))
    wl, n_active = build_worklist(vol.block_coords, vol.n_blocks, T_back, INTR, CFG)
    assert int(n_active) == 0
    assert (wl[:, 0] == CFG.block_capacity - 1).all()


def test_cull_matches_jax_active_set(frames):
    """The port's worklist holds exactly the JAX worklist's visible slots."""
    from azurekinect3dreconstruction_tpu.ops.pallas.tsdf_kernels import (
        build_worklist as jbuild_worklist,
    )

    vj = jtsdf.create(JCFG)
    jrays = jpixel_rays(JINTR)
    for T, z, _ in frames[1:]:
        vj = jtsdf.allocate(vj, z, jrays, jnp.asarray(T), JCFG)
    vt = interop.volume_from_jax_arrays(_jax_np(vj), "cpu")
    T_view = np.asarray(jse3.se3_exp(jnp.asarray([0.05, 0, 0, 0, 0.4, 0.0])), np.float32)
    meta, na_j = jbuild_worklist(vj.block_coords, vj.n_blocks, jnp.asarray(T_view), JINTR, JCFG)
    wl, na_t = build_worklist(vt.block_coords, vt.n_blocks, _t(T_view), INTR, CFG)
    assert 0 < int(na_t) == int(na_j) < int(vj.n_blocks)
    np.testing.assert_array_equal(wl[:, 0].numpy(), np.asarray(meta[0]))
    np.testing.assert_array_equal(wl[:, 1:].numpy().T, np.asarray(meta[1:4]))


def test_extract_point_cloud_and_memory(frames):
    T, z, c = frames[0]
    vol = tsdf.integrate_frame(tsdf.create(CFG, "cpu"), _t(z), _t(c), RAYS, _t(T), INTR, CFG)
    pts, cols = tsdf.extract_point_cloud(vol, CFG)
    assert pts.shape[0] > 1000 and pts.shape == cols.shape
    # surface points lie near the rendered depth: back-project and compare z
    assert np.isfinite(pts).all() and (pts[:, 2] > 0.5).all() and (pts[:, 2] < 2.7).all()
    assert tsdf.memory_bytes(CFG) == jtsdf.memory_bytes(JCFG)
    assert tsdf.extract_point_cloud(vol, CFG, max_points=100)[0].shape == (100, 3)
