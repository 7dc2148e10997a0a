"""B1's wrapper checks and the update rule its bound is counted on, on the
CPU: the wrapper refuses what the kernel is not built for before the kernel
library loads, and ``tsdf.volume.update_mask`` (through
``tsdf_kernels.updated_voxels``) counts the voxels one frame updates: the
JAX integrate's moved weights on a fresh volume, more once weights
saturate. The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu.config import TSDFConfig as JTSDFConfig
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.tsdf import volume as jtsdf
from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

torch.set_num_threads(1)

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
    poses = [np.asarray(T, np.float32) for T in orbit_trajectory(2, radius=0.35, angle_span=0.3)]
    return [(T, *(np.asarray(x) for x in cam.render(T))) for T in poses]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything asks for the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(build, "library", refuse)


@pytest.mark.parametrize("R", [4, 12, 20])
def test_wrapper_refuses_an_unsupported_block_resolution(frames, no_library, R):
    """The JAX package's rule (``block_resolution^3`` a multiple of 128, so
    R a multiple of 8), which refuses these three too."""
    T, z, c = frames[0]
    cfg = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=R, block_capacity=4,
                     hash_capacity=16)
    vol = tsdf.create(cfg, "cpu")
    wl = torch.zeros((4, 4), dtype=torch.int32)
    before = build.launches[tk.KERNEL]
    with pytest.raises(ValueError, match=f"block_resolution {R} .* multiple of 128"):
        tk.integrate_worklist_cuda(vol, wl, _t(z), _t(c), _t(T), INTR, cfg)
    with pytest.raises(ValueError, match="multiple of 8"):
        tk.launch_grid(R)
    with pytest.raises(AssertionError, match="multiple of 128"):
        jtsdf.create(JTSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=R,
                                 block_capacity=4, hash_capacity=16))
    assert build.launches[tk.KERNEL] == before


@pytest.mark.parametrize("R", [24, 64])
def test_wrapper_takes_every_multiple_of_8(frames, no_library, R):
    """R = 24 and 64 pass the wrapper's check: on CPU tensors the wrapper
    then refuses the device, not the block resolution."""
    T, z, c = frames[0]
    cfg = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=R, block_capacity=4,
                     hash_capacity=16)
    tk.check_block_resolution(R)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.integrate_worklist_cuda(tsdf.create(cfg, "cpu"), torch.zeros((4, 4), dtype=torch.int32),
                                   _t(z), _t(c), _t(T), INTR, cfg)


def test_plain_integrate_at_r24_matches_jax_by_key(frames):
    """B1's plain version at R = 24 (the run-time-R instance's block
    resolution on the card) against the JAX package's integrate, two frames:
    the same block keys and every voxel equal to the bit."""
    kw = dict(voxel_size=0.01, sdf_trunc=0.04, block_resolution=24, block_capacity=512,
              hash_capacity=2048)
    cfg, jcfg = TSDFConfig(**kw), JTSDFConfig(**kw)
    vt, vj = tsdf.create(cfg, "cpu"), jtsdf.create(jcfg)
    for T, z, c in frames:
        vj = jtsdf.allocate(vj, z, jpixel_rays(JINTR), jnp.asarray(T), jcfg)
        vj = jtsdf.integrate(vj, z, c, jnp.asarray(T), JINTR, jcfg)
        vt = tsdf.allocate(vt, _t(z), RAYS, _t(T), cfg)
        vt = tk.integrate_worklist(vt, _t(z), _t(c), _t(T), INTR, cfg)
    n = int(vt.n_blocks)
    assert 10 < n == int(vj.n_blocks) and not bool(vt.overflow)
    ours = {tuple(k): s for s, k in enumerate(vt.block_coords[:n].tolist())}
    theirs = {tuple(k): s for s, k in enumerate(np.asarray(vj.block_coords)[:n].tolist())}
    assert ours.keys() == theirs.keys()
    a = [getattr(vt, k).numpy() for k in ("tsdf", "weight", "color")]
    b = [np.asarray(getattr(vj, k)) for k in ("tsdf", "weight", "color")]
    for key, s in ours.items():
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[s].reshape(-1), y[theirs[key]].reshape(-1))
    assert int((vt.weight > 0).sum()) > 10_000


def test_wrapper_refuses_cpu_tensors(frames, no_library):
    """A supported R on CPU tensors: ``ValueError``, no launch; the plain
    version is ``integrate_worklist_plain``, which ``integrate_worklist``
    takes for CPU tensors."""
    T, z, c = frames[0]
    vol = tsdf.allocate(tsdf.create(CFG, "cpu"), _t(z), RAYS, _t(T), CFG)
    wl, n_active = tk.build_worklist(vol.block_coords, vol.n_blocks, _t(T), INTR, CFG)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tk.integrate_worklist_cuda(vol, wl, _t(z), _t(c), _t(T), INTR, CFG, n_active)


def test_build_worklist_counts_live_rows_as_int32(frames):
    """``n_active`` is the 0-d int32 tensor the kernel reads on the device."""
    T, z, _ = frames[0]
    vol = tsdf.allocate(tsdf.create(CFG, "cpu"), _t(z), RAYS, _t(T), CFG)
    wl, n_active = tk.build_worklist(vol.block_coords, vol.n_blocks, _t(T), INTR, CFG)
    assert n_active.dtype == torch.int32 and n_active.shape == ()
    n = int(n_active)
    assert 50 < n == int(vol.n_blocks)
    assert (wl[:n, 0] != CFG.block_capacity - 1).all()
    assert (wl[n:, 0] == CFG.block_capacity - 1).all()


def test_update_count_equals_jax_moved_weights_on_a_fresh_volume(frames):
    """On a fresh volume every updated voxel's weight moves 0 -> 1: the
    update rule's count equals the voxels the JAX integrate gave weight,
    and the port's own moved weights."""
    T, z, c = frames[0]
    vj = jtsdf.allocate(jtsdf.create(JCFG), z, jpixel_rays(JINTR), jnp.asarray(T), JCFG)
    vj = jtsdf.integrate(vj, z, c, jnp.asarray(T), JINTR, JCFG)
    jax_moved = int((np.asarray(vj.weight) > 0).sum())
    vol = tsdf.allocate(tsdf.create(CFG, "cpu"), _t(z), RAYS, _t(T), CFG)
    wl, _ = tk.build_worklist(vol.block_coords, vol.n_blocks, _t(T), INTR, CFG)
    n_upd = int(tk.updated_voxels(wl, _t(z), _t(T), INTR, CFG))
    before = vol.weight.clone()
    vol = tk.integrate_worklist(vol, _t(z), _t(c), _t(T), INTR, CFG)
    assert n_upd == jax_moved == int((vol.weight != before).sum()) > 10_000


def test_update_count_exceeds_moved_weights_once_weights_saturate(frames):
    """With ``max_integration_weight=2`` a voxel seen twice is still updated
    (its tsdf and color move) but its weight does not: the update rule
    counts it, the moved weights do not."""
    cfg = TSDFConfig(**KW, max_integration_weight=2.0)
    vol = tsdf.create(cfg, "cpu")
    counts = []
    for T, z, c in (frames[0], frames[0], frames[1]):
        vol = tsdf.allocate(vol, _t(z), RAYS, _t(T), cfg)
        wl, _ = tk.build_worklist(vol.block_coords, vol.n_blocks, _t(T), INTR, cfg)
        n_upd = int(tk.updated_voxels(wl, _t(z), _t(T), INTR, cfg))
        w0, t0 = vol.weight.clone(), vol.tsdf.clone()
        vol = tk.integrate_worklist(vol, _t(z), _t(c), _t(T), INTR, cfg)
        counts.append((n_upd, int((vol.weight != w0).sum())))
        assert (vol.weight <= 2.0).all()
    (u0, m0), (u1, m1), (u2, m2) = counts
    assert u0 == m0 and u1 == m1 == u0  # 0 -> 1, then 1 -> 2 on the same voxels
    assert 0 < m2 < u2  # the second view: saturated voxels update without moving
    assert int((vol.tsdf != t0).sum()) > m2
