"""The port's sharded volume (``parallel/sharded_volume.py``) against the
JAX package's, and the mirrors of tests/test_sharded_volume.py.

The port runs on a ``["cpu"] * 8`` grid of one process; JAX on its 8
virtual CPU devices with ``backend="xla"`` (the dense psum update), and
with ``backend="pallas"`` in interpret mode where its odometry is compared
(the port's follows the Pallas kernel's path). Quarter resolution, the 2 cm configuration of
tests/test_sharded_volume.py. Slot order differs between the two packages'
hashes, so volumes are compared by block key. Each tolerance is stated
where it is used."""

import dataclasses
import logging
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu import config as jcfg
from azurekinect3dreconstruction_tpu.core import camera as jcamera
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory
from azurekinect3dreconstruction_tpu.ops.image import rgb_to_intensity as jrgb_to_intensity
from azurekinect3dreconstruction_tpu.parallel import sharded_volume as jsv
from azurekinect3dreconstruction_tpu.tsdf import hash as jhash
from azurekinect3dreconstruction_tpu.tsdf import marching_cubes as jmc
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
from azurekinect3dreconstruction_tpu_torch.ops.kernels.odometry_kernels import (
    compute_odometry_fast,
)
from azurekinect3dreconstruction_tpu_torch.ops.kernels.tsdf_kernels import integrate_worklist
from azurekinect3dreconstruction_tpu_torch.parallel import sharded_volume as sv
from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import DualCameraFusion
from azurekinect3dreconstruction_tpu_torch.tsdf import hash as vhash
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

torch.set_num_threads(2)

# tests/test_sharded_volume.py's configuration
JCFG = jcfg.TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                       block_capacity=1024, hash_capacity=4096)
JPCFG = jcfg.PipelineConfig(tsdf=JCFG)
PCFG = interop.pipeline_config_from(JPCFG)
CFG = PCFG.tsdf
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def intr(synthetic_camera):
    return interop.intrinsics_from(synthetic_camera.intrinsics)


@pytest.fixture(scope="module")
def orbit(synthetic_camera):
    """tests/test_sharded_volume.py's two orbit frames, as numpy."""
    poses = orbit_trajectory(2, radius=0.3, angle_span=0.6)
    frames = [synthetic_camera.render(np.asarray(T, np.float32)) for T in poses]
    return (np.stack([np.asarray(f[0]) for f in frames]),
            np.stack([np.asarray(f[1]) for f in frames]),
            np.stack([np.asarray(T, np.float32) for T in poses]))


@pytest.fixture(scope="module")
def jax_orbit_step(synthetic_camera, orbit):
    """JAX's sharded step on its 2 x 4 mesh over the two orbit frames, as
    numpy fields in the sharded layout."""
    depths, colors, poses = orbit
    step = jsv.make_sharded_step(jsv.make_mesh(2, 4), synthetic_camera.intrinsics, JCFG,
                                 stride=2, backend="xla")
    vol = step(jsv.create_sharded(JCFG, jsv.make_mesh(2, 4)), jnp.asarray(depths),
               jnp.asarray(colors), jnp.asarray(poses), jcamera.pixel_rays(
                   synthetic_camera.intrinsics))
    return {k: np.asarray(v) for k, v in vol._asdict().items()}


def _port_step(intr, depths, colors, poses, n_cam=2, n_blk=4, stride=2, **kw):
    mesh = sv.make_mesh(n_cam, n_blk, CPU8)
    t = torch.from_numpy
    return sv.make_sharded_step(mesh, intr, CFG, stride=stride, **kw)(
        sv.create_sharded(CFG, mesh), t(depths), t(colors), t(poses), pixel_rays(intr, "cpu"))


@pytest.fixture(scope="module")
def port_orbit_step(intr, orbit):
    return _port_step(intr, *orbit)


def _keyed(arrays, n_blocks, offset=0):
    """{block key: row} of one volume's alive rows (numpy fields, JAX layout)."""
    return {tuple(arrays["block_coords"][offset + s]): offset + s for s in range(int(n_blocks))}


def _shard_keys(arrays, b):
    cap = CFG.block_capacity
    return _keyed(arrays, arrays["n_blocks"][b], b * cap)


def _rows(arrays, keyed, keys, field):
    return np.stack([arrays[field][keyed[k]].reshape(-1) for k in keys])


def test_owner_equals_jax_to_the_bit():
    """``owner`` on 100k seeded int32 keys, ``EMPTY_KEY`` among them, for
    1 to 4 shards: JAX's ``_owner`` to the bit."""
    keys = np.random.RandomState(0).randint(-2 ** 31, 2 ** 31 - 1, 100_000, dtype=np.int64)
    keys = keys.astype(np.int32)
    keys[::97] = jhash.EMPTY_KEY
    for n in (1, 2, 3, 4):
        want = np.asarray(jsv._owner(jnp.asarray(keys), n))
        got = sv.owner(torch.from_numpy(keys), n).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) == set(range(n))


def test_sharded_step_matches_jax_by_key(jax_orbit_step, port_orbit_step):
    """Per shard the same block keys; tsdf, weight and color by key within
    1e-5 (JAX's xla body is the dense psum update, which its own test holds
    to sequential integration at 1e-5); the same overflow flags."""
    want = jax_orbit_step
    got = interop.sharded_volume_to_numpy(port_orbit_step)
    np.testing.assert_array_equal(got["n_blocks"], want["n_blocks"])
    np.testing.assert_array_equal(got["overflow"], want["overflow"])
    assert not want["overflow"].any() and (want["n_blocks"] > 0).all()
    for b in range(4):
        kg, kw = _shard_keys(got, b), _shard_keys(want, b)
        assert kg.keys() == kw.keys()
        keys = sorted(kg)
        for f in ("tsdf", "weight", "color"):
            np.testing.assert_allclose(_rows(got, kg, keys, f), _rows(want, kw, keys, f),
                                       rtol=0, atol=1e-5, err_msg=f"shard {b} {f}")


def _single_volume(intr, depths, colors, poses, stride=2):
    """The port's own single volume: allocate every camera, then the
    worklist integrate of every camera, in cam order."""
    rays = pixel_rays(intr, "cpu")
    vol = tsdf.create(CFG, "cpu")
    t = torch.from_numpy
    for d, T in zip(depths, poses):
        vol = tsdf.allocate(vol, t(d), rays, t(T), CFG, stride=stride, dedup_budget=2048)
    for d, c, T in zip(depths, colors, poses):
        vol = integrate_worklist(vol, t(d), t(c), t(T), intr, CFG)
    return vol


def test_sharded_step_equals_single_volume_to_the_bit(intr, orbit, port_orbit_step):
    """Sequential integration in the same order: the union of the shards
    holds the single volume's keys, and every voxel equals it to the bit."""
    single = interop.volume_to_numpy(_single_volume(intr, *orbit))
    got = interop.sharded_volume_to_numpy(port_orbit_step)
    ks = _keyed(single, single["n_blocks"])
    kg = {}
    for b in range(4):
        kg.update(_shard_keys(got, b))
    assert kg.keys() == ks.keys() and len(ks) > 50
    keys = sorted(ks)
    for f in ("tsdf", "weight", "color"):
        np.testing.assert_array_equal(_rows(got, kg, keys, f), _rows(single, ks, keys, f),
                                      err_msg=f)


def test_sharded_blocks_are_disjoint(intr, synthetic_camera):
    """tests/test_sharded_volume.py:81: no block is owned by two shards."""
    z, c = (np.asarray(a) for a in synthetic_camera.render(np.eye(4, dtype=np.float32)))
    vol = _port_step(intr, np.stack([z, z]), np.stack([c, c]),
                     np.stack([np.eye(4, dtype=np.float32)] * 2))
    seen = set()
    for s in range(4):
        sub = sv.gather_volume(vol, CFG, s, 4)
        coords = {tuple(x) for x in sub.block_coords[:int(sub.n_blocks)].tolist()}
        assert coords and not (coords & seen), "block owned by two shards"
        assert (sv.owner(vhash.pack_key(sub.block_coords[:int(sub.n_blocks)]), 4) == s).all()
        seen |= coords


def _centroids(m):
    v = np.asarray(m.vertices)[: 3 * int(m.num_triangles)]
    return {tuple(x) for x in np.round(v.reshape(-1, 3, 3).mean(1), 4).tolist()}


def _assert_meshes_match(m_a, m_b):
    """tests/test_sharded_volume.py's bounds: triangle counts within
    max(2, n // 1000) and > 0.999 of the rounded centroids shared."""
    na, nb = int(m_a.num_triangles), int(m_b.num_triangles)
    assert nb > 500
    assert abs(na - nb) <= max(2, nb // 1000), (na, nb)
    ca, cb = _centroids(m_a), _centroids(m_b)
    overlap = len(ca & cb) / max(len(cb), 1)
    assert overlap > 0.999, f"only {overlap:.4f} of triangles match"


def test_combine_shards_extraction_matches_single_volume(intr, orbit, port_orbit_step):
    """tests/test_sharded_volume.py:99-143: the combined shards triangulate
    the shard-boundary cells as the single volume does."""
    combined = sv.combine_shards(port_orbit_step, CFG, 4)
    single = _single_volume(intr, *orbit)
    assert int(combined.n_blocks) == int(single.n_blocks)
    assert combined.tsdf.shape[0] == 4 * CFG.block_capacity
    _assert_meshes_match(mc.extract_mesh(combined, CFG, max_cells=262144, max_tris=262144),
                         mc.extract_mesh(single, CFG, max_cells=262144, max_tris=262144))


def test_combine_shards_matches_jax_from_one_pool(jax_orbit_step):
    """JAX's sharded pool carried across (``interop.
    sharded_volume_from_jax_arrays``): ``combine_shards`` + ``extract_mesh``
    in both packages give the same rounded-centroid set."""
    jvol = jsv.TSDFVolume(**{k: jnp.asarray(v) for k, v in jax_orbit_step.items()})
    want = jmc.extract_mesh(jsv.combine_shards(jvol, JCFG, 4), JCFG, max_cells=262144,
                            max_tris=262144)
    vol = interop.sharded_volume_from_jax_arrays(jax_orbit_step, sv.make_mesh(2, 4, CPU8))
    back = interop.sharded_volume_to_numpy(vol)
    for k, v in jax_orbit_step.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    got = mc.extract_mesh(sv.combine_shards(vol, CFG, 4), CFG, max_cells=262144,
                          max_tris=262144)
    assert int(got.num_triangles) == int(want.num_triangles) > 500
    assert _centroids(got) == _centroids(want)


def _rig_streams(synthetic_camera, n_mounts, span):
    """tests/test_sharded_volume.py's rigs: ``n_mounts`` mounts each seeing
    3 frames of motion; (T0, intensities, depths, colors) as numpy."""
    mounts = orbit_trajectory(n_mounts, radius=0.25, angle_span=span)
    motion = orbit_trajectory(3, radius=0.05, angle_span=0.12)
    ints, deps, cols = [], [], []
    for mount in mounts:
        zs = [synthetic_camera.render(np.asarray(mount @ m, np.float32)) for m in motion]
        ints.append(np.stack([np.asarray(jrgb_to_intensity(c)) for _, c in zs]))
        deps.append(np.stack([np.asarray(z) for z, _ in zs]))
        cols.append(np.stack([np.asarray(c) for _, c in zs]))
    return (np.stack([np.asarray(m, np.float32) for m in mounts]), np.stack(ints),
            np.stack(deps), np.stack(cols))


def _port_slam(intr, streams, n_cam, n_blk):
    mesh = sv.make_mesh(n_cam, n_blk, CPU8)
    batch = sv.make_sharded_slam_batch(mesh, intr, PCFG, stride=2)
    T0, ints, deps, cols = (torch.from_numpy(a) for a in streams)
    return batch(sv.create_sharded(CFG, mesh), T0, ints, deps, cols, pixel_rays(intr, "cpu"))


@pytest.fixture(scope="module")
def two_mounts(synthetic_camera):
    return _rig_streams(synthetic_camera, 2, 0.5)


@pytest.fixture(scope="module")
def port_slam(intr, two_mounts):
    return _port_slam(intr, two_mounts, 2, 4)


def test_slam_batch_tracks_like_the_odometry_chain(intr, two_mounts, port_slam):
    """tests/test_sharded_volume.py:146-200 against the port's own chain:
    every fit > 0.3 and each pose within 1e-4 (se3 log) of
    ``compute_odometry_fast`` chained from the mount; blocks allocated."""
    T0, ints, deps, _ = two_mounts
    vol, poses, fits = port_slam
    assert poses.shape == (2, 2, 4, 4) and fits.shape == (2, 2)
    assert (fits > 0.3).all(), fits
    t = torch.from_numpy
    for c in range(2):
        T = T0[c].astype(np.float64)
        for f in range(1, 3):
            res = compute_odometry_fast(t(ints[c, f - 1]), t(deps[c, f - 1]), t(ints[c, f]),
                                        t(deps[c, f]), intr, PCFG.odometry)
            T = T @ np.linalg.inv(res.T_target_source.numpy().astype(np.float64))
            d = se3.se3_log(torch.as_tensor(np.linalg.inv(T) @ poses[c, f - 1].numpy(),
                                            dtype=torch.float32)).numpy()
            assert np.linalg.norm(d) < 1e-4, (c, f, d)
    assert int(vol.n_blocks.sum()) > 50


def test_slam_batch_matches_jax(intr, synthetic_camera, two_mounts):
    """JAX's ``make_sharded_slam_batch`` with ``backend="pallas"`` in
    interpret mode (as its own test of the forced Pallas step runs it), on
    a 2 x 1 mesh (JAX runs the odometry and the fusion once on every mesh
    device, so a wider mesh only repeats the interpreter's work): the
    port's odometry follows the Pallas level kernel's Gauss-Newton path
    (``test_torch_odometry.py``), which JAX's ``backend="xla"`` replaces
    with another solver, some 1e-3 apart. Poses within 1e-4 and fits within
    1e-3 (the two sum their normal equations in another order); the same
    block keys."""
    jmesh = jsv.make_mesh(2, 1)
    batch = jsv.make_sharded_slam_batch(jmesh, synthetic_camera.intrinsics, JPCFG, stride=2,
                                        backend="pallas")
    jvol, jposes, jfits = batch(jsv.create_sharded(JCFG, jmesh),
                                *(jnp.asarray(a) for a in two_mounts),
                                jcamera.pixel_rays(synthetic_camera.intrinsics))
    vol, poses, fits = _port_slam(intr, two_mounts, 2, 1)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(fits.numpy(), np.asarray(jfits), rtol=0, atol=1e-3)
    want = {k: np.asarray(v) for k, v in jvol._asdict().items()}
    got = interop.sharded_volume_to_numpy(vol)
    assert _shard_keys(got, 0).keys() == _shard_keys(want, 0).keys()
    assert int(want["n_blocks"][0]) > 50


def test_four_camera_rig_on_a_4x2_grid(intr, synthetic_camera):
    """tests/test_sharded_volume.py:203-249: a 4-mount rig tracks and fuses
    on a (4, 2) grid; every shard holds blocks and the combined extraction
    has triangles."""
    vol, poses, fits = _port_slam(intr, _rig_streams(synthetic_camera, 4, 1.2), 4, 2)
    assert fits.shape == (4, 2) and (fits > 0.3).all(), fits
    assert torch.isfinite(poses).all()
    nb = vol.n_blocks
    assert int(nb.sum()) > 50 and (nb > 0).all(), nb
    combined = sv.combine_shards(vol, CFG, 2)
    assert int(mc.extract_mesh(combined, CFG, max_cells=65536, max_tris=65536).num_triangles) > 0


def _dual_pair(synthetic_camera):
    T1 = np.asarray(jse3.se3_exp(jnp.asarray([0.12, 0.02, -0.02, 0.03, -0.1, 0.02],
                                             jnp.float32)), np.float64)
    return T1, (synthetic_camera.capture(np.eye(4)), synthetic_camera.capture(T1))


def test_dual_fusion_sharded_matches_single_device(intr, synthetic_camera, tmp_path):
    """tests/test_sharded_volume.py:252-297: ``DualCameraFusion(sharded=True,
    devices=["cpu"] * 8)`` engages (a 2 x 4 grid) and its combined mesh
    matches the unsharded pipeline's at JAX's bounds, with the extrinsic
    fixed so that both fuse the same data."""
    T1, pair = _dual_pair(synthetic_camera)
    pipes = [DualCameraFusion((intr, intr), PCFG, device="cpu", sharded=s, devices=CPU8,
                              output_dir=str(tmp_path)) for s in (False, True)]
    assert not pipes[0].sharded and pipes[1].sharded
    assert pipes[1].mesh.shape == {"cam": 2, "blk": 4}
    for pipe in pipes:
        pipe.extrinsics[1] = T1
        pipe.calibrated = True
        for _ in range(2):
            pipe.process_frames(pair)
    assert not pipes[1].volume.overflow.any()
    meshes = [mc.extract_mesh(p.extraction_volume(), CFG, max_cells=262144, max_tris=262144)
              for p in pipes]
    _assert_meshes_match(meshes[1], meshes[0])


def test_cam_off_equals_a_one_camera_step(intr, orbit):
    """``cam_on = (1, 0)`` leaves camera 1 out: the raw step's shards equal
    a one-camera raw step's, field for field."""
    depths, colors, poses = orbit
    raw_d = torch.from_numpy(np.round(depths * 1000).astype(np.uint16))
    raw_c = torch.from_numpy(np.round(colors * 255).astype(np.uint8))
    scal = (1.0 / PCFG.camera.depth_scale, PCFG.camera.depth_min, PCFG.camera.depth_trunc)
    rays = pixel_rays(intr, "cpu")
    vols = []
    for n_cam, on in ((2, [1.0, 0.0]), (1, [1.0])):
        mesh = sv.make_mesh(n_cam, 4, CPU8)
        step = sv.make_sharded_raw_step(mesh, intr, CFG, stride=2)
        vols.append(step(sv.create_sharded(CFG, mesh), raw_d[:n_cam], raw_c[:n_cam],
                         torch.from_numpy(poses[:n_cam]), rays, torch.tensor(on), *scal))
    assert int(vols[0].n_blocks.sum()) > 50
    for a, b in zip(vols[0].shards, vols[1].shards):
        for k in a._fields:
            assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_sharded_falls_back_with_the_warning(intr, synthetic_camera, tmp_path, caplog):
    """One device, or different intrinsics: JAX's warning, and the
    unsharded pipeline runs."""
    other = dataclasses.replace(intr, fx=intr.fx * 1.01)
    cases = (((intr, intr), None, "needs >= 2 devices, have 1"),
             ((intr, other), CPU8, "requires identical camera intrinsics"))
    for intrs, devices, msg in cases:
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            pipe = DualCameraFusion(intrs, PCFG, device="cpu", sharded=True, devices=devices,
                                    output_dir=str(tmp_path))
        assert not pipe.sharded and msg in caplog.text, caplog.text
        assert isinstance(pipe.volume, tsdf.TSDFVolume)
    _, pair = _dual_pair(synthetic_camera)
    pipe.extrinsics[1] = np.eye(4)
    pipe.calibrated = True
    pipe.process_frames(pair)
    assert int(pipe.volume.n_blocks) > 50


def test_gather_volume_is_a_copy(intr, orbit):
    """A gathered shard does not move when a later step updates the pools
    in place."""
    depths, colors, poses = orbit
    mesh = sv.make_mesh(1, 2, CPU8)
    step = sv.make_sharded_step(mesh, intr, CFG, stride=2)
    t = torch.from_numpy
    rays = pixel_rays(intr, "cpu")
    vol = step(sv.create_sharded(CFG, mesh), t(depths[:1]), t(colors[:1]), t(poses[:1]), rays)
    sub = sv.gather_volume(vol, CFG, 1, 2)
    before = {k: v.clone() for k, v in sub._asdict().items()}
    vol = step(vol, t(depths[1:]), t(colors[1:]), t(poses[1:]), rays)
    assert not torch.equal(vol.shards[1].weight, before["weight"])
    for k, v in sub._asdict().items():
        assert torch.equal(v, before[k]), k
        assert v.data_ptr() != getattr(vol.shards[1], k).data_ptr()


def test_combine_shards_raises_when_keys_cannot_be_placed():
    """Blocks whose keys all probe from one slot of the combined table
    exhaust its 16 probe rounds: ``RuntimeError``, not an assert."""
    cap = 1 << (CFG.hash_capacity * 2 - 1).bit_length()
    coords = np.random.RandomState(0).randint(-500, 500, (400_000, 3))
    keys = torch.from_numpy(vhash.pack_key_np(coords))
    slot = (vhash._mix(keys) & (cap - 1)).numpy()
    same = coords[slot == slot[0]]
    same = same[np.unique(vhash.pack_key_np(same), return_index=True)[1]][:24]
    assert len(same) == 24
    mesh = sv.make_mesh(1, 2, CPU8)
    vol = sv.create_sharded(CFG, mesh)
    shard = vol.shards[0]
    shard.block_coords[:24] = torch.from_numpy(same.astype(np.int32))
    vol = sv.ShardedTSDF((shard._replace(n_blocks=torch.tensor(24, dtype=torch.int32)),
                          vol.shards[1]))
    with pytest.raises(RuntimeError, match="failed to place"):
        sv.combine_shards(vol, CFG, 2)


def test_make_mesh_grid_and_its_errors():
    mesh = sv.make_mesh(2, 3, CPU8)
    assert mesh.shape == {"cam": 2, "blk": 3}
    assert mesh[1, 2] == torch.device("cpu") and mesh.cam_device(1) == mesh.blk_device(2)
    with pytest.raises(ValueError, match="not enough devices"):
        sv.make_mesh(3, 3, CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="not enough devices"):
            sv.make_mesh(1, 1)  # the default: every visible card


def test_parallel_modules_import_without_jax():
    """With jax made unimportable, the sharded volume, the interop and the
    dual pipeline import and pull in neither jax nor the JAX package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["parallel", "parallel.sharded_volume", "interop", "pipelines.dual_fusion"]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            + "".join(f"importlib.import_module('azurekinect3dreconstruction_tpu_torch.{m}')\n"
                      for m in mods)
            + "assert not [k for k in sys.modules if k.startswith('jax') and sys.modules[k]]\n"
            + "assert 'azurekinect3dreconstruction_tpu' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
