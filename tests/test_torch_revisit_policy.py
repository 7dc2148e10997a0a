"""Host streaming's revisit, the manager's own cases and frame-to-model.

On the CPU at quarter resolution over ``cli.bench.corridor_scene``, in the
small configuration of ``tests/test_torch_revisit.py`` (2 cm voxels in 8^3
blocks, rings at 1.4 / 1.6 m unless a case says otherwise):

- the manager's own ``integrate_frame`` at the true poses: the thrash
  pattern of ``tests/test_torch_streaming.py``'s slow test at a coarser
  step, fast enough for Tier-1; a revisit whose blocks within the eviction
  ring outgrow the pool, which evicts the farthest blocks of the
  hysteresis band and stays exact (it deferred reloads and kept stale
  frozen soups before); an eviction of a key whose reload the full pool
  deferred, which merges the stored payload first instead of dropping it;
- ``MonoOdometryTSDF(tracking="frame_to_model", streaming=...)`` out and
  back, whose model refresh samples the reloaded blocks on the way back,
  against the same into a plain pool: both within 20 mm ATE RMSE, and the
  trajectories and sorted soups equal to the bit. The model ranks its
  blocks by key, so compaction and reloads, which reorder slots, do not
  move it, and the manager's rings come from
  ``StreamingTSDF.for_pipeline(..., tracking="frame_to_model")``, whose
  reload ring holds every block the refresh reads (``model_ring``, 1.91 m
  here) while the camera covers one interval's 0.32 m: 48 frames out, into
  the 384-block pool of ``tests/test_torch_revisit.py``. With the 1.4 m
  reload ring the others use, blocks within the model's reach stayed
  evicted and the two runs parted at the first refresh after the turn.

The card twin (marked ``cuda``) runs the frame-to-model revisit on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_revisit_policy.py``;
no jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu_torch.cli.bench import corridor_scene
from azurekinect3dreconstruction_tpu_torch.config import OdometryConfig, PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core import linalg, se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
    Plane,
    Scene,
    SyntheticCamera,
    orbit_trajectory,
)
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import MonoOdometryTSDF
from azurekinect3dreconstruction_tpu_torch.tracking.icp import (
    F2M_HELD_RATIO,
    TargetMaps,
    keep_held_directions,
)
from azurekinect3dreconstruction_tpu_torch.tsdf import StreamingTSDF
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.tsdf.hash import pack_key_np, unpack_key_np
from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import (
    _scatter_reload,
    integration_reach,
    model_ring,
)
from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate

torch.set_num_threads(2)

INTR = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
TCFG = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=384,
                  hash_capacity=2048)
CFG = dataclasses.replace(PipelineConfig(tsdf=TCFG, odometry=OdometryConfig(pyramid_iters=(4, 4, 4))),
                          camera=PipelineConfig().camera.replace(depth_trunc=0.7))
MANAGER = dict(evict_dist=1.6, reload_dist=1.4, high_water=0.7, check_interval=4)
STEP = 0.08
ATE_LIMIT_M = 0.02
F2M_OUT, F2M_BLOCKS = 48, 384


def _pose(x):
    T = np.eye(4)
    T[0, 3] = x
    return T


def _sorted_soup(mesh):
    t = np.concatenate([np.asarray(mesh.vertices).reshape(-1, 9),
                        np.asarray(mesh.vertex_colors).reshape(-1, 9)], axis=1)
    return t[np.lexsort(t.T[::-1])]


def _live_keys(vol):
    n = int(vol.n_blocks)
    return set(pack_key_np(vol.block_coords[:n].cpu().numpy()).tolist())


class _Watch:
    """The keys a manager's reloads restored, and the camera of each tick."""

    def __init__(self, sv):
        self.restored, self.cams = [], []
        reload, tick = sv._reload_keys, sv.tick

        def _reload_keys(want):
            before = set(sv.store)
            reload(want)
            self.restored.append(before - set(sv.store))

        def _tick(cam_pos, _state=None):
            tick(cam_pos, _state=_state)
            c = cam_pos.detach().cpu().numpy() if hasattr(cam_pos, "detach") else cam_pos
            c = np.asarray(c, np.float64)
            self.cams.append(c[:3, 3] if c.shape == (4, 4) else c.reshape(3))

        sv._reload_keys, sv.tick = _reload_keys, _tick


def _manager_pass(xs, cfg, **kw):
    """The corridor frames at ``xs`` through a manager's own
    ``integrate_frame`` and into one pool that holds them all: (manager,
    its watch, the sorted soups of both)."""
    cam = SyntheticCamera(scene=corridor_scene(), intrinsics=INTR, device="cpu")
    rays = pixel_rays(INTR, "cpu")
    big = cfg.replace(block_capacity=1024, hash_capacity=4096)
    sv = StreamingTSDF(cfg, device="cpu", **kw)
    watch = _Watch(sv)
    vol = tsdf.create(big, "cpu")
    frames = {}
    for x in xs:
        if x not in frames:
            z, c = cam.render(_pose(x))
            frames[x] = (torch.where(z > 0.7, 0.0, z), c,
                         torch.tensor(_pose(x), dtype=torch.float32))
        z, c, T = frames[x]
        sv.integrate_frame(z, c, rays, T, INTR)
        vol = tsdf.integrate_frame(vol, z, c, rays, T, INTR, big)
    assert not bool(vol.overflow)
    return (sv, watch, _sorted_soup(sv.extract_mesh()),
            _sorted_soup(mc.extract_mesh(vol, big).compact()))


def test_thrash_across_the_band_stays_exact():
    """Out past the eviction ring, then three swings back and forth across
    the reload / evict band in a 192-block pool: the same blocks evict and
    come back at least 3 times, no block is both live and stored, and the
    soup equals one pool's to the bit."""
    xs = [STEP * i for i in range(36)]
    for _ in range(3):
        xs += [STEP * i for i in range(34, 12, -1)] + [STEP * i for i in range(14, 36)]
    sv, watch, got, want = _manager_pass(xs, TCFG.replace(block_capacity=192, hash_capacity=1024),
                                         **MANAGER)
    assert not bool(sv.vol.overflow)
    assert sum(1 for r in watch.restored if r) >= 3
    cycles = {}
    for r in watch.restored:
        for key in r:
            cycles[key] = cycles.get(key, 0) + 1
    assert max(cycles.values()) >= 3
    assert not _live_keys(sv.vol) & set(sv.store)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_revisit_over_the_pool_evicts_the_band_and_stays_exact():
    """Out and back where the blocks within the eviction ring outgrow the
    pool (176 blocks, high water 75 %, rings 1.4 / 2.0 m): the farthest
    blocks beyond the reload ring are evicted too, so no reload defers and
    the soup equals one pool's to the bit. Evicting only beyond the
    eviction ring, the pool filled, reloads deferred, invalidated frozen
    soups were kept, and the soup differed."""
    xs = [STEP * i for i in range(38)]
    xs += xs[-2::-1]
    sv, watch, got, want = _manager_pass(
        xs, TCFG.replace(block_capacity=176, hash_capacity=1024), evict_dist=2.0,
        reload_dist=1.4, high_water=0.75, check_interval=4)
    assert sv.n_evictions > 0 and any(watch.restored)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    stored = unpack_key_np(np.fromiter(sv.store, np.int32, len(sv.store)))
    assert (sv._block_dist(stored, watch.cams[-1]) > sv.reload_dist).all()
    assert sv.n_reload_merged == 0


def test_evicting_a_key_with_a_deferred_payload_merges_it():
    """A reload the full pool deferred leaves the payload stored; the
    camera allocates the key again and fuses into it; its eviction merges
    the stored payload into the live block by weight before storing it,
    instead of replacing the store's entry (which dropped the stored
    observations and leaked their batch)."""
    cfg = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=8,
                     hash_capacity=64)
    R3 = cfg.block_resolution ** 3
    sv = StreamingTSDF(cfg, evict_dist=1.8, reload_dist=0.5, high_water=0.5, device="cpu")
    coords = np.array([[i, 0, 0] for i in range(8)], np.int32)
    keys = pack_key_np(coords)
    block = lambda t, w: (np.full(R3, t, np.float32), np.full(R3, w, np.float32),
                          np.full((3, R3), 0.5, np.float32))
    for i in range(7):  # a full pool: 7 live blocks and the trash row
        sv._store_payload(int(keys[i]), *block(0.5, 2.0), coords[i])
    sv._reload_keys(keys[:7])
    sv._store_payload(int(keys[7]), *block(-0.25, 3.0), coords[7])
    sv._reload_keys(keys[7:])
    assert int(keys[7]) in sv.store  # deferred: the pool is full
    sv._evict(np.array([2.0, 0.0, 0.0]), *sv._pull_state())  # room again
    # the camera allocates the key again and fuses one observation into it
    t, w, c = (torch.from_numpy(a)[None] for a in block(0.1, 1.0))
    sv.vol, *_ = _scatter_reload(sv.vol, torch.from_numpy(keys[7:]),
                                 torch.from_numpy(coords[7:]), t, w, c, cfg)
    assert int(keys[7]) in _live_keys(sv.vol) and int(keys[7]) in sv.store
    sv._evict(np.array([-50.0, 0.0, 0.0]), *sv._pull_state())
    t7, w7, _, _ = sv._stored_payload(int(keys[7]))
    np.testing.assert_array_equal(w7, np.full(R3, 4.0, np.float32))  # both observed
    want = (np.float64(0.1) * 1.0 + np.float32(-0.25 * 3.0)) / 4.0
    np.testing.assert_array_equal(t7, np.full(R3, want, np.float32))
    assert all(b.live > 0 for b in sv._pbatch.values())  # no batch left behind
    assert sv.n_reload_merged == 1


# -- frame-to-model on the revisit ----------------------------------------------------


def test_eigh_sym6_matches_numpy():
    """The refinement's 6x6 eigen-decomposition (Jacobi rotations, no host
    read) equals numpy's to rounding, also with a direction 1e-8 weaker
    than the rest."""
    rng = np.random.default_rng(0)
    for k in range(6):
        m = rng.normal(size=(64, 6))
        m[:, k] *= 1e-4
        a = m.T @ m
        lam, vec = linalg.eigh_sym6(torch.from_numpy(a))
        lam, vec = lam.numpy(), vec.numpy()
        tol = 1e-12 * np.abs(a).max()
        np.testing.assert_allclose(np.sort(lam), np.linalg.eigvalsh(a), rtol=0, atol=tol)
        np.testing.assert_allclose(vec @ np.diag(lam) @ vec.T, a, rtol=0, atol=tol)
        np.testing.assert_allclose(vec.T @ vec, np.eye(6), rtol=0, atol=1e-12)


def _maps(scene, T_cam=np.eye(4)):
    cam = SyntheticCamera(scene=scene, intrinsics=INTR, device="cpu")
    z, _ = cam.render(T_cam)
    tgt = TargetMaps.from_depth(z, pixel_rays(INTR, "cpu"))
    pts = tgt.points.reshape(-1, 3)
    return tgt, pts, pts[:, 2] > 0


def test_refinement_keeps_only_the_directions_a_wall_holds():
    """A correction along a wall 0.55 m ahead, about its normal, toward it
    and tilting it: the refinement keeps the part the wall holds (toward it
    and the two tilts) and drops the slide and the spin, where the
    odometry's pose stands. Where every direction is held (the bench
    sweep's scene from its pose 16), the refined pose passes unchanged, to
    the bit."""
    wall = Scene(planes=(Plane((0.0, 0.0, 0.55), (0.0, 0.0, -1.0), (0.7, 0.65, 0.6),
                               checker=0.1),), spheres=())
    tgt, pts, mask = _maps(wall)
    init = torch.eye(4, dtype=torch.float32)
    delta = torch.tensor([0.01, -0.02, 0.004, 0.002, -0.003, 0.02], dtype=torch.float64)
    T = se3.se3_exp(delta).to(torch.float32)
    out = keep_held_directions(T, init, pts, mask, tgt, INTR, 0.05, F2M_HELD_RATIO)
    xi = se3.se3_log(out.to(torch.float64)).numpy()
    np.testing.assert_allclose(xi[[0, 1, 5]], 0.0, atol=2e-4)  # the slide and the spin
    np.testing.assert_allclose(xi[[2, 3, 4]], delta.numpy()[[2, 3, 4]], atol=2e-4)
    pose = torch.as_tensor(orbit_trajectory(64, radius=0.35, angle_span=1.3)[16],
                           dtype=torch.float32)
    tgt, pts, mask = _maps(Scene.default(), pose.numpy())
    world = se3.transform_points(pose, pts)  # the model in the world, init its inverse
    init = se3.inverse(pose)
    out = keep_held_directions(T @ init, init, world, mask, tgt, INTR, 0.05, F2M_HELD_RATIO)
    assert torch.equal(out, T @ init)



def _f2m_revisit(device):
    """``F2M_OUT`` corridor frames out and back through frame-to-model
    tracking, streamed (an ``F2M_BLOCKS`` pool) and into a plain pool:
    (ground-truth poses, streamed pipeline, its manager, its watch, plain
    pipeline)."""
    cam = SyntheticCamera(scene=corridor_scene(), intrinsics=INTR, device=device)
    raw = []
    for i in range(F2M_OUT):
        z, c = cam.render(_pose(STEP * i))
        raw.append((torch.round(z * 1000.0).cpu().numpy().astype(np.uint16),
                    torch.round(c * 255.0).cpu().numpy().astype(np.uint8)))
    idx = list(range(F2M_OUT)) + list(range(F2M_OUT - 2, -1, -1))
    cfg = dataclasses.replace(CFG, tsdf=TCFG.replace(block_capacity=F2M_BLOCKS, hash_capacity=2048))
    plain = dataclasses.replace(CFG, tsdf=TCFG.replace(block_capacity=1024, hash_capacity=4096))
    sv = StreamingTSDF.for_pipeline(cfg, high_water=MANAGER["high_water"],
                                    check_interval=MANAGER["check_interval"],
                                    margin=MANAGER["check_interval"] * STEP,
                                    tracking="frame_to_model", device=device)
    watch = _Watch(sv)
    out = []
    for c, streaming in ((cfg, sv), (plain, None)):
        pipe = MonoOdometryTSDF(INTR, c, device=device, streaming=streaming,
                                tracking="frame_to_model")
        pipe.telemetry.sink = lambda line: None
        for i in idx:
            pipe.process_frame(*raw[i])
        out.append(pipe)
    return [_pose(STEP * i) for i in idx], out[0], sv, watch, out[1]


def _check_f2m_revisit(gt, ps, sv, watch, pp):
    assert sv.n_evictions > 0 and any(watch.restored) and sv.n_reload_merged == 0
    assert not bool(ps.volume.overflow) and not bool(pp.volume.overflow)
    assert ps.counts.get("model_icp_ok", 0) > 0 and pp.counts.get("model_icp_ok", 0) > 0
    assert ate(ps.trajectory[1:], gt)["rmse"] <= ATE_LIMIT_M
    assert ate(pp.trajectory[1:], gt)["rmse"] <= ATE_LIMIT_M
    np.testing.assert_array_equal(np.stack(ps.trajectory), np.stack(pp.trajectory))
    got, want = _sorted_soup(ps.extract_mesh()), _sorted_soup(pp.extract_mesh().compact())
    assert got.shape == want.shape and got.shape[0] > 1000, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_frame_to_model_revisit_against_a_plain_pool():
    _check_f2m_revisit(*_f2m_revisit("cpu"))


def test_frame_to_model_needs_a_ring_that_holds_its_model():
    """A reload ring short of what a model refresh reads is refused at
    construction; ``for_pipeline(..., tracking="frame_to_model")`` reaches
    ``margin`` beyond it, and frame-to-frame keeps its own ring."""
    short = StreamingTSDF(TCFG, device="cpu", **MANAGER)
    with pytest.raises(ValueError, match="reload ring"):
        MonoOdometryTSDF(INTR, CFG, device="cpu", streaming=short, tracking="frame_to_model")
    MonoOdometryTSDF(INTR, CFG, device="cpu", streaming=short)
    f2f = StreamingTSDF.for_pipeline(CFG, margin=0.32, device="cpu")
    f2m = StreamingTSDF.for_pipeline(CFG, margin=0.32, tracking="frame_to_model", device="cpu")
    assert f2f.reload_dist == integration_reach(CFG) + 0.64 < model_ring(CFG) + 0.32
    assert f2m.reload_dist == model_ring(CFG) + 0.32 and f2m.evict_dist == f2m.reload_dist + 1.0
    MonoOdometryTSDF(INTR, CFG, device="cpu", streaming=f2m, tracking="frame_to_model")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_frame_to_model_revisit_on_the_card(card):
    _check_f2m_revisit(*_f2m_revisit(card))
