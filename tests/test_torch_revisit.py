"""Host streaming's revisit path through ``MonoOdometryTSDF(streaming=...)``.

A user who scans a room comes back to where they started, and the blocks
evicted on the way out must come back unchanged. These tests drive the
pipeline over ``cli.bench.corridor_scene`` out and back on the CPU at
quarter resolution, in a small configuration (2 cm voxels in 8^3 blocks, a
384-block pool that evicts from 70 % full, a tick every 4 frames, rings at
1.4 / 1.6 m; 48 frames 8 cm apart, then back over them in reverse):

- the streamed pass evicts, reloads only blocks it evicted, and ends with
  the trajectory, the sorted ``extract_mesh`` soup and the point cloud of a
  plain pool that holds the whole corridor, to the bit; no key is live and
  stored, and at the last tick every stored block lies beyond the reload
  ring;
- against the JAX package: its streamed pipeline (``backend="xla"``, its
  manager at ``max_defer=0``, the lander shut down) tracks the same frames,
  and the port's errors against the truth are within
  ``tests/test_torch_slam.py``'s mono bounds of JAX's (twice JAX's, or 5
  mm / 3 mrad) over the trajectory, as RMSE and as the largest (frame by
  frame, the two solvers' drift on this corridor crosses twice at single
  frames: 20.6 against 10.2 mm at frame 38), and its manager, fed
  the port's poses and decoded frames, evicts and reloads as often as the
  port's streamed pipeline and stores the same blocks. (JAX's xla odometry
  is ~1e-3 from the Pallas path per pair, and on this corridor the
  difference moves the pool's count by up to 9 blocks a tick, so the two
  pipelines' own counts are not comparable.)
- a loss on the way back, inside the stretch that was evicted, is declared
  once, fuses nothing while latched (the map's keys and weight, live and
  stored, unchanged), gives the stream the stale pose and ticks there, and
  recovers by the hint rung within 6 cm / 0.12 rad into the manager's pool;
  with the relocalizer's first attempt 2 frames late (ROADMAP C15), the
  hint rung's pose, slid along the wall, is turned down, and any recovery
  is within the bounds.

``tests/test_torch_revisit_policy.py`` holds the manager's own revisit
cases and frame-to-model on the revisit. The card twin (marked ``cuda``)
runs the streamed-against-plain revisit on the card; this file imports jax
only inside the test that compares with it, so ``python -m pytest
--noconftest -m cuda tests/test_torch_revisit.py`` runs where jax is not
installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu_torch.cli.bench import corridor_scene
from azurekinect3dreconstruction_tpu_torch.config import (
    OdometryConfig,
    PipelineConfig,
    RegistrationConfig,
    TSDFConfig,
)
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.types import decode_raw_frame
from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import MonoOdometryTSDF
from azurekinect3dreconstruction_tpu_torch.tracking.relocalize import Relocalizer
from azurekinect3dreconstruction_tpu_torch.tsdf import StreamingTSDF
from azurekinect3dreconstruction_tpu_torch.tsdf.hash import pack_key_np, unpack_key_np

torch.set_num_threads(2)

INTR = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
CFG = dataclasses.replace(
    PipelineConfig(tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                                   block_capacity=384, hash_capacity=2048),
                   odometry=OdometryConfig(pyramid_iters=(4, 4, 4)),
                   registration=RegistrationConfig(ransac_hypotheses=2048, ransac_rounds=4,
                                                   icp_max_iters=20)),
    camera=PipelineConfig().camera.replace(depth_trunc=0.7))
PLAIN = dataclasses.replace(CFG, tsdf=CFG.tsdf.replace(block_capacity=1024, hash_capacity=4096))
MANAGER = dict(evict_dist=1.6, reload_dist=1.4, high_water=0.7, check_interval=4)
STEP, N_OUT = 0.08, 48
N_DARK = 6
POSE_T_LIMIT_M, POSE_R_LIMIT_RAD = 0.06, 0.12  # tests/test_relocalize.py's bounds


def _pose(x):
    T = np.eye(4)
    T[0, 3] = x
    return T


def _pose_err(T, G):
    xi = se3.se3_log(torch.as_tensor(np.linalg.inv(G) @ np.asarray(T, np.float64))).numpy()
    return float(np.linalg.norm(xi[:3])), float(np.linalg.norm(xi[3:]))


def _sorted_soup(mesh):
    t = np.concatenate([np.asarray(mesh.vertices).reshape(-1, 9),
                        np.asarray(mesh.vertex_colors).reshape(-1, 9)], axis=1)
    return t[np.lexsort(t.T[::-1])]


def _live_keys(vol):
    n = int(vol.n_blocks)
    return set(pack_key_np(vol.block_coords[:n].cpu().numpy()).tolist())


class _Watch:
    """The keys a manager's evictions stored and its reloads restored, and
    the camera of each tick (its instance's methods wrapped)."""

    def __init__(self, sv):
        self.evicted, self.restored, self.cams = set(), [], []
        evict, reload, tick = sv._evict, sv._reload_keys, sv.tick

        def _evict(*a, **k):
            before = set(sv.store)
            out = evict(*a, **k)
            self.evicted |= set(sv.store) - before
            return out

        def _reload_keys(want):
            before = set(sv.store)
            reload(want)
            self.restored.append(before - set(sv.store))

        def _tick(cam_pos, _state=None):
            tick(cam_pos, _state=_state)
            c = cam_pos.detach().cpu().numpy() if hasattr(cam_pos, "detach") else cam_pos
            c = np.asarray(c, np.float64)
            self.cams.append(c[:3, 3] if c.shape == (4, 4) else c.reshape(3))

        sv._evict, sv._reload_keys, sv.tick = _evict, _reload_keys, _tick


def _run(frames, cfg, device, streaming=None, **kw):
    pipe = MonoOdometryTSDF(INTR, cfg, device=device, streaming=streaming, **kw)
    pipe.telemetry.sink = lambda line: None
    for d, c in frames:
        pipe.process_frame(d, c)
    return pipe


def _frames(device="cpu"):
    """(x of each raw frame, raw u16 / u8 frames out, their indices out and
    back)."""
    cam = SyntheticCamera(scene=corridor_scene(), intrinsics=INTR, device=device)
    xs = [STEP * i for i in range(N_OUT)]
    raw = []
    for x in xs:
        z, c = cam.render(_pose(x))
        raw.append((torch.round(z * 1000.0).cpu().numpy().astype(np.uint16),
                    torch.round(c * 255.0).cpu().numpy().astype(np.uint8)))
    return xs, raw, list(range(N_OUT)) + list(range(N_OUT - 2, -1, -1))


def _revisit(device):
    """The out-and-back through a streamed and a plain pipeline: (frames,
    the frames' x, streamed pipeline, its manager, its watch, plain
    pipeline)."""
    xs, raw, idx = _frames(device)
    frames = [raw[i] for i in idx]
    sv = StreamingTSDF(CFG.tsdf, device=device, **MANAGER)
    watch = _Watch(sv)
    ps = _run(frames, CFG, device, sv)
    pp = _run(frames, PLAIN, device)
    return frames, [xs[i] for i in idx], ps, sv, watch, pp


def _check_revisit_equals_plain(ps, sv, watch, pp):
    assert not bool(ps.volume.overflow) and not bool(pp.volume.overflow)
    assert sv.n_evictions > 0
    back = set().union(*watch.restored)
    assert back and back <= watch.evicted  # only blocks this pass evicted come back
    assert sv.n_blocks_reloaded == len(back) and sv.n_reload_merged == 0
    assert not _live_keys(ps.volume) & set(sv.store)
    stored = unpack_key_np(np.fromiter(sv.store, np.int32, len(sv.store)))
    assert (sv._block_dist(stored, watch.cams[-1]) > sv.reload_dist).all()
    np.testing.assert_array_equal(np.stack(ps.trajectory), np.stack(pp.trajectory))
    got, want = _sorted_soup(ps.extract_mesh()), _sorted_soup(pp.extract_mesh().compact())
    assert got.shape == want.shape and got.shape[0] > 1000, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    assert ps.extract_point_cloud()[0].shape == pp.extract_point_cloud()[0].shape
    assert ps.volume is sv.vol


@pytest.fixture(scope="module")
def revisit():
    return _revisit("cpu")


def test_revisit_through_the_pipeline_equals_a_plain_pool(revisit):
    _, _, ps, sv, watch, pp = revisit
    _check_revisit_equals_plain(ps, sv, watch, pp)
    assert ps.odometry_failures == 0


def test_revisit_tracks_and_streams_as_jax(revisit):
    """JAX's streamed pipeline tracks the same frames within the mono
    bounds; JAX's manager, fed the port's poses and decoded frames, evicts
    and reloads as often as the port's streamed pipeline and stores and
    freezes the same blocks."""
    import jax  # noqa: F401  (the JAX side runs on the CPU, as tests/conftest.py sets)

    from azurekinect3dreconstruction_tpu import config as jcfg
    from azurekinect3dreconstruction_tpu.core import camera as jcamera
    from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF as JMono,
    )
    from azurekinect3dreconstruction_tpu.tsdf import streaming as jstreaming

    frames, gx, ps, sv, _, _ = revisit
    jp = jcfg.PipelineConfig.from_json(CFG.to_json())
    jintr = jcamera.Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    jsv = jstreaming.StreamingTSDF(jp.tsdf, max_defer=0, **MANAGER)
    pj = JMono(jintr, jp, backend="xla", streaming=jsv)
    pj.telemetry.sink = lambda line: None
    for d, c in frames:
        pj.process_frame(d, c)
    jsv._lander.shutdown()
    assert jsv.n_evictions > 0 and jsv.n_reloads > 0
    tj, tt = pj.trajectory, ps.trajectory
    ej = np.array([_pose_err(T, _pose(x)) for T, x in zip(tj[1:], gx)])
    et = np.array([_pose_err(T, _pose(x)) for T, x in zip(tt[1:], gx)])
    rms = lambda e: np.sqrt((e ** 2).mean(axis=0))
    for f in (rms, lambda e: e.max(axis=0)):
        (t_t, r_t), (t_j, r_j) = f(et), f(ej)
        assert t_t < max(2 * t_j, 5e-3) and r_t < max(2 * r_j, 3e-3), (f(et), f(ej))

    # JAX's manager at the port's poses, on the frames the port decoded
    msv = jstreaming.StreamingTSDF(jp.tsdf, max_defer=0, **MANAGER)
    rays = jcamera.pixel_rays(jintr)
    cam = CFG.camera
    for (d, c), T in zip(frames, tt[1:]):
        dm, cm, _ = decode_raw_frame(torch.from_numpy(d), torch.from_numpy(c),
                                     1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc)
        msv.integrate_frame(dm.numpy(), cm.numpy(), rays, np.asarray(T, np.float32), jintr,
                            backend="xla")
    msv._lander.shutdown()
    assert (msv.n_evictions, msv.n_reloads) == (sv.n_evictions, sv.n_reloads)
    assert set(msv.store) == set(sv.store) and set(msv.soups) == set(sv.soups)


@pytest.mark.parametrize("shift", [0, 2], ids=["first_resumed", "two_late"])
def test_loss_on_the_way_back_recovers_in_the_streamed_map(revisit, shift):
    """Dark frames on the way back, over the stretch the way out evicted;
    the scan resumes at the pose where it went dark. With ``shift`` 0 the
    dark frames start 2 frames after a tracking check, so the check after
    their second frame declares the loss and the relocalizer's fifth lost
    frame, its next attempt, is the first resumed one; a tick falls on a
    lost frame. With ``shift`` 2 they start 2 frames earlier and the
    attempt comes 2 frames after the resumed pose, 16 cm on: the hint rung
    slid along the wall to a pose 161 mm off there and fused at it (ROADMAP
    C15). Now the slide gate turns that pose down; the corridor repeats
    every 0.6 m, and the later attempts, whose hint is stale, may recover
    only through the global ladder, whose winner must hold a consensus
    that no repeat rivals. Either way the loss is declared once,
    at most one recovery comes, within the bounds, and nothing is fused
    before it."""
    frames, gx, _, _, _, _ = revisit
    k = N_OUT + 14 - shift  # the way back at x = 2.64 m (shift 0)
    assert (k + shift) % 4 == 2 and (k + shift) % 8 == 6
    dark = (np.zeros((INTR.height, INTR.width), np.uint16),
            np.zeros((INTR.height, INTR.width, 3), np.uint8))
    seq = frames[:k] + [dark] * N_DARK + frames[k - 1:]
    xs = gx[:k] + [None] * N_DARK + gx[k - 1:]
    sv = StreamingTSDF(CFG.tsdf, device="cpu", **MANAGER)
    watch = _Watch(sv)
    pipe = MonoOdometryTSDF(INTR, CFG, device="cpu", streaming=sv, relocalize=True,
                            reloc_window=2, reloc_interval=4, reloc_min_inliers=500)
    pipe.telemetry.sink = lambda line: None
    # one RANSAC restart an attempt, as tests/test_torch_relocalize.py's attempts take: a
    # late loss runs the descriptor ladder on every later attempt, ~25 s each with four
    pipe._relocalizer = Relocalizer(INTR, CFG, device="cpu", rays=pipe.rays,
                                    model_points=pipe.model_points, min_inliers=500, restarts=1)
    lost_at = recovered_at = None
    given, lost_ticks, latched = [], 0, []
    maybe_tick = sv.maybe_tick
    seen = []
    sv.maybe_tick = lambda cam_pos: seen.append(cam_pos()[:3, 3].numpy()) or maybe_tick(cam_pos)
    for i, (d, c) in enumerate(seq):
        was_lost, t0 = pipe.lost, len(watch.cams)
        stale = pipe.T_world_cam[:3, 3].astype(np.float32)
        seen.clear()
        pipe.process_frame(d, c)
        if was_lost:
            given += [float(np.abs(p - stale).max()) for p in seen]
            lost_ticks += len(watch.cams) - t0
        if pipe.lost and lost_at is None:
            lost_at = i
        if lost_at is not None and not pipe.lost and recovered_at is None:
            recovered_at = i
        if i >= k - 1 and recovered_at is None:
            w = float(pipe.volume.weight[:int(pipe.volume.n_blocks)].double().sum())
            w += sum(float(sv._stored_payload(key)[1].astype(np.float64).sum()) for key in sv.store)
            latched.append((_live_keys(pipe.volume) | set(sv.store), w))
    # evictions before the loss; after a recovery, the stretch around the dark site
    assert watch.evicted and (recovered_at is None or any(
        gx[k - 1] - 0.5 < (c[0] + 0.5) * CFG.tsdf.block_size
        for c in unpack_key_np(np.asarray(list(watch.evicted)))))
    counts = pipe.counts
    reloc = pipe._relocalizer
    assert counts.get("tracking_lost") == 1 and counts.get("relocalized", 0) <= 1, counts
    assert k <= lost_at and (recovered_at is None or lost_at < recovered_at)
    assert all(m == latched[0] for m in latched)  # nothing fused while latched
    assert given and max(given) == 0.0 and lost_ticks  # streams at the stale pose, and ticks
    if shift:
        assert reloc.n_texture_rejects + reloc.n_free_space_rejects >= 1
    else:
        assert counts.get("relocalized") == 1 and reloc.n_hint_success >= 1, counts
    if recovered_at is not None:
        t, r = _pose_err(pipe.trajectory[recovered_at + 1], _pose(xs[recovered_at]))
        assert t < POSE_T_LIMIT_M and r < POSE_R_LIMIT_RAD, (t, r)
    assert pipe.volume is sv.vol and not bool(pipe.volume.overflow)


# -- on the card ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_revisit_on_the_card_equals_a_plain_pool(card):
    """The same out-and-back on the card (B1 and B2): the streamed pass
    equals the plain pool's to the bit."""
    _, _, ps, sv, watch, pp = _revisit(card)
    _check_revisit_equals_plain(ps, sv, watch, pp)
