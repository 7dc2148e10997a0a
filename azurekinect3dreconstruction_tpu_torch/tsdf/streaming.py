"""Host streaming for unbounded scenes on a fixed device block pool (the
counterpart of the JAX package's ``tsdf/streaming.py``).

The pool of :mod:`.volume` has a fixed capacity, and a scan longer than it
sets the sticky ``overflow`` flag. This manager closes that gap the way
voxel-hashing systems do: blocks far from the camera are swapped out to
host memory and swapped back in on a revisit, so a scan of any extent runs
in a constant device footprint (up to the key space of ``hash.pack_key``,
block coords in [-512, 512)^3, which binds every volume of the package).

- **evict**: when the pool passes ``high_water``, the blocks farther than
  ``evict_dist`` from the camera (and, while those leave it over high water,
  the farthest of the blocks beyond ``reload_dist``: a revisit holds blocks
  on both sides of the camera) are gathered on the device and copied into
  the host store (page-locked host tensors on a card, ``non_blocking``,
  each batch with the CUDA event recorded after its copy), then the pool is
  compacted on the device: the survivors re-packed into a dense prefix and a
  fresh hash table built with ``hash.build_table``. The dense prefix every
  consumer relies on (integrate masks, extraction prefix scans) holds by
  construction.
- **reload**: stored blocks within ``reload_dist`` of the camera are
  inserted again (``hash.insert``); their batch goes back to the device with
  a stream-ordered copy. A fresh slot restores the stored payload to the
  bit; a key that is live again merges by weight; a full pool defers the
  reload and keeps the payload in the store (an eviction of that key, live
  again meanwhile, merges it first).
- **frozen geometry**: a marching-cubes cell of block B reads corner values
  from B's positive-corner neighbors, so evicting V changes what B = V -
  corner would emit. The manager keeps a frozen set with the invariant
  *frozen(B) <=> B is off the device or an existing positive-corner neighbor
  of B is*. A block entering the set is extracted right then, while every
  corner supplier is resident, and its soup is cached in host memory.
  :meth:`StreamingTSDF.extract_mesh` emits live geometry only for unfrozen
  blocks and appends the cached soups: every cell is evaluated once against
  the same voxel values, so the result equals a full extraction of an
  infinite pool that saw the same frames, to the bit.

Policy contract: integration touches only blocks within
:func:`integration_reach` of the camera, so with ``reload_dist`` above that
reach and ``evict_dist > reload_dist`` frozen blocks come back (reloaded,
unfrozen) before the camera can integrate into them again. The policy runs
every ``check_interval`` frames, and the camera must not cover
``reload_dist - integration reach`` within one interval.

The tick's inputs (the pool's content stamp, ``volume.content_checksums``,
whose rows hold the change checksum, ``n_blocks`` and the block coords, and
the camera pose) are copied to the host one interval ahead, one frame after
the previous tick, without waiting; the tick waits on that copy's event at
the interval frame and decides on that state and pose. Anything that
mutates the pool against the state (eviction, the rules that reload) reads
the state afresh first. ``overflow`` stays meaningful: with enough headroom
it fires only when the working set (blocks within ``evict_dist``) exceeds
the pool. The high-water trigger reads a state up to one interval old, so
``(1 - high_water) * block_capacity`` must exceed what two intervals can
allocate.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.core.fmath import fma
from azurekinect3dreconstruction_tpu_torch.core.types import TriangleMeshHost
from azurekinect3dreconstruction_tpu_torch.tsdf import hash as vhash
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import mc_tables as mt
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf_volume
from azurekinect3dreconstruction_tpu_torch.tsdf.volume import TSDFVolume, content_checksums
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_warning

_CORNERS = np.asarray(mt.CORNER_OFFSETS)  # (8, 3); [0] = self, [1:] positive

pack_np = vhash.pack_key_np
unpack_np = vhash.unpack_key_np


def integration_reach(cfg) -> float:
    """Farthest block center a frame can touch, from a ``PipelineConfig``:
    max depth times the diagonal-FOV secant (~1.45 for the Kinect NFOV
    corner rays), plus the truncation band, plus one block diagonal. The
    one definition of this quantity: the streaming distances and the
    frame-to-model refresh radius derive from it."""
    return 1.45 * cfg.camera.depth_trunc + cfg.tsdf.sdf_trunc + 1.8 * cfg.tsdf.block_size


def model_reach(cfg) -> float:
    """Radius of a view-local model sample, from a ``PipelineConfig``:
    :func:`integration_reach` plus the 0.25 m the camera may move before
    frame-to-model tracking refreshes its model. The relocalizer samples a
    map too large for its budget within this radius of its hint."""
    return integration_reach(cfg) + 0.25


def model_ring(cfg) -> float:
    """Farthest block center a view-local model sample reads, from a
    ``PipelineConfig``: :func:`model_reach` plus one block diagonal, where
    the sampled blocks' +corner neighbors supply corner values. A streamed
    frame-to-model pipeline samples the same model as a plain pool only
    while every such block is resident."""
    return model_reach(cfg) + float(np.sqrt(3.0)) * cfg.tsdf.block_size


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------


def _compact(vol: TSDFVolume, perm, n_keep: int) -> TSDFVolume:
    """Re-pack survivors into a dense prefix: new slot ``i`` takes old slot
    ``perm[i]`` for ``i < n_keep`` (rows past ``n_keep`` are free). Returns
    new pool tensors and a table rebuilt by ``hash.build_table``; a failed
    build sets ``overflow``. Only ``weight`` is zeroed on the free rows:
    weight 0 marks an invalid voxel everywhere (integration's running mean,
    extraction's validity, a fresh slot's reuse), so tsdf and color there
    are never read."""
    dev = vol.tsdf.device
    cap = vol.tsdf.shape[0]
    iota = torch.arange(cap, device=dev)
    keep = iota < n_keep
    p = torch.where(keep, torch.as_tensor(np.asarray(perm), dtype=torch.int64, device=dev), 0)
    bc = vol.block_coords[p]
    keys = torch.where(keep, vhash.pack_key(bc), vhash.EMPTY_KEY)
    table, ok = vhash.build_table(keys, iota, vol.table_keys.shape[0])
    weight = torch.index_select(vol.weight, 0, p)
    weight[n_keep:] = 0.0
    return vol._replace(
        table_keys=table.keys,
        table_vals=table.vals,
        n_blocks=torch.tensor(n_keep, dtype=torch.int32, device=dev),
        block_coords=bc,
        tsdf=torch.index_select(vol.tsdf, 0, p),
        weight=weight,
        color=torch.index_select(vol.color, 0, p),
        overflow=vol.overflow | ~ok,
    )


def _scatter_reload(vol: TSDFVolume, keys, coords, bt, bw, bc, cfg: TSDFConfig):
    """Insert stored blocks (``keys`` (K,) int32, ``coords`` (K, 3), payload
    ``bt``/``bw`` (K, R^3) and ``bc`` (K, 3, R^3), all on the pool's device)
    back into the pool, whose pools and coords are written in place. A fresh slot
    (the policy's case) restores the payload to the bit; a key that is live
    again merges by integration weight, ``fma(t, w, t_k * w_k) / (w + w_k)``
    as the JAX package's compiled merge rounds it. The last pool row stays
    the worklist's trash slot. Returns (vol, per-key slots as a host array,
    -1 where the pool was full: the caller keeps those in the store, and
    the number of keys that merged into a live block)."""
    cap = vol.tsdf.shape[0]
    table, counter, vals, _ = vhash.insert(vol.table, vol.n_blocks, keys, cap - 1)
    # one read: the slots, and the count before the insert (a slot below it
    # was live already)
    v = torch.cat([vals, vol.n_blocks.reshape(1).to(vals.dtype)]).cpu().numpy()
    v, n_before = v[:-1], int(v[-1])
    n_merged = int(((v >= 0) & (v < n_before)).sum())
    ok = torch.from_numpy(v >= 0).to(vol.tsdf.device)
    slots = vals[ok].to(torch.int64)
    w_old = vol.weight[slots]
    tK, wK, cK = bt[ok], bw[ok], bc[ok]
    fresh = w_old <= 0.0
    denom = torch.clamp_min(w_old + wK, 1e-6)
    vol.tsdf[slots] = torch.where(fresh, tK, fma(vol.tsdf[slots], w_old, tK * wK) / denom)
    vol.color[slots] = torch.where(
        fresh[:, None], cK,
        fma(vol.color[slots], w_old[:, None], cK * wK[:, None]) / denom[:, None])
    vol.weight[slots] = torch.clamp_max(w_old + wK, cfg.max_integration_weight)
    vol.block_coords[slots] = coords[ok].to(torch.int32)
    return vol._replace(table_keys=table.keys, table_vals=table.vals, n_blocks=counter), v, n_merged


# ---------------------------------------------------------------------------
# host stores
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Batch:
    """One eviction's payload in the host store: tsdf and weight (K, R^3),
    color (K, 3, R^3), the rows' block coords (K, 3) numpy, the rows still
    stored, and the event recorded after its copy (None on the CPU)."""

    tsdf: torch.Tensor
    weight: torch.Tensor
    color: torch.Tensor
    coords: np.ndarray
    live: int
    ready: Optional[torch.cuda.Event]


@dataclasses.dataclass
class _SoupBatch:
    """One freeze's triangle soup in host memory, (n, 3, 3) vertices and
    colors sorted by block, the soups that still refer to it, and its
    copy's event."""

    verts: torch.Tensor
    cols: torch.Tensor
    refs: int
    ready: Optional[torch.cuda.Event]


class _SoupRef(NamedTuple):
    """A frozen block's triangle range [a, b) within soup batch ``sid``."""

    sid: int
    a: int
    b: int


def _wait(ev) -> None:
    """Wait for a host copy's event (None: the data is on the host already)."""
    if ev is not None:
        ev.synchronize()


def _decode(cks: np.ndarray) -> Tuple[int, np.ndarray, np.ndarray]:
    """A (6, N) content stamp -> (n_blocks, coords (N, 3) int32, change
    checksums (N,) int64)."""
    return int(cks[2, 0]), np.ascontiguousarray(cks[3:6].T.astype(np.int32)), cks[0].copy()


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


class StreamingTSDF:
    """Fixed-pool TSDF volume + host block store + frozen-geometry cache.

    Owns a ``TSDFVolume`` (``self.vol``); frames go in through
    :meth:`integrate_frame` (which runs the policy every ``check_interval``
    frames), or an external integrator hands the volume over and calls
    :meth:`maybe_tick` once a frame. ``reload_dist`` must exceed the
    integration reach and ``evict_dist`` must exceed ``reload_dist``
    (hysteresis); a breach degrades to a weighted merge on reload, not to
    corruption, but the frozen cache is then no longer exact.

    ``device`` (default ``"cuda"``, which raises without a card) holds the
    pool; on a card the stores are page-locked host tensors, on the CPU
    plain CPU tensors. ``vol`` adopts an existing pool on that device
    instead of creating one, so that only one pool ever exists."""

    integration_reach = staticmethod(integration_reach)

    def __init__(self, cfg: TSDFConfig, evict_dist: float, reload_dist: float,
                 high_water: float = 0.85, check_interval: int = 8, max_cells: int = 65536,
                 max_tris: int = 131072, vol: Optional[TSDFVolume] = None, *, device="cuda"):
        if not evict_dist > reload_dist > 0:
            raise ValueError(f"need evict_dist > reload_dist > 0, got {evict_dist}, {reload_dist}")
        self.device = resolve_device(device)
        if vol is not None and vol.tsdf.device.type != self.device.type:
            raise ValueError(f"the adopted pool is on {vol.tsdf.device}, not {self.device}")
        self.cfg = cfg
        self.vol = tsdf_volume.create(cfg, self.device) if vol is None else vol
        self.evict_dist = float(evict_dist)
        self.reload_dist = float(reload_dist)
        self.high_water = int(high_water * cfg.block_capacity)
        self.check_interval = int(check_interval)
        # floors of extract_mesh's live budgets (they only grow)
        self.max_cells = max_cells
        self.max_tris = max_tris
        self.n_evictions = 0
        self.n_reloads = 0
        self.n_blocks_reloaded = 0  # blocks a reload put back into the pool
        self.n_reload_merged = 0  # of those, the ones that merged into a live key
        self.n_stale_refreshes = 0
        # cumulative wall ms per tick stage, over all ticks
        self.tick_ms: Dict[str, float] = {}
        self.n_ticks = 0
        self._clear()

    def _clear(self) -> None:
        self._pbatch: Dict[int, _Batch] = {}
        self.store: Dict[int, Tuple[int, int]] = {}  # key -> (batch id, row)
        self._sbatch: Dict[int, _SoupBatch] = {}
        # key -> _SoupRef, or an inline empty (verts, cols) pair for a block
        # that froze with no triangle; presence == frozen
        self.soups: Dict[int, object] = {}
        self._next_bid = 0
        self._next_sid = 0
        self._prefetch = None  # (stamp, pose, event) copied one interval ahead
        # key -> (exists (8,) bool, change checksums (8,) int64): the state of
        # the block's +corner neighborhood (code 0 = self) when its soup was
        # cut. The soup stays valid while that state is unchanged: the
        # block's data, each supplier's data and which neighbors exist.
        self._soup_env: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        # key -> change checksum of each stored block (immutable off the device)
        self._stored_cks: Dict[int, int] = {}
        # live blocks' checksums at the end of the last tick (the supplier rule)
        self._live_cks: Dict[int, int] = {}
        self._since_check = 0

    def _acc(self, key: str, t0: float) -> float:
        """Add the wall ms since ``t0`` to ``tick_ms[key]``; returns a fresh
        timestamp."""
        t1 = time.perf_counter()
        self.tick_ms[key] = self.tick_ms.get(key, 0.0) + (t1 - t0) * 1e3
        return t1

    @classmethod
    def for_pipeline(cls, cfg, high_water: float = 0.85, check_interval: int = 8,
                     margin: float = 0.5, tracking: str = "frame_to_frame",
                     **kw) -> "StreamingTSDF":
        """Distances derived from a ``PipelineConfig``: the reload ring
        ``2 * margin`` beyond :func:`integration_reach` (the camera may
        cover ``margin`` in one interval), eviction one metre farther out
        (hysteresis). With ``tracking="frame_to_model"`` the ring reaches at
        least ``margin`` beyond :func:`model_ring` too, so every block a
        model refresh reads between two ticks is resident."""
        reload_dist = integration_reach(cfg) + 2.0 * margin
        if tracking == "frame_to_model":
            reload_dist = max(reload_dist, model_ring(cfg) + margin)
        return cls(cfg.tsdf, evict_dist=reload_dist + 1.0, reload_dist=reload_dist,
                   high_water=high_water, check_interval=check_interval, **kw)

    def reset_state(self) -> None:
        """Forget everything (the pipeline's volume reset): a fresh pool,
        empty stores and caches."""
        self.vol = tsdf_volume.create(self.cfg, self.device)
        self._clear()

    # -- host copies ------------------------------------------------------------

    def _to_host(self, *tensors):
        """Copies of device tensors in host memory: page-locked on a card,
        started without waiting, with the event recorded after them; on the
        CPU the tensors themselves. Returns (host tensors, event or None)."""
        if self.device.type != "cuda":
            return tensors, None
        out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
        for o, t in zip(out, tensors):
            o.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return out, ev

    def _pull_state(self) -> Tuple[int, np.ndarray, np.ndarray]:
        """The pool's current (n_blocks, coords, change checksums): one read."""
        return _decode(content_checksums(self.vol).cpu().numpy())

    # -- per frame --------------------------------------------------------------

    def integrate_frame(self, depth, color, rays, T_world_cam, intr: Intrinsics,
                        stride: int = 2) -> None:
        """allocate + integrate one registered frame (tensors on the pool's
        device), then count it toward the policy's interval."""
        self.vol = tsdf_volume.integrate_frame(self.vol, depth, color, rays, T_world_cam, intr,
                                               self.cfg, stride=stride)
        self.maybe_tick(lambda: T_world_cam)

    def maybe_tick(self, cam_pos) -> bool:
        """Count one frame; run :meth:`tick` when the interval elapses, and
        return whether it ran. ``cam_pos`` (a (3,) position or a (4, 4)
        pose, host or device, or a callable giving one) is read one frame
        after the previous tick: then the tick's inputs are copied to the
        host without waiting, and the tick at the interval frame waits on
        that copy and decides on that state and that pose. Between those
        two frames nothing waits on the device."""
        self._since_check += 1
        if self._since_check == 1 and self.check_interval > 1:
            t0 = time.perf_counter()
            pose = cam_pos() if callable(cam_pos) else cam_pos
            cks = content_checksums(self.vol)
            if isinstance(pose, torch.Tensor):
                (cks, pose), ev = self._to_host(cks, pose.detach())
            else:
                (cks,), ev = self._to_host(cks)
            self._prefetch = (cks, pose, ev)
            self._acc("prefetch_dispatch", t0)
            return False
        if self._since_check < self.check_interval:
            return False
        if self._prefetch is not None:
            t0 = time.perf_counter()
            cks, pose, ev = self._prefetch
            _wait(ev)
            state = _decode(cks.numpy())
            self._acc("state_land", t0)
            self.tick(pose, _state=state)
        else:
            self.tick(cam_pos() if callable(cam_pos) else cam_pos)
        return True

    # -- policy -------------------------------------------------------------------

    def tick(self, cam_pos, _state=None) -> None:
        """Reload, then the rules, then evict, against the camera position.
        A direct call reads the pool's state once; :meth:`maybe_tick` passes
        the state it copied ahead. A stale state only defers work one tick
        (change detection compares snapshots); anything that mutates the
        pool against the state reads it afresh first."""
        self._since_check = 0
        self._prefetch = None  # a direct tick orphans a pending copy
        self.n_ticks += 1
        t0 = time.perf_counter()
        if isinstance(cam_pos, torch.Tensor):
            cam_pos = cam_pos.detach().cpu().numpy()
        cam = np.asarray(cam_pos, np.float64)
        cam = cam[:3, 3] if cam.shape == (4, 4) else cam.reshape(3)
        reloaded = self._maybe_reload(cam)
        t0 = self._acc("reload", t0)
        # a reload changed the pool: the copied state no longer matches it
        fresh = _state is None or reloaded
        n, coords, cks = self._pull_state() if fresh else _state
        t0 = self._acc("pull", t0)
        n, coords, cks, r2 = self._supply_changed_live(n, coords, cks)
        t0 = self._acc("supply", t0)
        n, coords, cks, r3 = self._refresh_frozen(n, coords, cks)
        t0 = self._acc("refresh_frozen", t0)
        fresh = fresh or r2 or r3  # both read the state afresh after acting
        live_keys = pack_np(coords[:n])
        if n > self.high_water:
            if not fresh:
                # eviction compacts with an explicit permutation and
                # freeze-extracts from live voxels: both need the pool as it
                # is now, so the rules run again on a fresh read
                n, coords, cks = self._pull_state()
                n, coords, cks, r2b = self._supply_changed_live(n, coords, cks)
                n, coords, cks, r3b = self._refresh_frozen(n, coords, cks)
                r2, r3 = r2 or r2b, r3 or r3b
                live_keys = pack_np(coords[:n])
            t0 = self._acc("evict_repull", t0)
            if n > self.high_water:
                live_keys = self._evict(cam, n, coords, cks)
                t0 = self._acc("evict", t0)
        if reloaded or r2 or r3:
            self._unfreeze_sweep(live_keys)
            t0 = self._acc("unfreeze", t0)
        # the snapshot for the next tick's change detection; evicted blocks
        # drop out, and keys reloaded after the read count as changed
        lk = set(live_keys.tolist())
        self._live_cks = {k: v for k, v in zip(pack_np(coords[:n]).tolist(), cks[:n].tolist())
                          if k in lk}
        self._acc("snapshot", t0)

    def _supply_changed_live(self, n, coords, cks):
        """The supplier rule: a live block whose data changed since the last
        tick (new blocks included) gets its stored +corner suppliers
        reloaded, or its boundary cells facing them could neither emit live
        nor be covered by a frozen soup."""
        if not self.store:
            return n, coords, cks, False
        live_keys = pack_np(coords[:n])
        prev = self._live_cks
        chg = np.asarray([prev.get(int(k)) != int(c) for k, c in zip(live_keys, cks[:n])], bool)
        if not chg.any():
            return n, coords, cks, False
        kk = pack_np(coords[:n][chg][:, None, :] + _CORNERS[None, 1:]).reshape(-1)
        skeys = np.fromiter(self.store.keys(), np.int32, len(self.store))
        need = np.unique(kk[np.isin(kk, skeys)])
        if not len(need):
            return n, coords, cks, False
        self.n_stale_refreshes += 1
        self._reload_keys(need.astype(np.int32))
        n, coords, cks = self._pull_state()
        return n, coords, cks, True

    def _refresh_frozen(self, n, coords, cks):
        """Invalidate frozen soups whose recorded neighborhood no longer
        matches: the block's own data changed, a live supplier's data
        changed, or a neighbor appeared where none existed. Their stored
        suppliers are reloaded and they unfreeze; live extraction re-emits
        them. Loops to a fixpoint (each pass only shrinks the frozen set).
        Returns (n, coords, cks, whether anything happened)."""
        did = False
        for _ in range(len(self.soups) + 1):
            if not self.soups:
                break
            cks_map = dict(zip(pack_np(coords[:n]).tolist(), cks[:n].tolist()))
            fkeys = np.fromiter(self.soups.keys(), np.int32, len(self.soups))
            kk = pack_np(unpack_np(fkeys)[:, None, :] + _CORNERS[None])
            stale, need = [], set()
            for i, k in enumerate(fkeys.tolist()):
                env = self._soup_env.get(k)
                if env is None or not self._env_holds(env, kk[i].tolist(), cks_map):
                    stale.append(k)
                    need.update(int(c) for c in kk[i] if int(c) in self.store)
            if not stale:
                break
            did = True
            self.n_stale_refreshes += 1
            if need:
                self._reload_keys(np.asarray(sorted(need), np.int32))
                n, coords, cks = self._pull_state()
            # unfreeze only where the suppliers came back: a full-pool reload
            # defers, and a stale soup kept frozen beats a hole in the mesh
            stale_rows = {int(k): kk[i] for i, k in enumerate(fkeys)}
            deferred = 0
            for k in stale:
                if any(int(c) in self.store for c in stale_rows[k]):
                    deferred += 1
                    continue
                self._drop_soup(k)
            if deferred:
                log_warning(f"streaming: {deferred} invalidated frozen caches kept "
                            "(pool full; reload deferred)")
                break
        return n, coords, cks, did

    def _env_holds(self, env, keys8, cks_map) -> bool:
        """Whether a soup's recorded neighborhood (``env``: existence and
        checksums of the 8 keys ``keys8``) still matches the live checksums
        ``cks_map`` and the stored ones."""
        exist, c8 = env
        for j, ckey in enumerate(keys8):
            now = cks_map.get(ckey, self._stored_cks.get(ckey))
            if (now is not None) != bool(exist[j]) or (now is not None and now != int(c8[j])):
                return False
        return True

    def _drop_soup(self, key: int) -> None:
        """Remove a frozen soup and its record, releasing its batch with the
        last reference."""
        val = self.soups.pop(key, None)
        self._soup_env.pop(key, None)
        if isinstance(val, _SoupRef):
            sb = self._sbatch[val.sid]
            sb.refs -= 1
            if sb.refs == 0:
                del self._sbatch[val.sid]

    def _block_dist(self, coords: np.ndarray, cam: np.ndarray) -> np.ndarray:
        centers = (coords.astype(np.float64) + 0.5) * self.cfg.block_size
        return np.linalg.norm(centers - cam[None], axis=1)

    def _maybe_reload(self, cam: np.ndarray) -> bool:
        if not self.store:
            return False
        skeys = np.fromiter(self.store.keys(), np.int32, len(self.store))
        want = skeys[self._block_dist(unpack_np(skeys), cam) < self.reload_dist]
        if not len(want):
            return False
        self._reload_keys(want)
        return True

    def _store_payload(self, key: int, t, w, c, crd) -> None:
        """Put one block's payload into the store as a single-row batch
        (host arrays accepted: tsdf and weight (R^3,), color (3, R^3)).
        Eviction stores its payloads in batches; this is the seam for tests
        and external injection."""
        R3 = self.cfg.block_resolution ** 3
        rows = [torch.as_tensor(np.asarray(a, np.float32)).reshape(shape)
                for a, shape in ((t, (1, R3)), (w, (1, R3)), (c, (1, 3, R3)))]
        if self.device.type == "cuda":
            rows = [r.pin_memory() for r in rows]
        bid = self._next_bid
        self._next_bid += 1
        self._pbatch[bid] = _Batch(*rows, coords=np.asarray(crd, np.int32).reshape(1, 3), live=1,
                                   ready=None)
        self.store[int(key)] = (bid, 0)

    def _stored_payload(self, key: int):
        """One stored block's (tsdf, weight, color, coord) as numpy, after
        its copy's event (the test and inspection seam)."""
        bid, row = self.store[int(key)]
        b = self._pbatch[bid]
        _wait(b.ready)
        return b.tsdf[row].numpy(), b.weight[row].numpy(), b.color[row].numpy(), b.coords[row]

    def _reload_keys(self, want: np.ndarray) -> None:
        """Reload stored blocks, grouped by batch: each batch goes back to
        the device in one stream-ordered copy and its wanted rows scatter in
        one call. Keys the full pool refused stay in the store."""
        groups: Dict[int, list] = {}
        for k in want.tolist():
            bid, row = self.store[int(k)]
            groups.setdefault(bid, []).append((int(k), row))
        dev = self.vol.tsdf.device
        n_deferred = 0
        for bid, items in groups.items():
            b = self._pbatch[bid]
            rows = torch.tensor([r for _, r in items], dtype=torch.int64, device=dev)
            keys = torch.tensor([k for k, _ in items], dtype=torch.int32, device=dev)
            crd = torch.from_numpy(b.coords[[r for _, r in items]]).to(dev)
            bt, bw, bc = (a.to(dev, non_blocking=True) for a in (b.tsdf, b.weight, b.color))
            self.vol, vals, n_merged = _scatter_reload(self.vol, keys, crd, bt[rows], bw[rows],
                                                       bc[rows], self.cfg)
            self.n_reload_merged += n_merged
            for i, (k, _r) in enumerate(items):
                if vals[i] < 0:
                    n_deferred += 1
                    continue
                self.n_blocks_reloaded += 1
                del self.store[k]
                self._stored_cks.pop(k, None)
                b.live -= 1
            if b.live == 0:
                del self._pbatch[bid]
        if n_deferred:
            log_warning(f"streaming: pool full, deferred reload of {n_deferred} blocks")
        self.n_reloads += 1

    def _evict(self, cam: np.ndarray, n: int, coords: np.ndarray, cks: np.ndarray) -> np.ndarray:
        """Freeze-extract, store and compact away the far blocks. Returns the
        surviving live keys."""
        live = coords[:n]
        live_keys = pack_np(live)
        dist = self._block_dist(live, cam)
        far = dist > self.evict_dist
        excess = n - int(far.sum()) - self.high_water
        if excess > 0:
            # still over high water: the blocks within evict_dist outgrow the
            # pool, as on a revisit, which holds blocks on both sides of the
            # camera. The farthest blocks of the hysteresis band go too; they
            # are beyond reload_dist, so no tick reloads them before the
            # camera comes back within it.
            band = np.flatnonzero(~far & (dist > self.reload_dist))
            far[band[np.argsort(-dist[band], kind="stable")[:excess]]] = True
        victims = np.flatnonzero(far)
        if not len(victims):
            log_warning("streaming: pool over high water but nothing beyond reload_dist; the "
                        "working set exceeds the pool")
            return live_keys
        vkeys = live_keys[victims]
        dup = [int(k) for k in vkeys.tolist() if int(k) in self.store]
        if dup:
            # a reload the full pool deferred, whose key the camera has
            # allocated again: merge the stored payload into the live block
            # (its slot stays), so that storing the victim keeps both
            log_warning(f"streaming: {len(dup)} evicted blocks merge their deferred payloads")
            self._reload_keys(np.asarray(dup, np.int32))
            cks = self._pull_state()[2]
        vset = set(vkeys.tolist())
        frozen = self.soups.keys()
        # newly frozen: victims not yet frozen, and live blocks with a victim
        # among their positive-corner suppliers (their boundary cells read it)
        shell_hit = np.isin(pack_np(live[:, None, :] + _CORNERS[None, 1:]), vkeys).any(axis=1)
        emit = [int(s) for s in victims if int(live_keys[s]) not in frozen]
        emit += [int(s) for s in np.flatnonzero(shell_hit)
                 if int(live_keys[s]) not in frozen and int(live_keys[s]) not in vset]
        t0 = time.perf_counter()
        if emit:
            self._freeze_extract(np.asarray(sorted(set(emit)), np.int64), live, live_keys, cks)
        self._acc("evict_freeze", t0)
        dev = self.vol.tsdf.device
        slots = torch.from_numpy(victims).to(dev)
        (t, w, c), ev = self._to_host(self.vol.tsdf[slots], self.vol.weight[slots],
                                      self.vol.color[slots])
        bid = self._next_bid
        self._next_bid += 1
        self._pbatch[bid] = _Batch(t, w, c, coords=live[victims].copy(), live=len(victims),
                                   ready=ev)
        for i, v in enumerate(victims):
            self.store[int(vkeys[i])] = (bid, i)
            self._stored_cks[int(vkeys[i])] = int(cks[v])
        survivors = np.flatnonzero(~far)
        perm = np.zeros(self.cfg.block_capacity, np.int64)
        perm[: len(survivors)] = survivors
        self.vol = _compact(self.vol, perm, len(survivors))
        self.n_evictions += 1
        return live_keys[survivors]

    def _freeze_extract(self, emit_slots: np.ndarray, live: np.ndarray, live_keys: np.ndarray,
                        cks: np.ndarray) -> None:
        """Cache the triangle soup of the given live blocks, whose corner
        suppliers are all resident (a block with an off-device positive
        neighbor is frozen already and never comes here). The budgets are
        the survey's exact counts: one count read, one emission, one read
        of the triangles' block keys (4 B a triangle); the vertices and
        colors go to host memory without waiting."""
        n = len(live)
        order = np.argsort(live_keys)
        skeys = live_keys[order]

        def find(want):
            pos = np.minimum(np.searchsorted(skeys, want), n - 1)
            return np.where(skeys[pos] == want, order[pos], -1)

        nsl = find(pack_np(live[emit_slots][:, None, :] + _CORNERS[None]).reshape(-1))
        nsl = nsl.reshape(-1, 8)
        # every existing +corner neighbor is live at freeze time (the freeze
        # invariant), so existence is found-in-live and its checksum at hand
        for row, s_ in zip(nsl, emit_slots):
            exist = row >= 0
            c8 = np.where(exist, cks[np.maximum(row, 0)], 0)
            self._soup_env[int(live_keys[s_])] = (exist, c8)
        sel_slots = np.unique(nsl[nsl >= 0])
        sel, nbr_sel, emit_c = mc.build_compact_selection(find, n, sel_slots, emit_slots, live,
                                                          len(sel_slots), pack=pack_np)
        dev = self.vol.tsdf.device
        sv = mc._survey(self.vol, self.cfg, sel=torch.from_numpy(sel).to(dev),
                        nbr_sel=torch.from_numpy(nbr_sel).to(dev),
                        emit_mask=torch.from_numpy(emit_c).to(dev))
        cells_budget, nt = mc.exact_budgets(sv, self.cfg, 0, 0)
        empty = np.zeros((0, 3, 3), np.float32)
        for s in emit_slots:  # a block with no triangle still freezes
            self.soups[int(live_keys[s])] = (empty, empty)
        if not nt:
            return
        v, c, _, _, cells = mc._emit(sv, self.cfg, cells_budget, nt, return_cells=True)
        R = self.cfg.block_resolution
        keys, perm = torch.sort(vhash.pack_key(torch.div(cells, R, rounding_mode="floor").T),
                                stable=True)
        tkeys = keys.cpu().numpy()
        (vs, cs), ev = self._to_host(v.permute(2, 0, 1)[perm], c.permute(2, 0, 1)[perm])
        sid = self._next_sid
        self._next_sid += 1
        sb = self._sbatch[sid] = _SoupBatch(vs, cs, refs=0, ready=ev)
        tk, start = np.unique(tkeys, return_index=True)
        end = np.append(start[1:], nt)
        for k, a, b in zip(tk.tolist(), start.tolist(), end.tolist()):
            self.soups[k] = _SoupRef(sid, a, b)
            sb.refs += 1

    def _unfreeze_sweep(self, live_keys: np.ndarray) -> None:
        """Drop cached soups whose block is live again with every existing
        positive-corner neighbor live too: live extraction re-emits them to
        the bit from the unchanged reloaded data."""
        if not self.soups:
            return
        fkeys = np.fromiter(self.soups.keys(), np.int32, len(self.soups))
        live_set = set(live_keys.tolist())
        nbrs = pack_np(unpack_np(fkeys)[:, None, :] + _CORNERS[None, 1:])
        for i, k in enumerate(fkeys.tolist()):
            if k in live_set and not any(int(nk) in self.store for nk in nbrs[i]):
                self._drop_soup(k)

    # -- extraction ------------------------------------------------------------

    def extract_mesh(self, max_cells: Optional[int] = None,
                     max_tris: Optional[int] = None) -> TriangleMeshHost:
        """The whole scene's triangle soup: live extraction of the unfrozen
        blocks plus the frozen soups, equal to the extraction of an infinite
        pool that saw the same frames (the policy contract). Runs the
        supplier rule and the stale-refresh pass first, so frames integrated
        since the last tick are reflected. The live budgets are the
        survey's exact counts, raised to ``max_cells`` / ``max_tris``
        (floors that only grow): nothing is ever truncated."""
        if max_cells:
            self.max_cells = max(self.max_cells, max_cells)
        if max_tris:
            self.max_tris = max(self.max_tris, max_tris)
        n, coords, cks = self._pull_state()
        n, coords, cks, r2 = self._supply_changed_live(n, coords, cks)
        n, coords, cks, r3 = self._refresh_frozen(n, coords, cks)
        if r2 or r3:
            self._unfreeze_sweep(pack_np(coords[:n]))
        parts_v, parts_c = [], []
        for val in self.soups.values():
            if isinstance(val, _SoupRef):
                sb = self._sbatch[val.sid]
                _wait(sb.ready)
                parts_v.append(sb.verts[val.a:val.b].numpy())
                parts_c.append(sb.cols[val.a:val.b].numpy())
            else:
                parts_v.append(val[0])
                parts_c.append(val[1])
        if n:
            cap = self.cfg.block_capacity
            emit = np.zeros((cap,), bool)
            emit[:n] = True
            if self.soups:
                emit[:n] = ~np.isin(pack_np(coords[:n]),
                                    np.fromiter(self.soups.keys(), np.int32, len(self.soups)))
            dev = self.vol.tsdf.device
            sv = mc._survey(self.vol, self.cfg, extract_blocks=mc.snap_extract_blocks(n, cap),
                            emit_mask=torch.from_numpy(emit).to(dev))
            budgets = mc.exact_budgets(sv, self.cfg, self.max_cells, self.max_tris)
            v, c, nt, _ = mc._emit(sv, self.cfg, *budgets)
            nt = int(nt)
            parts_v.append(v[:, :, :nt].permute(2, 0, 1).cpu().numpy())
            parts_c.append(c[:, :, :nt].permute(2, 0, 1).cpu().numpy())
        verts = np.concatenate(parts_v).reshape(-1, 3) if parts_v else np.zeros((0, 3), np.float32)
        cols = np.concatenate(parts_c).reshape(-1, 3) if parts_c else np.zeros((0, 3), np.float32)
        return TriangleMeshHost(vertices=verts,
                                triangles=np.arange(len(verts), dtype=np.int32).reshape(-1, 3),
                                vertex_colors=cols)

    def extract_point_cloud(self, max_points: Optional[int] = None):
        """The whole scene's surface points: the live volume's crossings
        plus the same host crossing math over the stored blocks (a block's
        data is the same on either side of the frontier, so the union equals
        an infinite pool's extraction). Host numpy (points, colors)."""
        pts, cols = tsdf_volume.extract_point_cloud(self.vol, self.cfg)
        if self.store:
            R = self.cfg.block_resolution
            by_batch: Dict[int, list] = {}
            for bid, row in self.store.values():
                by_batch.setdefault(bid, []).append(row)
            t4, w4, c5, crd = [], [], [], []
            for bid, rows in by_batch.items():
                b = self._pbatch[bid]
                _wait(b.ready)
                t4.append(b.tsdf.numpy()[rows].reshape(-1, R, R, R))
                w4.append(b.weight.numpy()[rows].reshape(-1, R, R, R))
                c5.append(b.color.numpy()[rows].transpose(0, 2, 1).reshape(-1, R, R, R, 3))
                crd.append(b.coords[rows])
            sp, sc = tsdf_volume.host_interior_crossings(
                np.concatenate(t4), np.concatenate(w4), np.concatenate(c5), np.concatenate(crd),
                self.cfg)
            pts = np.concatenate([pts, sp])
            cols = np.concatenate([cols, sc])
        if max_points is not None and pts.shape[0] > max_points:
            sel = np.random.RandomState(0).choice(pts.shape[0], max_points, replace=False)
            pts, cols = pts[sel], cols[sel]
        return pts, cols

    # -- stats -----------------------------------------------------------------

    @property
    def n_stored(self) -> int:
        return len(self.store)

    @property
    def n_frozen(self) -> int:
        return len(self.soups)

    @property
    def pinned_bytes(self) -> int:
        """Bytes the host stores hold (page-locked on a card)."""
        tensors = [t for b in self._pbatch.values() for t in (b.tsdf, b.weight, b.color)]
        tensors += [t for s in self._sbatch.values() for t in (s.verts, s.cols)]
        return sum(t.numel() * t.element_size() for t in tensors)
