"""Incremental mesh extraction for live loops (the counterpart of the JAX
package's ``tsdf/incremental.py``).

A live scan changes only the blocks the current frame touches, so instead
of extracting the whole mesh on every refresh this extractor:

1. finds the changed blocks by the pool's content stamp
   (:func:`tsdf.volume.content_checksums`, one transfer);
2. re-extracts only those blocks and the 7 negative-corner neighbors whose
   boundary cells read them, through the compact form of
   ``extract_mesh_arrays`` (a host-built slot selection and neighbor map,
   :func:`tsdf.marching_cubes.build_compact_selection`) while the touched
   neighborhood is a minority of the scene, else through the full prefix
   pass with an emit mask. Untouched alive blocks still supply corner
   values, so every vertex is bit-identical to a full extraction's;
3. keeps a host triangle soup, one contiguous array and a block -> span
   index, and patches it: the alive slices of the previous soup plus the
   re-extracted groups, in one concatenate.

The budgets come from exact counts (``marching_cubes.exact_budgets``), as in
``extract_mesh``: one count read, one emission, no retry. An update that
extracts makes three transfers: the stamp, the counts, and one pull of the
vertices, colors and cells of the live triangles (float32, as the emission
gives them).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.types import TriangleMeshHost
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import mc_tables as mt
from azurekinect3dreconstruction_tpu_torch.tsdf.volume import TSDFVolume, content_checksums

_CORNERS = np.asarray(mt.CORNER_OFFSETS)  # (8, 3), code 0 = self


def _pack_np(coords: np.ndarray) -> np.ndarray:
    """(..., 3) int block coords -> int64 keys (host-side, vectorized)."""
    c = coords.astype(np.int64)
    return c[..., 0] + (c[..., 1] << 21) + (c[..., 2] << 42)


class IncrementalExtractor:
    """``update(vol)`` returns the whole scene's mesh as a triangle soup,
    re-extracting only the blocks that changed since the last update.

    ``max_cells`` / ``max_tris``: floors of each emission's budgets, which
    rise to the update's exact counts, so nothing is ever truncated.
    ``last_touched`` (blocks re-extracted), ``last_mode`` ("compact",
    "full" or "none"), ``last_pull_bytes`` (the geometry pull) and
    ``timings`` (seconds per stage: checksum, select, extract_pull, patch)
    describe the last update."""

    def __init__(self, cfg: TSDFConfig, max_cells: int = 1 << 20, max_tris: int = 1 << 18):
        self.cfg = cfg
        self.max_cells = max_cells
        self.max_tris = max_tris
        self.last_pull_bytes = 0
        self.last_touched = 0
        self.last_mode = "none"
        self.timings: Dict[str, float] = {}
        self.reset()

    def reset(self) -> None:
        self._soup_v = np.zeros((0, 3, 3), np.float32)
        self._soup_c = np.zeros((0, 3, 3), np.float32)
        self._spans: Dict[int, Tuple[int, int]] = {}  # packed block key -> (start, count)
        self._prev_ws: Optional[np.ndarray] = None
        self._prev_mono: Optional[np.ndarray] = None
        self._prev_nb = 0
        self._assembled: Optional[TriangleMeshHost] = None
        self._ak_coords: Optional[np.ndarray] = None  # coords the sorted-key index covers
        self._ak_order: Optional[np.ndarray] = None
        self._ak_sorted: Optional[np.ndarray] = None

    def _index(self, coords: np.ndarray) -> None:
        """Sorted packed-key index over the alive block coords, rebuilt
        whenever the slot -> key mapping changed at all (a pool that grew,
        or slots that were reassigned at a constant count)."""
        if self._ak_coords is None or not np.array_equal(self._ak_coords, coords):
            keys = _pack_np(coords)
            self._ak_order = np.argsort(keys)
            self._ak_sorted = keys[self._ak_order]
            self._ak_coords = coords.copy()

    def _find(self, want: np.ndarray) -> np.ndarray:
        """Pool slots of packed keys ``want`` (-1 where absent)."""
        nb = len(self._ak_sorted)
        pos = np.minimum(np.searchsorted(self._ak_sorted, want), nb - 1)
        hit = self._ak_sorted[pos] == want
        return np.where(hit, self._ak_order[pos], -1)

    def update(self, vol: TSDFVolume) -> TriangleMeshHost:
        """Refresh the soup against the volume's current state and return
        the full scene."""
        N = vol.tsdf.shape[0]
        tms = self.timings = {}
        t0 = time.perf_counter()
        cks = content_checksums(vol).cpu().numpy()  # the one (6, N) transfer
        tms["checksum"] = time.perf_counter() - t0
        ws, mono, nb = cks[0], cks[1], int(cks[2, 0])
        # the monotonic weight sum falls only when the volume was reset, even
        # where the pool has already regrown past its old size
        if nb < self._prev_nb or (self._prev_mono is not None
                                  and bool(np.any(mono < self._prev_mono))):
            self.reset()
        first = self._prev_ws is None
        if first:
            changed = np.arange(N) < nb
        else:
            changed = (ws != self._prev_ws) & (np.arange(N) < nb)
        self._prev_ws, self._prev_mono, self._prev_nb = ws, mono, nb
        self.last_touched = int(changed.sum())
        self.last_mode = "none"

        if self.last_touched:
            t0 = time.perf_counter()
            coords = np.ascontiguousarray(cks[3:6, :nb].T)
            self._index(coords)
            # a changed block's surface also moves the boundary cells of its
            # 7 negative-corner neighbors (a cell reads its corners at +1)
            chg = coords[changed[:nb]]
            nslot = self._find(_pack_np(chg[:, None, :] - _CORNERS[None]).reshape(-1))
            emit_idx = np.unique(nslot[nslot >= 0])
            self.last_touched = len(emit_idx)
            # compact while the touched neighborhood (the emitting blocks and
            # their alive positive-corner suppliers) is a minority of the
            # scene; past that the full prefix pass is cheaper, and the first
            # update has no soup to patch
            use_compact = False
            if not first:
                nsl = self._find(_pack_np(coords[emit_idx][:, None, :]
                                          + _CORNERS[None]).reshape(-1))
                sel_slots = np.unique(nsl[nsl >= 0])
                use_compact = 2 * len(sel_slots) < nb
            dev = vol.tsdf.device
            if use_compact:
                sel, nbr_sel, emit = mc.build_compact_selection(
                    self._find, nb, sel_slots, emit_idx, coords, len(sel_slots), pack=_pack_np)
                sv = mc._survey(vol, self.cfg, sel=torch.from_numpy(sel).to(dev),
                                nbr_sel=torch.from_numpy(nbr_sel).to(dev),
                                emit_mask=torch.from_numpy(emit).to(dev))
            else:
                emit_mask = None
                if not first:
                    emit_mask = np.zeros((N,), bool)
                    emit_mask[emit_idx] = True
                    emit_mask = torch.from_numpy(emit_mask).to(dev)
                sv = mc._survey(vol, self.cfg, extract_blocks=mc.snap_extract_blocks(nb, N),
                                emit_mask=emit_mask)
            self.last_mode = "compact" if use_compact else "full"
            tms["select"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            cells_budget, tris_budget = mc.exact_budgets(sv, self.cfg, self.max_cells,
                                                         self.max_tris)
            v, c, n_tris, _, cells = mc._emit(sv, self.cfg, cells_budget, tris_budget,
                                              return_cells=True)
            nt = int(n_tris)
            # one pull: vertices and colors (3, 3, nt) each, and the cells
            # (3, nt) carried as float32 bit patterns
            packed = torch.cat([v[:, :, :nt].reshape(9, nt), c[:, :, :nt].reshape(9, nt),
                                cells[:, :nt].view(torch.float32)]).cpu().numpy()
            self.last_pull_bytes = packed.nbytes
            tms["extract_pull"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            verts = packed[:9].reshape(3, 3, nt).transpose(2, 0, 1)  # (tri, vertex, xyz)
            vcols = packed[9:18].reshape(3, 3, nt).transpose(2, 0, 1)
            blk = np.ascontiguousarray(packed[18:]).view(np.int32).T.astype(np.int64) \
                // self.cfg.block_resolution
            self._patch(verts, vcols, blk, coords, emit_idx)
            tms["patch"] = time.perf_counter() - t0

        if self._assembled is None:
            self._assembled = TriangleMeshHost(vertices=np.zeros((0, 3), np.float32),
                                               triangles=np.zeros((0, 3), np.int32),
                                               vertex_colors=np.zeros((0, 3), np.float32))
        return self._assembled

    def _patch(self, verts, vcols, blk, coords, emit_idx) -> None:
        """Patch the soup with the pulled triangles (``blk``: each one's
        source block): every emitting block's old span goes (a block that
        now emits nothing must vanish), spans of dead blocks are pruned, and
        the pull lands at the tail as it came. Spans are keyed by the packed
        block key."""
        keys = _pack_np(blk)
        # the emission walks its rows (blocks) in order, and each row's cells
        # in order, so each block's triangles arrive as one run
        starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]]) if len(keys) else keys
        ends = np.r_[starts[1:], len(keys)]
        emitted = set(_pack_np(coords[emit_idx]).tolist())
        alive = set(_pack_np(coords).tolist())
        keep = sorted(((k, s) for k, s in self._spans.items() if k not in emitted and k in alive),
                      key=lambda kv: kv[1][0])
        runs = []  # merged contiguous alive slices of the old soup
        spans: Dict[int, Tuple[int, int]] = {}
        cur = 0
        for k, (a, n) in keep:
            if runs and runs[-1][1] == a:
                runs[-1][1] = a + n
            else:
                runs.append([a, a + n])
            spans[k] = (cur, n)
            cur += n
        for k, a, b in zip(keys[starts].tolist(), starts.tolist(), ends.tolist()):
            spans[k] = (cur + a, b - a)
        self._soup_v = np.concatenate([self._soup_v[a:b] for a, b in runs] + [verts])
        self._soup_c = np.concatenate([self._soup_c[a:b] for a, b in runs] + [vcols])
        self._spans = spans
        n = self._soup_v.shape[0]
        self._assembled = TriangleMeshHost(
            vertices=self._soup_v.reshape(-1, 3),
            triangles=np.arange(3 * n, dtype=np.int32).reshape(-1, 3),
            vertex_colors=self._soup_c.reshape(-1, 3))
