"""Voxel-grid neighbor machinery for unorganized point clouds (no KD-tree).

The counterparts of the JAX package's ``ops/neighbors.py``, built from two
fixed-shape primitives: a stable sort by cell, and the spatial hash of
:mod:`..tsdf.hash` (cell key -> slot). They give voxel means (downsample),
fixed-fanout cell lists, and K-nearest queries over the 27-cell
neighborhood, all with static shapes and no host synchronization.

The port's hash may number cells in another order than JAX's, so a
downsample returns the same cells in another row order. The cell lists keep,
in an overflowing cell, the ``max_per_cell`` lowest point indices (a stable
sort by slot), which does not depend on the slot numbers; so the KNN
candidate lists, and with them every query result, are the JAX package's.
K-nearest selection is a stable ascending sort, which orders ties by
candidate index as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.core.fmath import dot3, f32_square
from azurekinect3dreconstruction_tpu_torch.tsdf import hash as vhash

_OFFS27 = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2),
                               indexing="ij"), -1).reshape(27, 3).astype(np.int32)
_COORD_LIMIT = 1 << 20  # floor() is clamped here before the int cast


def _scalar(x, device) -> torch.Tensor:
    """A float32 0-d tensor made on ``device`` (no host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def _cell_coords(points, cell_size):
    """floor(points / cell_size) as int32 (a true float32 division)."""
    c = torch.floor(points / _scalar(cell_size, points.device))
    return torch.clamp(c, -_COORD_LIMIT, _COORD_LIMIT).to(torch.int32)


def _cell_keys(points, mask, cell_size):
    keys = vhash.pack_key(torch.clamp(_cell_coords(points, cell_size), -511, 511))
    return torch.where(mask, keys, vhash.EMPTY_KEY)


def _next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _insert_cells(keys, capacity: int):
    """Cell keys -> slot per point (``capacity`` where the key is empty or
    did not fit), and the table."""
    dev = keys.device
    table, _, vals, _ = vhash.insert(vhash.HashTable.empty(2 * _next_pow2(capacity), dev),
                                     torch.zeros((), dtype=torch.int32, device=dev), keys,
                                     capacity)
    return table, torch.where(vals >= 0, vals, capacity).to(torch.int64)


def voxel_downsample_arrays(points, mask, voxel_size, capacity: int, colors=None,
                            normals=None):
    """Voxel-mean downsample: the centroid of the masked points of each
    voxel, colors averaged and normals summed then normalized.

    Returns (points, mask, colors, normals) with ``capacity`` rows (colors
    and normals ``None`` when not given). Cells past the capacity are
    dropped; :func:`count_occupied_cells` sizes a voxel to fit."""
    pts = points.to(torch.float32)
    _, slot = _insert_cells(_cell_keys(pts, mask, voxel_size), capacity)
    m = mask.to(torch.float32)[:, None]

    def accum(a):
        out = torch.zeros((capacity + 1, a.shape[1]), dtype=torch.float32, device=pts.device)
        return out.index_add_(0, slot, a)[:capacity]

    cnt = accum(m)
    denom = torch.clamp_min(cnt, 1.0)
    out_cols = None if colors is None else accum(colors.to(torch.float32) * m) / denom
    out_nrm = None
    if normals is not None:
        s = accum(normals.to(torch.float32) * m)
        out_nrm = s / torch.clamp_min(torch.linalg.vector_norm(s, dim=-1, keepdim=True), 1e-12)
    return accum(pts * m) / denom, cnt[:, 0] > 0, out_cols, out_nrm


def count_occupied_cells(points, mask, cell_size):
    """Exact number of distinct occupied cells at ``cell_size`` (sort and
    adjacent difference, no table); an int64 0-d tensor."""
    sk = torch.sort(_cell_keys(points.to(torch.float32), mask, cell_size)).values
    first = torch.cat([sk[:1] != vhash.EMPTY_KEY,
                       (sk[1:] != sk[:-1]) & (sk[1:] != vhash.EMPTY_KEY)])
    return first.sum()


def auto_capacity(n_points: int, floor: int = 4096) -> int:
    """Cell-table capacity that cannot overflow for ``n_points`` points."""
    return max(floor, _next_pow2(max(n_points, 1)))


class CellLists(NamedTuple):
    """Fixed-fanout cell -> point-index lists for neighbor queries."""

    table_keys: torch.Tensor
    table_vals: torch.Tensor
    lists: torch.Tensor  # int32 (capacity, max_per_cell), -1 padded
    cell_size: torch.Tensor  # float32 0-d


def build_cell_lists(points, mask, cell_size, capacity: int, max_per_cell: int = 8
                     ) -> CellLists:
    """Bucket the masked points into grid cells of ``cell_size``. A cell
    holding more than ``max_per_cell`` points keeps its lowest point
    indices."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    dev = pts.device
    table, slot = _insert_cells(_cell_keys(pts, mask, cell_size), capacity)
    # rank of each point within its cell: stable sort by slot, index in the run
    order = torch.argsort(slot, stable=True)
    sorted_slot = slot[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       sorted_slot[1:] != sorted_slot[:-1]])
    iota = torch.arange(n, device=dev)
    rank = iota - torch.cummax(torch.where(first, iota, 0), dim=0).values
    # overflowing ranks go to the spare row ``capacity``, which is cut off
    row = torch.where((rank < max_per_cell) & (sorted_slot < capacity), sorted_slot, capacity)
    col = torch.clamp(rank, 0, max_per_cell - 1)
    lists = torch.full((capacity + 1, max_per_cell), -1, dtype=torch.int32, device=dev)
    lists[row, col] = order.to(torch.int32)
    return CellLists(table.keys, table.vals, lists[:capacity], _scalar(cell_size, dev))


def _smallest_k(values, k: int):
    """(values, indices) of the k smallest entries of each row, ascending,
    ties in index order: ``jax.lax.top_k`` of the negated rows."""
    v, i = torch.sort(values, dim=1, stable=True)
    return v[:, :k], i[:, :k]


def knn_gather(cells: CellLists, all_points, query_points, query_mask, k: int = 16,
               max_radius=float("inf")):
    """K nearest neighbors of each query among the bucketed points, from the
    27 cells around it. Returns (idx int32 (Q, k), -1 padded; dist float32
    (Q, k), inf padded), nearest first."""
    q = query_points.to(torch.float32)
    Q = q.shape[0]
    dev = q.device
    coords = _cell_coords(q, cells.cell_size)
    nbr = coords[:, None, :] + torch.from_numpy(_OFFS27).to(dev)[None]  # (Q, 27, 3)
    slots = vhash.lookup(vhash.HashTable(cells.table_keys, cells.table_vals),
                         vhash.pack_key(torch.clamp(nbr, -511, 511)))
    cand = cells.lists[torch.where(slots >= 0, slots, 0).to(torch.int64)]  # (Q, 27, P)
    cand = torch.where(slots[..., None] >= 0, cand, -1).reshape(Q, -1)
    cand_ok = cand >= 0
    cpts = all_points.to(torch.float32)[torch.where(cand_ok, cand, 0).to(torch.int64)]
    diff = cpts - q[:, None, :]
    d2 = dot3(diff, diff)
    d2 = torch.where(cand_ok & query_mask[:, None] & (d2 <= f32_square(max_radius)), d2,
                     float("inf"))
    d2k, idx = _smallest_k(d2, k)
    finite = torch.isfinite(d2k)
    nn = torch.where(finite, torch.gather(cand, 1, idx), -1)
    dist = torch.where(finite, torch.sqrt(torch.clamp_min(d2k, 0.0)), float("inf"))
    return nn, dist


def knn(points, mask, radius, k: int = 16, capacity: int = 16384, max_per_cell: int = 8):
    """Self-KNN of a masked cloud within ``radius`` (each point excludes
    itself); the cell size is the radius, so the 27-cell search is complete.
    Returns (idx (N, k), dist (N, k)) as :func:`knn_gather`."""
    cells = build_cell_lists(points, mask, radius, capacity, max_per_cell)
    nn, dist = knn_gather(cells, points, points, mask, k=k + 1, max_radius=radius)
    iota = torch.arange(nn.shape[0], device=nn.device)[:, None]
    dist = torch.where(nn == iota, float("inf"), dist)
    dk, idx = _smallest_k(dist, k)
    finite = torch.isfinite(dk)
    return torch.where(finite, torch.gather(nn, 1, idx), -1), torch.where(finite, dk,
                                                                          float("inf"))


def remove_statistical_outliers(points, mask, k: int = 20, std_ratio: float = 2.0,
                                capacity: int = 16384, radius: float = 0.1):
    """Drop points whose mean K-NN distance exceeds the global mean plus
    ``std_ratio`` standard deviations, and points with no neighbor within
    ``radius``. Returns the updated mask."""
    _, dist = knn(points, mask, radius, k=k, capacity=capacity)
    have = torch.isfinite(dist)
    cnt = have.sum(dim=1)
    mean_d = torch.where(have, dist, 0.0).sum(dim=1) / torch.clamp_min(cnt, 1)
    ok = mask & (cnt > 0)
    lonely = mask & (cnt == 0)
    n_ok = torch.clamp_min(ok.sum(), 1)
    mu = torch.where(ok, mean_d, 0.0).sum() / n_ok
    var = torch.where(ok, (mean_d - mu) ** 2, 0.0).sum() / n_ok
    thr = mu + std_ratio * torch.sqrt(var)
    return mask & ~lonely & torch.where(ok, mean_d <= thr, False)


def estimate_normals_knn(points, mask, radius: float = 0.05, k: int = 16,
                         capacity: int = 16384, orient_to=None):
    """PCA normals of each point's K-NN neighborhood (the point included);
    zero where the mask is off or fewer than 3 neighbors are found. With
    ``orient_to`` (a 3-point), each normal is flipped to face it."""
    from azurekinect3dreconstruction_tpu_torch.ops.normals import pca_normal

    pts = points.to(torch.float32)
    nn, _ = knn(pts, mask, radius, k=k, capacity=capacity)
    ok = nn >= 0
    neigh = torch.cat([pts[:, None, :], pts[torch.where(ok, nn, 0).to(torch.int64)]], dim=1)
    n = pca_normal(neigh, torch.cat([mask[:, None], ok], dim=1))
    n = torch.where((mask & (ok.sum(dim=1) >= 3))[:, None], n, 0.0)
    if orient_to is not None:
        eye = orient_to if isinstance(orient_to, torch.Tensor) else torch.as_tensor(
            np.asarray(orient_to, np.float32))
        eye = eye.to(device=pts.device, dtype=torch.float32)
        flip = (n * (eye[None, :] - pts)).sum(dim=-1) < 0
        n = torch.where(flip[:, None], -n, n)
    return n
