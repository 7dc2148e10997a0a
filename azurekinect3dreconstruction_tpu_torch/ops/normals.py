"""Normal estimation (the counterparts of the JAX package's ``ops/normals.py``):

- :func:`organized_normals`: central-difference normals of an organized
  point map, no neighbor search;
- :func:`pca_normal`: the smallest-eigenvector normal of masked
  neighborhoods, which ``ops.neighbors.estimate_normals_knn`` feeds;
- :func:`orient_normals_consistent`: flip normals so that neighbors agree,
  by a breadth-first search on the host over the grid-hash KNN graph.
"""

from __future__ import annotations

import numpy as np
import torch


def organized_normals(points, max_edge: float = 0.1):
    """(H, W, 3) organized camera-space points -> (H, W, 3) unit normals
    oriented toward the camera.

    Central differences of the 4-neighborhood (``roll``, which wraps); a
    normal is zero where a neighbor is invalid, a stencil edge is longer
    than ``max_edge`` (a depth discontinuity) or the cross product
    vanishes, and on the one-pixel image border."""
    p = points
    valid = p[..., 2] > 0
    du = torch.roll(p, -1, dims=1) - torch.roll(p, 1, dims=1)
    dv = torch.roll(p, -1, dims=0) - torch.roll(p, 1, dims=0)
    n = torch.linalg.cross(du, dv)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp_min(norm, 1e-12)
    ok = (valid & torch.roll(valid, -1, dims=1) & torch.roll(valid, 1, dims=1)
          & torch.roll(valid, -1, dims=0) & torch.roll(valid, 1, dims=0)
          & (torch.linalg.vector_norm(du, dim=-1) < max_edge)
          & (torch.linalg.vector_norm(dv, dim=-1) < max_edge)
          & (norm[..., 0] > 1e-12))
    flip = (n * p).sum(dim=-1) > 0
    n = torch.where(flip[..., None], -n, n)
    n = torch.where(ok[..., None], n, 0.0)
    n[0], n[-1], n[:, 0], n[:, -1] = 0.0, 0.0, 0.0, 0.0
    return n


# neighborhoods per batched ``eigh`` call: cuSOLVER's batched 3x3 solver
# refused batches of 32,768 and 184,320 (CUSOLVER_STATUS_INVALID_VALUE on an
# H100, torch 2.11 / CUDA 12.8) and took 16,384
_EIGH_BATCH = 1 << 13


def pca_normal(neighbors, mask):
    """Normal of each (..., K, 3) neighborhood under its (..., K) mask: the
    eigenvector of the smallest eigenvalue of the masked covariance (a
    batched 3x3 ``eigh``, in batches of ``_EIGH_BATCH``), defined up to
    sign. The covariance is summed elementwise, so no TF32 product enters on
    any card."""
    w = mask.to(torch.float32)[..., None]
    cnt = torch.clamp_min(w.sum(dim=-2), 1.0)  # (..., 1)
    mean = (neighbors * w).sum(dim=-2, keepdim=True) / cnt[..., None, :]
    d = (neighbors - mean) * w
    cov = (d[..., :, :, None] * d[..., :, None, :]).sum(dim=-3) / cnt[..., None]
    vecs = [torch.linalg.eigh(c)[1][..., 0]  # eigenvalues ascend
            for c in cov.reshape(-1, 3, 3).split(_EIGH_BATCH)]
    return torch.cat(vecs).reshape(cov.shape[:-1])


def orient_normals_consistent(points, normals, mask, radius: float, k: int = 16):
    """Flip normals so that neighboring normals agree.

    The KNN graph (radius ``radius``, ``k`` neighbors) comes from the grid
    hash on the points' device and is symmetrized on the host; a
    level-synchronous BFS, batched per frontier in numpy, gives each point a
    sign relative to its component's seed, and each component then takes
    the global sign that agrees with the majority of its incoming normals.
    A viewpoint-oriented input so keeps its orientation and only local
    inconsistencies are repaired. Returns a tensor on the points' device."""
    from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
        auto_capacity,
        build_cell_lists,
        knn_gather,
    )

    pts = points.to(torch.float32)
    n = pts.shape[0]
    cells = build_cell_lists(pts, mask, radius, auto_capacity(n), max_per_cell=8)
    idx, _ = knn_gather(cells, pts, pts, mask, k=k, max_radius=radius)
    idx = idx.cpu().numpy()
    m = mask.cpu().numpy()
    nr0 = normals.to(torch.float32).cpu().numpy()
    sign = np.zeros(n, np.int8)  # 0 = unvisited; +-1 = sign against the component seed

    # symmetrized edges: grid-hash KNN is asymmetric (an overflowing cell
    # drops a point from candidate lists while it keeps its own neighbors)
    src0 = np.repeat(np.arange(n), idx.shape[1])
    dst0 = idx.reshape(-1)
    e_ok = (dst0 >= 0) & (dst0 != src0) & m[src0] & m[np.maximum(dst0, 0)]
    src = np.concatenate([src0[e_ok], dst0[e_ok]])
    dst = np.concatenate([dst0[e_ok], src0[e_ok]])
    # CSR adjacency, so each BFS level touches only its frontier's edges
    eorder = np.argsort(src, kind="stable")
    src, dst = src[eorder], dst[eorder]
    starts = np.searchsorted(src, np.arange(n + 1))

    def frontier_edges(frontier):
        base = starts[frontier]
        cnt = starts[frontier + 1] - base
        total = int(cnt.sum())
        if not total:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        first = np.cumsum(cnt) - cnt
        eidx = np.arange(total) - np.repeat(first, cnt) + np.repeat(base, cnt)
        return src[eidx], dst[eidx]

    for seed in range(n):
        if sign[seed] != 0 or not m[seed]:
            continue
        sign[seed] = 1
        comp = [seed]
        frontier = np.array([seed])
        while frontier.size:
            parent, child = frontier_edges(frontier)
            keep = sign[child] == 0 if child.size else np.empty(0, bool)
            parent, child = parent[keep], child[keep]
            if not child.size:
                break
            child, first = np.unique(child, return_index=True)  # first parent wins
            parent = parent[first]
            agree = np.einsum("ij,ij->i", nr0[child], nr0[parent]) >= 0
            sign[child] = np.where(agree, sign[parent], -sign[parent])
            comp.extend(child.tolist())
            frontier = child
        comp = np.asarray(comp)
        if sign[comp].sum() < 0:  # keep the majority of the incoming orientation
            sign[comp] = -sign[comp]

    out = nr0 * np.where(sign == 0, 1, sign)[:, None].astype(np.float32)
    return torch.from_numpy(out).to(points.device)
