"""FPFH features (Fast Point Feature Histograms), batched and fixed-shape:
the counterpart of the JAX package's ``tracking/features.py``.

Neighborhoods come from the grid-hash KNN (:mod:`..ops.neighbors`). Per
point pair, the Darboux-frame angles (alpha, phi, theta) are binned into
3 x 11 bins (Rusu et al. 2009); FPFH = SPFH(p) + the inverse-distance
weighted mean of the neighbors' SPFH, L1-normalized per point.
"""

from __future__ import annotations

import math

import torch

from azurekinect3dreconstruction_tpu_torch.core.fmath import rcp32
from azurekinect3dreconstruction_tpu_torch.ops.neighbors import knn

N_BINS = 11
FEATURE_DIM = 3 * N_BINS


def _pair_angles(p, n_p, q, n_q):
    """Darboux-frame features of point pairs (..., 3): (alpha, phi, theta,
    valid, distance)."""
    d = q - p
    dist = torch.linalg.vector_norm(d, dim=-1)
    ok = dist > 1e-9
    dn = d / torch.clamp_min(dist, 1e-9)[..., None]
    u = n_p.expand_as(dn)
    v = torch.linalg.cross(dn, u)
    vn = torch.linalg.vector_norm(v, dim=-1)
    ok = ok & (vn > 1e-6)
    v = v / torch.clamp_min(vn, 1e-9)[..., None]
    w = torch.linalg.cross(u, v)
    alpha = (v * n_q).sum(dim=-1)
    phi = (u * dn).sum(dim=-1)
    theta = torch.atan2((w * n_q).sum(dim=-1), (u * n_q).sum(dim=-1))
    return alpha, phi, theta, ok, dist


def _histogram(vals, lo: float, hi: float, weights):
    """(..., K) values -> (..., N_BINS) weighted histogram over [lo, hi]."""
    # the division by a constant compiles to a multiply by its float32 reciprocal
    t = torch.clamp((vals - lo) * rcp32(hi - lo), 0.0, 1.0 - 1e-6)
    b = torch.floor(t * N_BINS).to(torch.int64)
    onehot = b[..., None] == torch.arange(N_BINS, device=vals.device)
    return (onehot * weights[..., None]).sum(dim=-2)


def compute_fpfh(points, normals, mask, radius: float = 0.05, k: int = 16,
                 capacity: int = 16384):
    """(N, 3) points + unit normals + mask -> (N, 33) FPFH descriptors; a
    point with fewer than 3 neighbors within ``radius`` gets zeros."""
    pts = points.to(torch.float32)
    nrm = normals.to(torch.float32)
    nn, dist = knn(pts, mask, radius, k=k, capacity=capacity)
    ok_n = nn >= 0
    nn_c = torch.where(ok_n, nn, 0).to(torch.int64)
    alpha, phi, theta, ok_pair, _ = _pair_angles(pts[:, None, :], nrm[:, None, :], pts[nn_c],
                                                 nrm[nn_c])
    w = (ok_n & ok_pair & mask[:, None]).to(torch.float32)
    spfh = torch.cat([_histogram(alpha, -1.0, 1.0, w), _histogram(phi, -1.0, 1.0, w),
                      _histogram(theta, -math.pi, math.pi, w)], dim=-1)  # (N, 33)
    spfh = spfh / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1.0)
    inv_d = torch.where(ok_n & (dist > 1e-9), 1.0 / torch.clamp_min(dist, 1e-9), 0.0)
    wsum = torch.clamp_min(inv_d.sum(dim=-1, keepdim=True), 1e-9)
    fpfh = spfh + (spfh[nn_c] * inv_d[..., None]).sum(dim=1) / wsum
    l1 = fpfh.abs().sum(dim=-1, keepdim=True)
    fpfh = torch.where(l1 > 1e-9, fpfh / l1, 0.0)
    return torch.where((mask & (ok_n.sum(dim=-1) >= 3))[:, None], fpfh, 0.0)
