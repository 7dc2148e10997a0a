"""Feature-based global registration: RANSAC with every hypothesis in
parallel (the counterpart of the JAX package's ``tracking/ransac.py``).

Each hypothesis is a 4-sample Kabsch fit (batched 3x3 SVD); the edge-length
checker (ratio 0.9) and the inlier count over all correspondences are dense
masked reductions. The best hypothesis is refined by two weighted Kabsch
rounds on its inliers. Fitness is inliers over correspondences. ``rival``
is the most inliers a checked hypothesis has among the correspondences the
refined pose leaves out: a scene that repeats gives each repeat's
hypotheses inliers of their own, a unique one only chance alignments.

The sampler is split from the scorer: :func:`ransac_registration` draws its
``(H, n)`` correspondence ranks from an explicit ``torch.Generator``, or
takes them as given. The products run in full float32
(``core.device.full_fp32_matmul``): under TF32 the feature distances would
change the nearest matches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from azurekinect3dreconstruction_tpu_torch.config import RegistrationConfig
from azurekinect3dreconstruction_tpu_torch.core.device import full_fp32_matmul
from azurekinect3dreconstruction_tpu_torch.core.fmath import dot3, f32_square


class RANSACResult(NamedTuple):
    T: torch.Tensor  # (4, 4) source -> target
    fitness: torch.Tensor
    inlier_rmse: torch.Tensor
    n_correspondences: torch.Tensor
    rival: torch.Tensor  # int: the strongest hypothesis's inliers outside the pose's


def match_features(feat_src, feat_tgt, mask_src, mask_tgt, mutual: bool = True):
    """Nearest-neighbor feature correspondences, optionally mutual: int64
    target index per source point, -1 where unmatched. The (N, M) distance
    matrix is one matrix product."""
    fs = feat_src.to(torch.float32)
    ft = feat_tgt.to(torch.float32)
    with full_fp32_matmul():
        d = (fs * fs).sum(dim=1)[:, None] - 2.0 * (fs @ ft.T) + (ft * ft).sum(dim=1)[None, :]
    big = 1e9
    d = torch.where(mask_src[:, None] & mask_tgt[None, :], d, big)
    nn_st = torch.argmin(d, dim=1)
    ok = mask_src & (torch.gather(d, 1, nn_st[:, None])[:, 0] < big)
    if mutual:
        nn_ts = torch.argmin(d, dim=0)
        ok = ok & (nn_ts[nn_st] == torch.arange(fs.shape[0], device=fs.device))
    return torch.where(ok, nn_st, -1)


def _kabsch(src, tgt, w):
    """Weighted rigid fit src -> tgt: (R (..., 3, 3), t (..., 3)) from
    src/tgt (..., n, 3) and weights (..., n)."""
    wsum = torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    ws = (w / wsum)[..., None]
    cs = (src * ws).sum(dim=-2, keepdim=True)
    ct = (tgt * ws).sum(dim=-2, keepdim=True)
    with full_fp32_matmul():
        H = ((src - cs) * ws).transpose(-1, -2) @ (tgt - ct)  # (..., 3, 3)
        U, _, Vt = torch.linalg.svd(H)
        V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
        D = torch.diag_embed(torch.stack([torch.ones_like(H[..., 0, 0]),
                                          torch.ones_like(H[..., 0, 0]),
                                          torch.linalg.det(V @ Ut)], dim=-1))
        R = V @ (D @ Ut)
        t = ct[..., 0, :] - (R @ cs[..., 0, :, None])[..., 0]
    return R, t


def draw_samples(n_corr, hypotheses: int, n: int, generator: torch.Generator):
    """(H, n) ranks drawn uniformly from [0, n_corr) on the generator's
    device; ``n_corr`` may be a device tensor (no host synchronization)."""
    u = torch.rand((hypotheses, n), generator=generator, device=generator.device)
    hi = torch.clamp_min(torch.as_tensor(n_corr, device=u.device), 1)
    return torch.minimum((u * hi).to(torch.int64), hi - 1)


def ransac_registration(src_points, tgt_points, corr,
                        cfg: RegistrationConfig = RegistrationConfig(),
                        distance_threshold: Optional[float] = None,
                        generator: Optional[torch.Generator] = None,
                        samples=None) -> RANSACResult:
    """RANSAC over correspondences ``corr`` (source i -> target corr[i], -1
    unmatched). Each hypothesis samples ``cfg.ransac_n`` correspondences by
    rank among the valid ones: ``samples`` (int (H, n) ranks) when given,
    else drawn from ``generator``."""
    # a given threshold is squared in float32, the default as a constant
    thr2 = ((cfg.icp_distance_threshold * 1.5) ** 2 if distance_threshold is None
            else f32_square(distance_threshold))
    src = src_points.to(torch.float32)
    tgt = tgt_points.to(torch.float32)
    ok = corr >= 0
    q = tgt[torch.where(ok, corr, 0)]  # matched target point per source point
    n_corr = ok.to(torch.int32).sum()
    n = cfg.ransac_n
    if samples is None:
        if generator is None:
            raise ValueError("ransac_registration needs a generator or samples")
        samples = draw_samples(n_corr, cfg.ransac_hypotheses, n, generator)
    rank_to_idx = torch.argsort((~ok).to(torch.int8), stable=True)  # valid entries first
    samp = rank_to_idx[samples.to(device=src.device, dtype=torch.int64)]  # (H, n)
    s_pts, t_pts = src[samp], q[samp]

    # edge-length checker: every sample pair's edge lengths agree within the ratio
    iu = torch.triu_indices(n, n, offset=1, device=src.device)

    def edges(a):
        e = torch.linalg.vector_norm(a[:, :, None, :] - a[:, None, :, :], dim=-1)
        return e[:, iu[0], iu[1]]

    es, et = edges(s_pts), edges(t_pts)
    ratio = torch.minimum(es, et) / torch.clamp_min(torch.maximum(es, et), 1e-9)
    edge_ok = (ratio > cfg.edge_length_check).all(dim=1)

    R, t = _kabsch(s_pts, t_pts, torch.ones(samp.shape, dtype=torch.float32,
                                             device=src.device))
    # score every hypothesis over all correspondences: (H, N, 3)
    with full_fp32_matmul():
        proj = torch.einsum("hij,nj->hni", R, src) + t[:, None, :]
    diff = proj - q[None]
    d2 = dot3(diff, diff)
    inl_h = (d2 < thr2) & ok[None, :]
    n_inl = inl_h.sum(dim=1)
    best = torch.argmax(torch.where(edge_ok, n_inl, -1))

    def residual2(R_, t_):
        with full_fp32_matmul():
            p = src @ R_.T + t_
        return dot3(p - q, p - q)

    T_R, T_t = R[best], t[best]
    for _ in range(2):  # refine: weighted Kabsch on the best hypothesis's inliers
        w_in = ((residual2(T_R, T_t) < thr2) & ok).to(torch.float32)
        T_R, T_t = _kabsch(src, q, w_in)
    d2b = residual2(T_R, T_t)
    inl = (d2b < thr2) & ok
    n_f = inl.to(torch.int32).sum()
    fitness = n_f / torch.clamp_min(n_corr, 1)
    rmse = torch.sqrt(torch.where(inl, d2b, 0.0).sum() / torch.clamp_min(n_f, 1))
    rival = torch.where(edge_ok, (inl_h & ~inl).sum(dim=1), 0).max()
    T = torch.eye(4, dtype=torch.float32, device=src.device)
    T[:3, :3] = T_R
    T[:3, 3] = T_t
    return RANSACResult(T=T, fitness=fitness, inlier_rmse=rmse, n_correspondences=n_corr,
                        rival=rival)


def global_registration(src_points, src_feat, src_mask, tgt_points, tgt_feat, tgt_mask,
                        cfg: RegistrationConfig = RegistrationConfig(),
                        distance_threshold: Optional[float] = None,
                        generator: Optional[torch.Generator] = None,
                        samples=None) -> RANSACResult:
    """Mutual FPFH matching, then :func:`ransac_registration`; points with
    an all-zero descriptor take no part."""
    ok_s = src_mask & (src_feat.abs().sum(dim=1) > 0)
    ok_t = tgt_mask & (tgt_feat.abs().sum(dim=1) > 0)
    corr = match_features(src_feat, tgt_feat, ok_s, ok_t, mutual=True)
    return ransac_registration(src_points, tgt_points, corr, cfg, distance_threshold,
                               generator=generator, samples=samples)
