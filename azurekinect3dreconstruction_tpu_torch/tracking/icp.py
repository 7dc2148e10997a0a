"""ICP (the counterparts of the JAX package's ``tracking/icp.py``):
projective point-to-plane and colored ICP against a camera's organized
maps, and, for two unorganized clouds, point-to-plane (``icp_grid``) and
point-to-point ICP and ``evaluate_registration`` with nearest neighbors
from the grid hash of ``ops.neighbors``; ``free_space_shares`` checks a
transform between two depth images against the space each camera sees as
empty.

Correspondences are projective: the source cloud, moved by the current
estimate, projects into the target camera's organized maps (points,
normals, intensity), which is a fixed-shape nearest/bilinear sample. Colored
ICP adds Park et al.'s photometric term, weighted ``1 - lambda_geometric``,
with its gradient from the target intensity image. Fitness is inliers over
valid source points; the RMSE is over the inliers.

Every iteration stays on the device. The normal equations are summed as
elementwise products (no matrix product), solved by
:func:`core.linalg.solve_spd6`, and the 4x4 pose products run under
``core.device.full_fp32_matmul``, so no TF32 enters on any card. The early
exit of the JAX while-loop becomes a device-side ``done`` flag that freezes
the pose and the stats.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import RegistrationConfig
from azurekinect3dreconstruction_tpu_torch.core import linalg, se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.device import full_fp32_matmul
from azurekinect3dreconstruction_tpu_torch.core.fmath import fma
from azurekinect3dreconstruction_tpu_torch.ops.backproject import (
    backproject_depth,
    bilinear_sample,
    nearest_sample,
)
from azurekinect3dreconstruction_tpu_torch.ops.image import sobel_gradients
from azurekinect3dreconstruction_tpu_torch.ops.normals import organized_normals


class ICPResult(NamedTuple):
    T: torch.Tensor  # (4, 4) transform source -> target frame
    fitness: torch.Tensor
    inlier_rmse: torch.Tensor
    inliers: torch.Tensor  # int32


class TargetMaps(NamedTuple):
    """Organized target-frame geometry for projective association."""

    points: torch.Tensor  # (H, W, 3) camera-space points (z = 0 invalid)
    normals: torch.Tensor  # (H, W, 3) unit normals (0 invalid)
    intensity: Optional[torch.Tensor] = None  # (H, W)
    grad_u: Optional[torch.Tensor] = None
    grad_v: Optional[torch.Tensor] = None

    @staticmethod
    def from_depth(depth, rays, intensity=None) -> "TargetMaps":
        """Maps of one depth frame; ``rays`` from ``core.camera.pixel_rays``."""
        pts = backproject_depth(depth, rays)
        gu = gv = None
        if intensity is not None:
            gu, gv = sobel_gradients(intensity)
        return TargetMaps(points=pts, normals=organized_normals(pts), intensity=intensity,
                          grad_u=gu, grad_v=gv)


def _project(p, intr: Intrinsics):
    """Camera points (N, 3) -> (uv (N, 2), z clamped to 1e-6)."""
    zs = torch.clamp_min(p[..., 2], 1e-6)
    return torch.stack([fma(p[..., 0] / zs, intr.fx, intr.cx),
                        fma(p[..., 1] / zs, intr.fy, intr.cy)], dim=-1), zs


def _normal_equations(J, r):
    """(J^T J, J^T r) of rows J (N, 6) and residuals r (N,) in float32,
    from elementwise products and sums."""
    return (J[:, :, None] * J[:, None, :]).sum(dim=0), (J * r[:, None]).sum(dim=0)


def _associate(T, src_pts, src_mask, tgt: TargetMaps, intr: Intrinsics, dist_thr: float):
    """Projective association of the source moved by ``T``: (moved points,
    their pixels, clamped depths, the target normals there, point-to-plane
    residuals, distances, the valid mask)."""
    p = se3.transform_points(T, src_pts)
    uv, zs = _project(p, intr)
    q, inb = nearest_sample(tgt.points, uv)
    n, _ = nearest_sample(tgt.normals, uv)
    has_n = (n * n).sum(dim=-1) > 0.5
    diff = p - q
    dist = torch.linalg.vector_norm(diff, dim=-1)
    r_g = (diff * n).sum(dim=-1)
    valid = src_mask & inb & (p[..., 2] > 1e-4) & (q[..., 2] > 0) & has_n & (dist < dist_thr)
    return p, uv, zs, n, r_g, dist, valid


def _gn_step(T, src_pts, src_int, src_mask, tgt: TargetMaps, intr: Intrinsics,
             dist_thr: float, lambda_geometric: float, colored: bool):
    """One Gauss-Newton step: (T_new, (fitness, rmse, inliers), |delta|)."""
    p, uv, zs, n, r_g, dist, valid = _associate(T, src_pts, src_mask, tgt, intr, dist_thr)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]

    w = valid.to(torch.float32)
    J_g = torch.cat([n, torch.linalg.cross(p, n)], dim=-1)  # (N, 6): [n, p x n]
    sg = lambda_geometric ** 0.5 if colored else 1.0
    rows_J = [J_g * (w[..., None] * sg)]
    rows_r = [r_g * w * sg]
    if colored:
        it, _ = bilinear_sample(tgt.intensity, uv)
        gu, _ = bilinear_sample(tgt.grad_u, uv)
        gv, _ = bilinear_sample(tgt.grad_v, uv)
        r_c = it - src_int
        inv_z = 1.0 / zs
        zero = torch.zeros_like(pz)
        ju = torch.stack([intr.fx * inv_z, zero, -intr.fx * px * inv_z * inv_z], -1)
        jv = torch.stack([zero, intr.fy * inv_z, -intr.fy * py * inv_z * inv_z], -1)
        jp = gu[..., None] * ju + gv[..., None] * jv  # (N, 3) dI/dp'
        jw = torch.stack([jp[..., 0], jp[..., 1], jp[..., 2],
                          -jp[..., 1] * pz + jp[..., 2] * py,
                          jp[..., 0] * pz - jp[..., 2] * px,
                          -jp[..., 0] * py + jp[..., 1] * px], dim=-1)
        sc = (1.0 - lambda_geometric) ** 0.5
        rows_J.append(jw * (w[..., None] * sc))
        rows_r.append(r_c * w * sc)
    JtJ, Jtr = _normal_equations(torch.cat(rows_J), torch.cat(rows_r))
    eye6 = torch.eye(6, dtype=torch.float32, device=JtJ.device)
    delta = linalg.solve_spd6(JtJ + 1e-6 * eye6, -Jtr)
    delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
    T_new = se3.se3_exp(delta) @ T

    n_in = valid.to(torch.int32).sum()
    n_src = src_mask.to(torch.int32).sum()
    fitness = n_in / torch.clamp_min(n_src, 1)
    rmse = torch.sqrt(torch.where(valid, dist * dist, 0.0).sum() / torch.clamp_min(n_in, 1))
    return T_new, (fitness, rmse, n_in), torch.linalg.vector_norm(delta)


def icp_projective(src_points, src_mask, tgt: TargetMaps, intr: Intrinsics, init=None,
                   max_iters: int = 30, dist_thr: float = 0.05,
                   lambda_geometric: float = 0.968, colored: bool = False,
                   src_intensity=None, rel_tol: float = 1e-6) -> ICPResult:
    """Register a flat (N, 3) masked source cloud onto organized target maps.
    Returns ``T`` with ``T @ src ~= target-frame geometry``.

    Iteration stops once a step's tangent-space norm falls below
    ``rel_tol`` (0 runs all ``max_iters``). The stop is a device flag: all
    ``max_iters`` steps are computed, and from the one after the flag is set
    on, the pose and the stats stay frozen — the JAX while-loop's result,
    with no host synchronization."""
    src_points = src_points.to(torch.float32)
    src_mask = src_mask.to(torch.bool)
    dev = src_points.device
    if src_intensity is None:
        src_intensity = torch.zeros(src_points.shape[:-1], dtype=torch.float32, device=dev)
    T = torch.eye(4, dtype=torch.float32, device=dev) if init is None else init.to(torch.float32)
    fitness = torch.zeros((), dtype=torch.float32, device=dev)
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    n_in = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    with full_fp32_matmul():
        for _ in range(max_iters):
            T2, (f2, r2, n2), dnorm = _gn_step(T, src_points, src_intensity, src_mask, tgt,
                                               intr, dist_thr, lambda_geometric, colored)
            T = torch.where(done, T, T2)
            fitness = torch.where(done, fitness, f2.to(torch.float32))
            rmse = torch.where(done, rmse, r2)
            n_in = torch.where(done, n_in, n2)
            done = done | (dnorm < rel_tol)
    return ICPResult(T=T, fitness=fitness, inlier_rmse=rmse, inliers=n_in)


# frame-to-model's refinement keeps its correction along the directions
# whose point-to-plane information is at least this share of the largest
# (on a wall the rest slid and spun the pose off the scene)
F2M_HELD_RATIO = 0.02


def keep_held_directions(T, init, src_points, src_mask, tgt: TargetMaps, intr: Intrinsics,
                         dist_thr: float, ratio: float):
    """``T``, a point-to-plane ICP result from ``init``, with its correction
    (the twist of ``T @ init^-1``) kept only along the directions the
    geometry holds: the eigenvectors of the point-to-plane normal matrix at
    ``T`` whose eigenvalue is at least ``ratio`` of the largest. A plane
    holds nothing along itself or about its normal; there the correction is
    whatever the iterations drifted to, and ``init`` stands instead. When
    every direction is held, ``T`` is returned as it is."""
    p, _, _, n, _, _, valid = _associate(T, src_points, src_mask, tgt, intr, dist_thr)
    J = torch.cat([n, torch.linalg.cross(p, n)], dim=-1) * valid.to(torch.float32)[..., None]
    JtJ, _ = _normal_equations(J, torch.zeros_like(J[:, 0]))
    lam, V = linalg.eigh_sym6(JtJ.to(torch.float64))
    held = (lam >= ratio * lam.max()).to(torch.float64)
    T64, init64 = T.to(torch.float64), init.to(torch.float64)
    xi = se3.se3_log(T64 @ se3.inverse(init64))
    kept = se3.se3_exp(V @ (held * (V.T @ xi))) @ init64
    return torch.where(held.bool().all(), T, kept.to(torch.float32))


class GraphedICP:
    """Frame-to-model's refinement: point-to-plane :func:`icp_projective`
    with fixed parameters, its correction then kept only along the
    directions the geometry holds (:func:`keep_held_directions` at
    :data:`F2M_HELD_RATIO`), replayed as one CUDA graph on CUDA tensors.

    An ICP of ``max_iters`` steps is ~600 small PyTorch operations a step,
    so on the card it is bound by the host issuing them, not by the device.
    Every shape is static and nothing waits on the host, so the whole chain
    is captured once per input shape and replayed: the host then enqueues six
    copies and one graph launch. On CPU tensors it runs the chain op by op.
    A replay computes what the eager chain computes, launch for launch, so
    the two agree to the bit."""

    def __init__(self, intr: Intrinsics, max_iters: int, dist_thr: float,
                 rel_tol: float = 1e-6):
        self.intr = intr
        self.kw = dict(max_iters=max_iters, dist_thr=dist_thr, rel_tol=rel_tol)
        self._graphs = {}  # (device, shapes) -> (static inputs, graph, static outputs)

    def _run(self, src_points, src_mask, points, normals, init) -> ICPResult:
        tgt = TargetMaps(points, normals)
        r = icp_projective(src_points, src_mask, tgt, self.intr, init=init, **self.kw)
        return r._replace(T=keep_held_directions(r.T, init, src_points, src_mask, tgt, self.intr,
                                                 self.kw["dist_thr"], F2M_HELD_RATIO))

    def _capture(self, inputs):
        static = tuple(t.clone() for t in inputs)
        dev = static[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run(*static)  # warm-up: lazy initialisation stays out of the graph
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._run(*static)
        return static, graph, tuple(out)

    def __call__(self, src_points, src_mask, tgt: TargetMaps, init) -> ICPResult:
        inputs = (src_points.to(torch.float32), src_mask.to(torch.bool),
                  tgt.points, tgt.normals, init.to(torch.float32))
        if not src_points.is_cuda:
            return self._run(*inputs)
        key = (src_points.device, *(tuple(t.shape) for t in inputs))
        if key not in self._graphs:
            self._graphs[key] = self._capture(inputs)
        static, graph, out = self._graphs[key]
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        graph.replay()
        return ICPResult(*(t.clone() for t in out))


def icp_point_to_plane(src_points, src_mask, tgt: TargetMaps, intr: Intrinsics, init=None,
                       cfg: RegistrationConfig = RegistrationConfig()) -> ICPResult:
    """Point-to-plane ICP with the registration config's budget and gate."""
    return icp_projective(src_points, src_mask, tgt, intr, init=init,
                          max_iters=cfg.icp_max_iters, dist_thr=cfg.icp_distance_threshold)


def colored_icp(src_points, src_intensity, src_mask, tgt: TargetMaps, intr: Intrinsics,
                init=None, cfg: RegistrationConfig = RegistrationConfig()) -> ICPResult:
    """Colored ICP (geometric + photometric) with the config's budget."""
    return icp_projective(src_points, src_mask, tgt, intr, init=init,
                          max_iters=cfg.colored_icp_max_iters,
                          dist_thr=cfg.icp_distance_threshold,
                          lambda_geometric=cfg.colored_icp_lambda_geometric,
                          colored=True, src_intensity=src_intensity)


# -- cloud-to-cloud registration through the grid hash (no camera) ------------


def _stats(ok, dist, src_mask):
    """(fitness, rmse, inliers) of nearest-neighbor correspondences."""
    n_in = ok.to(torch.int32).sum()
    fit = n_in / torch.clamp_min(src_mask.to(torch.int32).sum(), 1)
    rmse = torch.sqrt(torch.where(ok, dist * dist, 0.0).sum() / torch.clamp_min(n_in, 1))
    return fit, rmse, n_in


def _identity_or(init, device):
    return (torch.eye(4, dtype=torch.float32, device=device) if init is None
            else init.to(device=device, dtype=torch.float32))


def icp_grid(src_points, src_mask, tgt_points, tgt_normals, tgt_mask, init=None,
             max_iters: int = 30, dist_thr: float = 0.05, capacity: int = 16384,
             max_per_cell: int = 8) -> ICPResult:
    """Point-to-plane ICP between two unorganized clouds, ``max_iters``
    Gauss-Newton steps. Correspondences are the 1-NN through the grid hash
    (cell size ``dist_thr``, so the 27-cell search covers the gate)."""
    from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
        build_cell_lists,
        knn_gather,
    )

    src = src_points.to(torch.float32)
    tgt = tgt_points.to(torch.float32)
    nrm = tgt_normals.to(torch.float32)
    cells = build_cell_lists(tgt, tgt_mask, dist_thr, capacity, max_per_cell)
    T = _identity_or(init, src.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=src.device)
    with full_fp32_matmul():
        for _ in range(max_iters):
            p = se3.transform_points(T, src)
            nn, dist = knn_gather(cells, tgt, p, src_mask, k=1, max_radius=dist_thr)
            ok = src_mask & (nn[:, 0] >= 0)
            idx = torch.where(ok, nn[:, 0], 0).to(torch.int64)
            q, n = tgt[idx], nrm[idx]
            ok = ok & ((n * n).sum(dim=-1) > 0.5)
            w = ok.to(torch.float32)
            J = torch.cat([n, torch.linalg.cross(p, n)], dim=-1) * w[:, None]
            JtJ, Jtr = _normal_equations(J, ((p - q) * n).sum(dim=-1) * w)
            delta = linalg.solve_spd6(JtJ + 1e-6 * eye6, -Jtr)
            delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
            T = se3.se3_exp(delta) @ T
            fit, rmse, n_in = _stats(ok, dist[:, 0], src_mask)
    return ICPResult(T=T, fitness=fit, inlier_rmse=rmse, inliers=n_in)


def icp_point_to_point(src_points, src_mask, tgt_points, tgt_mask, init=None,
                       max_iters: int = 30, dist_thr: float = 0.05, capacity: int = 16384,
                       max_per_cell: int = 8, cell_size: Optional[float] = None) -> ICPResult:
    """Point-to-point ICP between two unorganized clouds: per iteration the
    1-NN correspondences through the grid hash, then the closed-form
    weighted Kabsch update. ``cell_size`` below ``dist_thr`` (down to half
    of it) keeps a dense target from being thinned to ``max_per_cell``
    points per cell; the search then reaches ``1.5 * cell_size``."""
    from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
        build_cell_lists,
        knn_gather,
    )

    src = src_points.to(torch.float32)
    tgt = tgt_points.to(torch.float32)
    cs = float(cell_size) if cell_size is not None else dist_thr
    cells = build_cell_lists(tgt, tgt_mask, cs, capacity, max_per_cell)
    reach = min(float(np.float32(dist_thr)), float(np.float32(1.5 * cs)))
    T = _identity_or(init, src.device)
    eye3 = torch.eye(3, dtype=torch.float32, device=src.device)
    with full_fp32_matmul():
        for _ in range(max_iters):
            p = se3.transform_points(T, src)
            nn, dist = knn_gather(cells, tgt, p, src_mask, k=1, max_radius=reach)
            ok = src_mask & (nn[:, 0] >= 0)
            w = ok.to(torch.float32)[:, None]
            q = tgt[torch.where(ok, nn[:, 0], 0).to(torch.int64)]
            nw = torch.clamp_min(w.sum(), 1.0)
            cp, cq = (p * w).sum(dim=0) / nw, (q * w).sum(dim=0) / nw
            H = ((p - cp) * w).T @ ((q - cq) * w)
            u, _, vt = torch.linalg.svd(H)
            d = torch.sign(torch.linalg.det(vt.T @ u.T))
            R = vt.T @ (torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
                        @ u.T)
            t = cq - R @ cp
            good = torch.isfinite(R).all() & torch.isfinite(t).all()
            dT = torch.eye(4, dtype=torch.float32, device=src.device)
            dT[:3, :3] = torch.where(good, R, eye3)
            dT[:3, 3] = torch.where(good, t, 0.0)
            T = dT @ T
            fit, rmse, n_in = _stats(ok, dist[:, 0], src_mask)
    return ICPResult(T=T, fitness=fit, inlier_rmse=rmse, inliers=n_in)


def evaluate_registration(src_points, src_mask, tgt_points, tgt_mask, T,
                          dist_thr: float = 0.02, capacity: int = 16384):
    """(fitness, inlier_rmse) of ``T`` applied to the source against the
    target: the share of masked source points with a target point within
    ``dist_thr``, and their RMS distance."""
    from azurekinect3dreconstruction_tpu_torch.ops.neighbors import (
        build_cell_lists,
        knn_gather,
    )

    tgt = tgt_points.to(torch.float32)
    cells = build_cell_lists(tgt, tgt_mask, dist_thr, capacity)
    p = se3.transform_points(T.to(torch.float32), src_points.to(torch.float32))
    nn, dist = knn_gather(cells, tgt, p, src_mask, k=1, max_radius=dist_thr)
    fit, rmse, _ = _stats(src_mask & (nn[:, 0] >= 0), dist[:, 0], src_mask)
    return fit, rmse


# the free-space gate: a pixel is in front of the other camera's surface
# when it lies more than max(3 cm, 3.5 sigma of the difference of the two
# depths) in front of it, sigma from each frame's own noise
# (``relative_depth_noise``), and a transform passes when at most 3 % of
# either camera's pixels do
FREE_SPACE_BAND_M = 0.03
FREE_SPACE_BAND_SIGMAS = 3.5
FREE_SPACE_MAX_SHARE = 0.03
# the median of |n[i-1] - 2 n[i] + n[i+1]| for unit gaussian n: the median
# of |N(0, 1)| times sqrt(6)
_MAD_D2 = 0.6744897501960817 * 6.0 ** 0.5


def relative_depth_noise(depth):
    """The relative noise sigma (noise sd over depth) of one depth image,
    a float32 scalar: the median of ``|z[i-1] - 2 z[i] + z[i+1]| / z[i]``
    over the rows' and columns' runs of three valid pixels, over
    ``_MAD_D2``. Smooth surfaces leave second differences near 0 and
    edges are too few to move the median, so it reads the sensor's noise
    from the frame itself (0 for mm-quantized noise-free depth)."""
    runs = []
    for a, b, c in ((depth[:, :-2], depth[:, 1:-1], depth[:, 2:]),
                    (depth[:-2], depth[1:-1], depth[2:])):
        d2 = ((a - 2.0 * b + c) / torch.where(b > 0, b, 1.0)).abs()
        runs.append(torch.where((a > 0) & (b > 0) & (c > 0), d2, float("nan")).reshape(-1))
    return torch.nan_to_num(torch.cat(runs).nanmedian()) / _MAD_D2


def free_space_band(depth_a, depth_b):
    """The band's relative part for two depth images, a float32 scalar:
    ``FREE_SPACE_BAND_SIGMAS`` sigma of the difference of their depths,
    ``FREE_SPACE_BAND_SIGMAS * hypot(sigma_a, sigma_b)`` with each sigma
    the image's ``relative_depth_noise``."""
    return FREE_SPACE_BAND_SIGMAS * torch.hypot(relative_depth_noise(depth_a),
                                                relative_depth_noise(depth_b))


def free_space_shares(depth_a, intr_a: Intrinsics, depth_b, rays_b, T_ab, band):
    """Free-space consistency of ``T_ab`` (camera b's frame to camera a's):
    b's valid depth pixels, moved into a's frame, go to their nearest pixel
    of a's depth image ``depth_a``. Of those that land on a valid pixel with
    positive depth on both sides, returns two float32 shares: ``in_front``,
    more than the band ``max(FREE_SPACE_BAND_M, band * z_a)`` in front of
    a's measured depth ``z_a`` (``band`` from ``free_space_band``), in
    space camera a sees as empty (at the true transform only noise tails and edge pixels
    land there); and ``agree``, within the band of it. Nearest-neighbor
    overlap cannot see a surface slid along itself or through empty space;
    this can."""
    return free_space_shares_of_points(backproject_depth(depth_b, rays_b).reshape(-1, 3),
                                       depth_b.reshape(-1) > 0, depth_a, intr_a, T_ab, band)


def free_space_shares_of_points(points, mask, depth_a, intr_a: Intrinsics, T, band):
    """:func:`free_space_shares` for a masked (N, 3) cloud moved into camera
    a's frame by ``T``: the (in_front, agree) shares of its points that
    land on a valid pixel of ``depth_a``."""
    p = se3.transform_points(T.to(torch.float32), points.to(torch.float32))
    uv, _ = _project(p, intr_a)
    z_a, inb = nearest_sample(depth_a, uv)
    seen = mask & inb & (p[:, 2] > 1e-4) & (z_a > 0)
    tol = torch.clamp_min(z_a * band, FREE_SPACE_BAND_M)
    gap = z_a - p[:, 2]
    n = torch.clamp_min(seen.to(torch.int32).sum(), 1)
    in_front = (seen & (gap > tol)).to(torch.int32).sum() / n
    agree = (seen & (gap.abs() <= tol)).to(torch.int32).sum() / n
    return in_front, agree


def _projective_match(src_points, src_mask, tgt: TargetMaps, intr: Intrinsics, T,
                      dist_thr: float):
    """(pixels, visible, matched, distances) of ``src`` under ``T``:
    ``visible`` source points project in bounds onto valid target depth and
    normals with positive depth on both sides; ``matched`` are the visible
    ones within ``dist_thr`` of their target point."""
    p = se3.transform_points(T.to(torch.float32), src_points.to(torch.float32))
    uv, _ = _project(p, intr)
    q, inb = nearest_sample(tgt.points, uv)
    n, _ = nearest_sample(tgt.normals, uv)
    has_n = (n * n).sum(dim=-1) > 0.5
    visible = src_mask & inb & (p[..., 2] > 1e-4) & (q[..., 2] > 0) & has_n
    dist = torch.linalg.vector_norm(p - q, dim=-1)
    return uv, visible, visible & (dist < dist_thr), dist


def projective_overlap(src_points, src_mask, tgt: TargetMaps, intr: Intrinsics, T,
                       dist_thr: float = 0.05):
    """(matched, visible, rmse) of ``src`` under ``T`` against organized
    target maps (see :func:`_projective_match`)."""
    _, visible, matched, dist = _projective_match(src_points, src_mask, tgt, intr, T, dist_thr)
    n_m = matched.to(torch.int32).sum()
    rmse = torch.sqrt(torch.where(matched, dist * dist, 0.0).sum() / torch.clamp_min(n_m, 1))
    return n_m, visible.to(torch.int32).sum(), rmse


def photometric_agreement(src_points, src_intensity, src_mask, tgt: TargetMaps, intr: Intrinsics,
                          T, dist_thr: float = 0.05):
    """Texture consistency of ``src`` under ``T`` against organized target
    maps with ``intensity``: over the points :func:`projective_overlap`
    matches, the zero-mean normalized cross-correlation of their own
    intensities with the target's at the pixels they project to (bilinear).
    Returns float32 scalars (correlation, spread): the correlation is 1 for
    the same texture up to gain and offset (an exposure change) and falls
    toward 0 and below as the texture slides; ``spread`` is the standard
    deviation of the matched source intensities, near 0 on a texture-less
    surface, where the correlation says nothing. A surface slid along
    itself keeps its geometric overlap; this sees the slide wherever the
    surface has texture."""
    uv, _, matched, _ = _projective_match(src_points, src_mask, tgt, intr, T, dist_thr)
    it, inb = bilinear_sample(tgt.intensity, uv)
    w = (matched & inb).to(torch.float32)
    n_m = torch.clamp_min(w.sum(), 1.0)
    a = src_intensity.to(torch.float32) - (w * src_intensity).sum() / n_m
    b = it - (w * it).sum() / n_m
    va, vb = (w * a * a).sum(), (w * b * b).sum()
    corr = (w * a * b).sum() / torch.sqrt(torch.clamp_min(va * vb, 1e-20))
    return corr, torch.sqrt(va / n_m)
