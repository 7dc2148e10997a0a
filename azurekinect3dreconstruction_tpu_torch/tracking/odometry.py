"""Hybrid photometric + geometric RGB-D odometry: result type, weights, and
the dense Gauss-Newton of the JAX package's ``tracking/odometry.py``.

Convention (as in the JAX package): ``T_target_source`` takes source-camera
points into the target camera; the photometric term warps *source* pixels
into the *target* image.

Two Gauss-Newton loops exist, as in the JAX package:

- ``ops.kernels.odometry_kernels.compute_odometry_fast`` — the live loop's,
  kernel B2 on the card: Jacobians from the *source* gradients, an early
  exit on convergence;
- :func:`compute_odometry` here — the reference's plain XLA form, which the
  offline bundle tracks with: Jacobians from the *target* gradients sampled
  at the warped pixel, a fixed number of iterations per level, and the
  normal equations as one ``J^T J`` product. It is plain PyTorch on every
  device, because the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from azurekinect3dreconstruction_tpu_torch.config import OdometryConfig
from azurekinect3dreconstruction_tpu_torch.core import linalg, se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.device import full_fp32_matmul
from azurekinect3dreconstruction_tpu_torch.core.fmath import fma, rcp32
from azurekinect3dreconstruction_tpu_torch.ops.backproject import bilinear_sample
from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid, sobel_gradients


class OdometryResult(NamedTuple):
    T_target_source: torch.Tensor  # (4, 4)
    fitness: torch.Tensor  # inlier fraction of valid source pixels
    rmse: torch.Tensor  # final weighted residual RMS
    inliers: torch.Tensor  # int32 count


def huber_weight(r, delta: float):
    """IRLS Huber weight of a scaled residual: 1 inside ``delta``, else
    ``delta / |r|``."""
    a = torch.abs(r)
    d = torch.full((), delta, dtype=a.dtype, device=a.device)  # a true division on any device
    return torch.where(a <= delta, 1.0, d / torch.clamp_min(a, 1e-12))


def dp_dxi(jx, jy, jz, px, py, pz):
    """Point Jacobian (jx, jy, jz) contracted with dp'/dxi = [I | -hat(p')]:
    its 6 entries."""
    return (jx, jy, jz, -jy * pz + jz * py, jx * pz - jz * px, -jx * py + jy * px)


def _level_step(T, src, tgt, intr: Intrinsics, cfg: OdometryConfig):
    """One Gauss-Newton iteration at one level: (T', (fitness, rmse, n_valid)).

    ``src`` = (intensity, depth) of the source level; ``tgt`` = its target
    planes stacked (H, W, 6): intensity, depth, and the Sobel gradients of
    both. The warp and the bounds test round as the reference's compiled
    form does (``/ f`` as a multiply by the float32 reciprocal, fused
    multiply-adds): at the identity a whole border column sits on the
    ``u < W - 1`` edge."""
    i_s, z = src
    h, w = z.shape
    dev = z.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    x = (u - intr.cx) * rcp32(intr.fx) * z
    y = (v - intr.cy) * rcp32(intr.fy) * z
    valid_s = (z > cfg.min_depth) & (z < cfg.max_depth)

    P = T[:3].reshape(-1)
    px = fma(P[2], z, fma(P[0], x, P[1] * y)) + P[3]
    py = fma(P[6], z, fma(P[4], x, P[5] * y)) + P[7]
    pz = fma(P[10], z, fma(P[8], x, P[9] * y)) + P[11]
    zs = torch.clamp_min(pz, 1e-6)
    uv = torch.stack([fma(px / zs, intr.fx, intr.cx), fma(py / zs, intr.fy, intr.cy)], dim=-1)
    smp, inb = bilinear_sample(tgt, uv)
    it_w, dt_w, gx, gy, gdx, gdy = smp.unbind(-1)

    r_i = it_w - i_s
    r_d = dt_w - pz
    valid = (valid_s & inb & (pz > cfg.min_depth) & (dt_w > cfg.min_depth)
             & (torch.abs(r_d) < cfg.max_depth_diff))

    inv_z = 1.0 / zs
    ju0, ju2 = intr.fx * inv_z, -intr.fx * px * inv_z * inv_z
    jv1, jv2 = intr.fy * inv_z, -intr.fy * py * inv_z * inv_z
    J_i = torch.stack(dp_dxi(gx * ju0, gy * jv1, gx * ju2 + gy * jv2, px, py, pz), dim=-1)
    # geometric: d r_d / dxi = grad(D_t) J_uv dp'/dxi - e_z dp'/dxi
    J_d = torch.stack(dp_dxi(gdx * ju0, gdy * jv1, gdx * ju2 + gdy * jv2 - 1.0, px, py, pz),
                      dim=-1)

    s_i = 1.0 / cfg.sigma_intensity
    s_d = 1.0 / cfg.sigma_depth
    vf = valid.to(torch.float32)
    w_i = huber_weight(r_i * s_i, cfg.huber_delta) * vf
    w_d = huber_weight(r_d * s_d, cfg.huber_delta) * vf
    if cfg.term == "color":
        w_d = torch.zeros_like(w_d)
    elif cfg.term == "depth":
        w_i = torch.zeros_like(w_i)

    # rows and residuals carry the sqrt-weights w * s, so the normal
    # equations are IRLS with Huber weights w
    J = torch.cat([(J_i * (w_i * s_i)[..., None]).reshape(-1, 6),
                   (J_d * (w_d * s_d)[..., None]).reshape(-1, 6)])
    r = torch.cat([(r_i * w_i * s_i).reshape(-1), (r_d * w_d * s_d).reshape(-1)])
    JtJ = J.T @ J
    Jtr = J.T @ r

    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    delta = linalg.solve_spd6(JtJ + cfg.damping * eye6, -Jtr)
    delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
    T_new = se3.se3_exp(delta) @ T

    n_valid = valid.sum(dtype=torch.int32)
    sq = torch.where(valid, (r_i * s_i) ** 2 + (r_d * s_d) ** 2, 0.0).sum()
    rmse = torch.sqrt(sq / torch.clamp_min(n_valid, 1))
    fitness = n_valid / torch.clamp_min(valid_s.sum(dtype=torch.int32), 1)
    return T_new, (fitness, rmse, n_valid)


def compute_odometry(intensity_s, depth_s, intensity_t, depth_t, intr: Intrinsics,
                     cfg: OdometryConfig = OdometryConfig(), init=None) -> OdometryResult:
    """Dense hybrid odometry source -> target over the image pyramid, coarse
    to fine, ``cfg.pyramid_iters[l]`` iterations at level ``l`` (0 the
    finest), each one applied: there is no convergence exit. A level with
    no iterations passes the pose and the statistics through.

    intensity_*: (H, W) float32 in [0, 1]; depth_*: (H, W) float32 metres
    (0 invalid), all on one device; the result stays there and nothing
    waits on the host."""
    dev = depth_s.device
    levels = len(cfg.pyramid_iters)
    pyr_s = build_pyramid(intensity_s, depth_s, levels)
    pyr_t = build_pyramid(intensity_t, depth_t, levels)
    T = (torch.eye(4, dtype=torch.float32, device=dev) if init is None
         else init.to(device=dev, dtype=torch.float32))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    stats = (zero, zero, torch.zeros((), dtype=torch.int32, device=dev))
    with full_fp32_matmul():
        for lvl in reversed(range(levels)):
            if cfg.pyramid_iters[lvl] <= 0:
                continue
            i_t, d_t = pyr_t[lvl]
            gx, gy = sobel_gradients(i_t)
            gdx, gdy = sobel_gradients(d_t)
            # depth gradients are meaningless next to invalid pixels
            dv = d_t > 0
            ok = (dv & torch.roll(dv, 1, 0) & torch.roll(dv, -1, 0)
                  & torch.roll(dv, 1, 1) & torch.roll(dv, -1, 1))
            tgt = torch.stack([i_t, d_t, gx, gy, torch.where(ok, gdx, 0.0),
                               torch.where(ok, gdy, 0.0)], dim=-1)
            lintr = intr.scaled(1.0 / (1 << lvl))
            for _ in range(cfg.pyramid_iters[lvl]):
                T, stats = _level_step(T, pyr_s[lvl], tgt, lintr, cfg)
    fitness, rmse, n_valid = stats
    return OdometryResult(T_target_source=T, fitness=fitness, rmse=rmse, inliers=n_valid)


def compute_odometry_frames(frame_s, frame_t, intr: Intrinsics,
                            cfg: OdometryConfig = OdometryConfig(), init=None) -> OdometryResult:
    """:func:`compute_odometry` on a pair of ``core.types.RGBDFrame``."""
    return compute_odometry(frame_s.intensity, frame_s.depth, frame_t.intensity, frame_t.depth,
                            intr, cfg, init)
