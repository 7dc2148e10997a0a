"""Trajectory accuracy metrics: ATE and RPE (TUM RGB-D benchmark style).

The reference has NO accuracy evaluation anywhere — its only "metrics" are
per-frame registration fitness prints (GoodColorReconstruction.py:671-681)
and ad-hoc acceptance thresholds (:183,200,256). Tracking quality is the
thing a SLAM framework must be able to QUANTIFY, so this module provides
the two standard trajectory measures used by every RGB-D SLAM evaluation:

- **ATE** (absolute trajectory error): rigidly align the estimated
  trajectory to ground truth (closed-form Umeyama/Horn fit over the
  positions), then report statistics of the residual position errors.
  Measures global consistency — loop closure / drift accumulation.
- **RPE** (relative pose error): for every pair of poses ``delta`` frames
  apart, compare the estimated relative motion against ground truth.
  Measures local tracking quality independent of accumulated drift.

Host-side numpy: trajectories are O(100s-1000s) of 4x4s, evaluation runs
once per scan (bench/tests/tools), never in the per-frame hot path.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["align_umeyama", "ate", "rpe"]


def _positions(traj: Sequence[np.ndarray]) -> np.ndarray:
    T = np.asarray(traj, np.float64)
    if T.ndim != 3 or T.shape[-2:] != (4, 4):
        raise ValueError(f"expected (N, 4, 4) pose array, got {T.shape}")
    return T[:, :3, 3]


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid fit ``dst ~= s * R @ src + t`` over point rows.

    Closed-form (Umeyama 1991, the SVD/Horn solution with the
    reflection-correcting determinant sign). Returns (s, R (3,3), t (3,)).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 3:
        raise ValueError(f"expected matching (N, 3) arrays, "
                         f"got {src.shape} vs {dst.shape}")
    if src.shape[0] < 3:
        raise ValueError("need >= 3 points for a stable rigid fit")
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate(traj_est: Sequence[np.ndarray], traj_gt: Sequence[np.ndarray],
        align: bool = True) -> dict:
    """Absolute trajectory error of camera POSITIONS (meters).

    ``align=True`` (standard) removes the best rigid fit first, so the
    number measures trajectory SHAPE error (drift), not the arbitrary
    choice of world origin; ``align=False`` compares in the shared world
    frame directly (both trajectories must use the same frame-0 anchor).

    Returns {"rmse", "mean", "median", "max"} in meters plus
    "final_drift": the UNALIGNED position error of the last pose — the
    number a user experiences when resuming a scan at the end.
    """
    p_est, p_gt = _positions(traj_est), _positions(traj_gt)
    if p_est.shape != p_gt.shape:
        raise ValueError(f"trajectory lengths differ: "
                         f"{p_est.shape[0]} vs {p_gt.shape[0]}")
    final_drift = float(np.linalg.norm(p_est[-1] - p_gt[-1]))
    if align:
        if p_est.shape[0] < 3:
            # refusing beats silently returning the UNALIGNED error under
            # the aligned label
            raise ValueError(f"aligned ATE needs >= 3 poses (got "
                             f"{p_est.shape[0]}); pass align=False to "
                             "compare in the shared world frame")
        s, R, t = align_umeyama(p_est, p_gt)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "final_drift": final_drift,
    }


def rpe(traj_est: Sequence[np.ndarray], traj_gt: Sequence[np.ndarray],
        delta: int = 1) -> dict:
    """Relative pose error over all pose pairs ``delta`` frames apart.

    Returns {"trans_rmse" (m), "rot_rmse" (rad)} — the local per-step
    tracking error, insensitive to accumulated drift.
    """
    Te = np.asarray(traj_est, np.float64)
    Tg = np.asarray(traj_gt, np.float64)
    if Te.shape != Tg.shape or Te.ndim != 3 or Te.shape[-2:] != (4, 4):
        raise ValueError(f"expected matching (N, 4, 4), "
                         f"got {Te.shape} vs {Tg.shape}")
    n = Te.shape[0]
    if not (0 < delta < n):
        raise ValueError(f"delta {delta} out of range for {n} poses")
    t_err, r_err = [], []
    for i in range(n - delta):
        de = np.linalg.inv(Te[i]) @ Te[i + delta]
        dg = np.linalg.inv(Tg[i]) @ Tg[i + delta]
        E = np.linalg.inv(dg) @ de
        t_err.append(np.linalg.norm(E[:3, 3]))
        # rotation angle of the 3x3 error block
        c = np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_err.append(np.arccos(c))
    t_err, r_err = np.asarray(t_err), np.asarray(r_err)
    return {
        "trans_rmse": float(np.sqrt(np.mean(t_err ** 2))),
        "rot_rmse": float(np.sqrt(np.mean(r_err ** 2))),
    }
