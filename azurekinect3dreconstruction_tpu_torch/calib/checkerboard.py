"""Checkerboard intrinsic + stereo extrinsic calibration (host-side); a copy
of the JAX package's ``calib/checkerboard.py``.

``find_corners`` + sub-pixel refinement per view, per-camera intrinsics,
the camera-1 -> camera-0 stereo extrinsic, and the calibration-pattern
generator. OpenCV is the fast path when it imports; without it every entry
point uses the numpy implementation in ``checkerboard_np``
(prototype-correlation corner detector + Zhang/LM calibration).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.camera import Distortion, Intrinsics
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning


def _cv2():
    try:
        import cv2  # noqa

        return cv2
    except ImportError:
        return None


def generate_checkerboard(cols: int = 10, rows: int = 7, square_px: int = 100,
                          margin_px: int = 50) -> np.ndarray:
    """Printable checkerboard image (u8): rows x cols squares, black at (0, 0)."""
    h = rows * square_px + 2 * margin_px
    w = cols * square_px + 2 * margin_px
    img = np.full((h, w), 255, np.uint8)
    for r in range(rows):
        for c in range(cols):
            if (r + c) % 2 == 0:
                y0 = margin_px + r * square_px
                x0 = margin_px + c * square_px
                img[y0:y0 + square_px, x0:x0 + square_px] = 0
    return img


def render_board_view(K: np.ndarray, T_board_cam: np.ndarray,
                      pattern: Tuple[int, int] = (9, 6), square: float = 0.025,
                      size: Tuple[int, int] = (640, 480)) -> np.ndarray:
    """Synthetic pinhole view of a checkerboard (first-party homography +
    warp, no cv2) — the hardware-free capture backend for the rig-calibration
    workflow and its tests. ``T_board_cam`` maps board-plane coords (meters,
    origin at the outer margin corner) into camera coords."""
    from azurekinect3dreconstruction_tpu_torch.calib.checkerboard_np import (
        find_homography,
        warp_perspective,
    )

    cols, rows = pattern
    board = generate_checkerboard(cols + 1, rows + 1, 40, 40)
    # board plane points (meters) of the board image corners (incl. margin)
    w_m = (cols + 1) * square + 2 * square
    h_m = (rows + 1) * square + 2 * square
    obj = np.array([[0, 0, 0], [w_m, 0, 0], [w_m, h_m, 0], [0, h_m, 0]],
                   np.float32)
    R, t = T_board_cam[:3, :3], T_board_cam[:3, 3]
    cam_pts = obj @ R.T + t
    uv = (cam_pts / cam_pts[:, 2:]) @ np.asarray(K).T
    dst = uv[:, :2].astype(np.float32)
    src = np.array([[0, 0], [board.shape[1], 0],
                    [board.shape[1], board.shape[0]], [0, board.shape[0]]],
                   np.float32)
    H = find_homography(src, dst)
    return warp_perspective(board, H, size, border=255)


def find_corners(gray_or_rgb: np.ndarray, pattern: Tuple[int, int] = (9, 6)
                 ) -> Optional[np.ndarray]:
    """Sub-pixel checkerboard corners ((N, 2) f32) or None."""
    cv2 = _cv2()
    if cv2 is None:
        from azurekinect3dreconstruction_tpu_torch.calib import checkerboard_np as cbn

        return cbn.find_corners_np(gray_or_rgb, pattern)
    img = np.asarray(gray_or_rgb)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    ok, corners = cv2.findChessboardCorners(img, pattern, None)
    if not ok:
        return None
    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)
    corners = cv2.cornerSubPix(img, corners, (11, 11), (-1, -1), criteria)
    return corners.reshape(-1, 2).astype(np.float32)


def _object_points(pattern: Tuple[int, int], square_size: float) -> np.ndarray:
    cols, rows = pattern
    grid = np.zeros((rows * cols, 3), np.float32)
    grid[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2) * square_size
    return grid


def calibrate_intrinsics(images: Sequence[np.ndarray],
                         pattern: Tuple[int, int] = (9, 6),
                         square_size: float = 0.025
                         ) -> Optional[Tuple[Intrinsics, Distortion, float]]:
    """Single-camera intrinsics from checkerboard views
    (cv2.calibrateCamera; numpy Zhang+LM fallback)."""
    cv2 = _cv2()
    objp = _object_points(pattern, square_size)
    obj_pts, img_pts = [], []
    shape = None
    for img in images:
        c = find_corners(img, pattern)
        if c is None:
            continue
        obj_pts.append(objp)
        img_pts.append(c.reshape(-1, 1, 2))
        shape = (img.shape[1], img.shape[0])
    if len(obj_pts) < 3:
        log_warning(f"only {len(obj_pts)} usable checkerboard views")
        return None
    if cv2 is None:
        from azurekinect3dreconstruction_tpu_torch.calib import checkerboard_np as cbn

        out = cbn.calibrate_intrinsics_np(
            [p.reshape(-1, 2) for p in img_pts], objp, shape)
        if out is None:
            return None
        K, d4, rms, _, _ = out
        d = np.concatenate([d4[:2], d4[2:4], np.zeros(4)])  # k1 k2 p1 p2
    else:
        rms, K, dist, _, _ = cv2.calibrateCamera(obj_pts, img_pts, shape,
                                                 None, None)
        d = dist.ravel()
        d = np.concatenate([d, np.zeros(max(0, 8 - d.size))])[:8]
    intr = Intrinsics(shape[0], shape[1], float(K[0, 0]), float(K[1, 1]),
                      float(K[0, 2]), float(K[1, 2]))
    # OpenCV order: k1 k2 p1 p2 k3 [k4 k5 k6]
    distortion = Distortion(k1=float(d[0]), k2=float(d[1]), p1=float(d[2]),
                            p2=float(d[3]), k3=float(d[4]), k4=float(d[5]),
                            k5=float(d[6]), k6=float(d[7]))
    log_info(f"intrinsics calibrated: rms {rms:.3f}px over {len(obj_pts)} views")
    return intr, distortion, float(rms)


def calibrate_stereo(images0: Sequence[np.ndarray], images1: Sequence[np.ndarray],
                     intr0: Intrinsics, dist0: Distortion,
                     intr1: Intrinsics, dist1: Distortion,
                     pattern: Tuple[int, int] = (9, 6), square_size: float = 0.025
                     ) -> Optional[Tuple[np.ndarray, float]]:
    """Stereo extrinsic T mapping camera-1 coords into camera-0 coords
    (cv2.stereoCalibrate + Rodrigues; numpy fallback)."""
    cv2 = _cv2()
    objp = _object_points(pattern, square_size)
    obj_pts, pts0, pts1 = [], [], []
    for i0, i1 in zip(images0, images1):
        c0 = find_corners(i0, pattern)
        c1 = find_corners(i1, pattern)
        if c0 is None or c1 is None:
            continue
        obj_pts.append(objp)
        pts0.append(c0.reshape(-1, 1, 2))
        pts1.append(c1.reshape(-1, 1, 2))
    if len(obj_pts) < 3:
        log_warning(f"only {len(obj_pts)} shared checkerboard views")
        return None

    def dvec(d: Distortion):
        return np.array([d.k1, d.k2, d.p1, d.p2, d.k3], np.float64)

    if cv2 is None:
        from azurekinect3dreconstruction_tpu_torch.calib import checkerboard_np as cbn

        out = cbn.calibrate_stereo_np(
            [p.reshape(-1, 2) for p in pts0], [p.reshape(-1, 2) for p in pts1],
            objp, intr0.matrix, dvec(dist0)[:4], intr1.matrix, dvec(dist1)[:4])
        if out is None:
            return None
        T4, rms = out
        log_info(f"stereo calibrated (numpy): rms {rms:.3f}px, baseline "
                 f"{np.linalg.norm(T4[:3, 3]):.4f}m")
        return T4, float(rms)

    rms, _, _, _, _, R, T, _, _ = cv2.stereoCalibrate(
        obj_pts, pts1, pts0, intr1.matrix, dvec(dist1), intr0.matrix, dvec(dist0),
        (intr0.width, intr0.height), flags=cv2.CALIB_FIX_INTRINSIC,
    )
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = T.ravel()
    log_info(f"stereo calibrated: rms {rms:.3f}px, baseline "
             f"{np.linalg.norm(T):.4f}m")
    return out, float(rms)
