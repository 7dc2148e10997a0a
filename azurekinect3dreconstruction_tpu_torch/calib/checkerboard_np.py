"""First-party checkerboard corner detection + Zhang calibration (numpy and
scipy); a copy of the JAX package's ``calib/checkerboard_np.py``, the same
results for the same inputs.

OpenCV's pipeline (``findChessboardCorners`` + ``cornerSubPix`` +
``calibrateCamera`` + ``stereoCalibrate``) without OpenCV, so calibration
works wherever numpy and scipy do; ``calib.checkerboard`` uses cv2 when it
imports and falls back here.

Method:
- corner response by prototype correlation (two quadrant-kernel pairs at
  0 deg / 45 deg, both polarities — the libcbdetect recipe), non-max
  suppression, then gradient-orthogonality sub-pixel refinement (the
  ``cornerSubPix`` iteration: solve sum_w (grad grad^T)(c - p) = 0).
- lattice recovery by local linear extrapolation BFS: seed at the most
  central corner, pick the two dominant neighbor directions, then grow the
  integer grid predicting each next corner from its two predecessors
  (2*P[i] - P[i-1]) and snapping to the nearest detection. Orientation is
  canonicalized image-side (first corner = top-left-most), which is
  consistent across cameras viewing the same board — sufficient for stereo
  correspondence.
- intrinsics by Zhang's method (normalized DLT homographies -> B-matrix ->
  closed-form K -> per-view planar pose) followed by a joint
  Levenberg-Marquardt bundle over fx fy cx cy k1 k2 p1 p2 and all view
  poses (scipy.optimize.least_squares).
- stereo extrinsic as the pose-averaged camera-1 -> camera-0 transform over
  shared views, LM-refined jointly with the per-view board poses.

Host code: calibration is a once-per-rig offline task.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage
from scipy.optimize import least_squares

# ---------------------------------------------------------------------------
# image helpers (also used by tests to render synthetic views without cv2)
# ---------------------------------------------------------------------------


def to_gray(img: np.ndarray) -> np.ndarray:
    """RGB(A)/gray u8 or float -> float32 gray in [0, 1]."""
    a = np.asarray(img)
    if a.ndim == 3:
        a = a[..., :3] @ np.array([0.299, 0.587, 0.114])
    a = a.astype(np.float32)
    if a.max() > 1.5:
        a = a / 255.0
    return a


def find_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares homography src -> dst via normalized DLT (no RANSAC —
    calibration targets give clean correspondences)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)

    def normalize(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        return (p - c) * s, T

    sp, Ts = normalize(src)
    dp, Td = normalize(dst)
    n = len(sp)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = sp[i]
        u, v = dp[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(A)
    H = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def warp_perspective(img: np.ndarray, H: np.ndarray, size: Tuple[int, int],
                     border: float = 255.0) -> np.ndarray:
    """Inverse-map bilinear warp (cv2.warpPerspective equivalent).
    ``size`` is (width, height); H maps src pixel -> dst pixel."""
    w, h = size
    Hi = np.linalg.inv(np.asarray(H, np.float64))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    d = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)])
    s = Hi @ d
    sx = s[0] / s[2]
    sy = s[1] / s[2]
    src = np.asarray(img, np.float64)
    sh, sw = src.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = sx - x0
    fy = sy - y0
    valid = (x0 >= 0) & (x0 < sw - 1) & (y0 >= 0) & (y0 < sh - 1)
    x0c = np.clip(x0, 0, sw - 2)
    y0c = np.clip(y0, 0, sh - 2)
    v00 = src[y0c, x0c]
    v01 = src[y0c, x0c + 1]
    v10 = src[y0c + 1, x0c]
    v11 = src[y0c + 1, x0c + 1]
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    out = np.where(valid, out, border)
    return out.reshape(h, w).astype(np.asarray(img).dtype
                                    if np.issubdtype(np.asarray(img).dtype,
                                                     np.floating) else np.uint8)


# ---------------------------------------------------------------------------
# corner detection
# ---------------------------------------------------------------------------


def _corner_response(gray: np.ndarray, radius: int) -> np.ndarray:
    """Checkerboard X-corner response by quadrant-prototype correlation
    (libcbdetect-style): two kernel orientations x two polarities; the
    response at a true corner is high for exactly one combination."""
    r = radius
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    d = np.sqrt(x * x + y * y)
    ring = (d <= r) & (d > 0.1)
    ang = np.arctan2(y, x)

    def quad(a0, a1):
        m = ring & (((ang - a0) % (2 * np.pi)) < (a1 - a0))
        k = m.astype(np.float64)
        s = k.sum()
        return k / max(s, 1.0)

    combos = []
    for base in (0.0, np.pi / 4):
        a = quad(base, base + np.pi / 2)
        b = quad(base + np.pi, base + 3 * np.pi / 2)
        c = quad(base + np.pi / 2, base + np.pi)
        dq = quad(base + 3 * np.pi / 2, base + 2 * np.pi)
        combos.append((a, b, c, dq))

    g = gray.astype(np.float64)
    resp = np.zeros_like(g)
    mu = ndimage.uniform_filter(g, 2 * r + 1)
    for a, b, c, dq in combos:
        fa = ndimage.convolve(g, a[::-1, ::-1])
        fb = ndimage.convolve(g, b[::-1, ::-1])
        fc = ndimage.convolve(g, c[::-1, ::-1])
        fd = ndimage.convolve(g, dq[::-1, ::-1])
        # polarity 1: a/b bright, c/d dark; polarity 2: reversed
        s1 = np.minimum(np.minimum(fa, fb) - mu, mu - np.maximum(fc, fd))
        s2 = np.minimum(mu - np.maximum(fa, fb), np.minimum(fc, fd) - mu)
        resp = np.maximum(resp, np.maximum(s1, s2))
    return resp


def _nms(resp: np.ndarray, radius: int, thresh: float) -> np.ndarray:
    mx = ndimage.maximum_filter(resp, size=2 * radius + 1)
    ys, xs = np.nonzero((resp == mx) & (resp > thresh))
    return np.stack([xs, ys], axis=1).astype(np.float64)


def refine_subpixel(gray: np.ndarray, pts: np.ndarray, win: int = 5,
                    iters: int = 20) -> np.ndarray:
    """cornerSubPix-equivalent: iterate c <- solve(sum w G, sum w G p) where
    G = grad grad^T — gradients on the window are orthogonal to the vector
    from the true corner."""
    g = gray.astype(np.float64)
    gy, gx = np.gradient(g)
    h, w = g.shape
    out = pts.astype(np.float64).copy()
    yy, xx = np.mgrid[-win:win + 1, -win:win + 1]
    wgt = np.exp(-(xx * xx + yy * yy) / (2.0 * (win / 2.0) ** 2))
    for i in range(len(out)):
        c = out[i]
        for _ in range(iters):
            cx, cy = int(round(c[0])), int(round(c[1]))
            if not (win <= cx < w - win and win <= cy < h - win):
                break
            wx = gx[cy - win:cy + win + 1, cx - win:cx + win + 1]
            wy = gy[cy - win:cy + win + 1, cx - win:cx + win + 1]
            pxx = (wx * wx * wgt).sum()
            pyy = (wy * wy * wgt).sum()
            pxy = (wx * wy * wgt).sum()
            px = cx + xx
            py = cy + yy
            bx = (wx * wx * wgt * px).sum() + (wx * wy * wgt * py).sum()
            by = (wx * wy * wgt * px).sum() + (wy * wy * wgt * py).sum()
            A = np.array([[pxx, pxy], [pxy, pyy]])
            det = np.linalg.det(A)
            if abs(det) < 1e-12:
                break
            nc = np.linalg.solve(A, np.array([bx, by]))
            if np.linalg.norm(nc - c) < 1e-4:
                c = nc
                break
            c = nc
        out[i] = c
    return out


def _order_grid(cands: np.ndarray, pattern: Tuple[int, int]
                ) -> Optional[np.ndarray]:
    """Organize candidate corners into a row-major (cols*rows, 2) lattice by
    BFS growth with linear extrapolation. Returns None if the full pattern
    cannot be recovered."""
    cols, rows = pattern
    need = cols * rows
    if len(cands) < need:
        return None
    pts = cands.astype(np.float64)
    n = len(pts)

    # seed: most central corner
    center = pts.mean(0)
    seed = int(np.argmin(np.linalg.norm(pts - center, axis=1)))

    # lattice axes: nearest neighbor of the seed = u; most orthogonal
    # comparable-length neighbor = v
    d = np.linalg.norm(pts - pts[seed], axis=1)
    d[seed] = np.inf
    order = np.argsort(d)
    u_idx = int(order[0])
    u = pts[u_idx] - pts[seed]
    v = None
    for j in order[1:8]:
        cand = pts[j] - pts[seed]
        cosang = abs(np.dot(cand, u)) / (np.linalg.norm(cand) * np.linalg.norm(u))
        if cosang < 0.5 and np.linalg.norm(cand) < 2.0 * np.linalg.norm(u):
            v = cand
            break
    if v is None:
        return None

    # BFS over integer lattice coords; predict via local linear extrapolation
    grid = {(0, 0): seed}
    used = {seed}
    frontier = [(0, 0)]
    step0 = np.linalg.norm(u)

    def predict(ij, dij):
        """Predicted position for ij+dij using already-placed points."""
        i, j = ij
        di, dj = dij
        p1 = grid.get((i, j))
        p0 = grid.get((i - di, j - dj))
        if p0 is not None:
            return 2 * pts[p1] - pts[p0]
        return pts[p1] + di * u + dj * v

    while frontier:
        ij = frontier.pop(0)
        for dij in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nij = (ij[0] + dij[0], ij[1] + dij[1])
            if nij in grid:
                continue
            pred = predict(ij, dij)
            dd = np.linalg.norm(pts - pred, axis=1)
            for k in used:
                dd[k] = np.inf
            cand = int(np.argmin(dd))
            tol = 0.35 * max(step0, np.linalg.norm(pred - pts[grid[ij]]))
            if dd[cand] < tol:
                grid[nij] = cand
                used.add(cand)
                frontier.append(nij)

    if len(grid) < need:
        return None
    iis = np.array([ij[0] for ij in grid])
    jjs = np.array([ij[1] for ij in grid])

    # find a (cols x rows) or (rows x cols) complete sub-window
    for (du, dv), (wi, wj) in (((1, 0), (cols, rows)), ((0, 1), (rows, cols))):
        for i0 in range(iis.min(), iis.max() - wi + 2):
            for j0 in range(jjs.min(), jjs.max() - wj + 2):
                ok = all((i0 + a, j0 + b) in grid
                         for a in range(wi) for b in range(wj))
                if not ok:
                    continue
                # lattice (a = fast axis along cols when wi == cols)
                if wi == cols:
                    lat = np.array([[grid[(i0 + a, j0 + b)]
                                     for a in range(cols)] for b in range(rows)])
                else:
                    lat = np.array([[grid[(i0 + b, j0 + a)]
                                     for b in range(rows)] for a in range(cols)]).T
                out = pts[lat.reshape(-1)]
                return _canonicalize(out.reshape(rows, cols, 2))
    return None


def _canonicalize(grid_pts: np.ndarray) -> np.ndarray:
    """Fix the lattice orientation image-side: first corner = the extreme
    corner closest to the image origin. Deterministic for all cameras
    viewing the board from the same side.

    Only FLIPS, never a transpose: the (rows, cols) axes must keep their
    lengths so corner[i] stays paired with _object_points[i] (for the
    non-square patterns used here the axes are distinguished by length, so
    a 90-degree-rotated board keeps its long axis on the cols dimension —
    the same convention OpenCV uses)."""
    rows, cols, _ = grid_pts.shape
    corners4 = np.array([grid_pts[0, 0], grid_pts[0, -1],
                         grid_pts[-1, 0], grid_pts[-1, -1]])
    first = int(np.argmin(corners4[:, 0] + corners4[:, 1]))
    g = grid_pts
    if first == 1:
        g = g[:, ::-1]
    elif first == 2:
        g = g[::-1, :]
    elif first == 3:
        g = g[::-1, ::-1]
    return np.ascontiguousarray(g.reshape(-1, 2))


def find_corners_np(gray_or_rgb: np.ndarray, pattern: Tuple[int, int] = (9, 6)
                    ) -> Optional[np.ndarray]:
    """cv2.findChessboardCorners + cornerSubPix equivalent: sub-pixel
    row-major (cols*rows, 2) corners, or None."""
    gray = to_gray(gray_or_rgb)
    cols, rows = pattern
    need = cols * rows
    for radius in (4, 6, 8):
        resp = _corner_response(gray, radius)
        thresh = 0.35 * resp.max()
        cands = _nms(resp, radius, thresh)
        if len(cands) < need or len(cands) > 12 * need:
            continue
        cands = refine_subpixel(gray, cands, win=max(4, radius))
        ordered = _order_grid(cands, pattern)
        if ordered is not None:
            # grid recovery can transpose pattern orientation; re-shape check
            if len(ordered) == need:
                return ordered.astype(np.float32)
    return None


# ---------------------------------------------------------------------------
# Zhang intrinsic calibration
# ---------------------------------------------------------------------------


def _rodrigues_to_R(r: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _R_to_rodrigues(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * w


def _project(params_k, rvec, tvec, objp):
    """Pinhole + Brown-Conrady (k1 k2 p1 p2) projection."""
    fx, fy, cx, cy, k1, k2, p1, p2 = params_k
    R = _rodrigues_to_R(rvec)
    pc = objp @ R.T + tvec
    x = pc[:, 0] / pc[:, 2]
    y = pc[:, 1] / pc[:, 2]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([fx * xd + cx, fy * yd + cy], axis=1)


def _zhang_init(homographies: List[np.ndarray]) -> Optional[np.ndarray]:
    """Closed-form K from >= 3 homographies (Zhang's B-matrix)."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in homographies:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.asarray(V)
    _, _, vt = np.linalg.svd(V)
    b = vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    den = B11 * B22 - B12 * B12
    if abs(den) < 1e-18:
        return None
    cy = (B12 * B13 - B11 * B23) / den
    lam = B33 - (B13 * B13 + cy * (B12 * B13 - B11 * B23)) / B11
    if lam / B11 <= 0 or lam <= 0:
        return None
    fx = np.sqrt(lam / B11)
    fy = np.sqrt(lam * B11 / den)
    cx = -B13 * fx * fx / lam
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    return K


def _pose_from_homography(K: np.ndarray, H: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Planar-target pose from homography: H ~ K [r1 r2 t]."""
    A = np.linalg.inv(K) @ H
    lam = 1.0 / np.linalg.norm(A[:, 0])
    if A[2, 2] * lam < 0:  # board must be in front of the camera
        lam = -lam
    r1 = A[:, 0] * lam
    r2 = A[:, 1] * lam
    t = A[:, 2] * lam
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    # nearest rotation
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = u @ np.diag([1, 1, -1]) @ vt
    return _R_to_rodrigues(R), t


def calibrate_intrinsics_np(corners: Sequence[np.ndarray], objp: np.ndarray,
                            image_size: Tuple[int, int]
                            ) -> Optional[Tuple[np.ndarray, np.ndarray, float,
                                                List[np.ndarray], List[np.ndarray]]]:
    """Zhang init + full LM bundle. Returns (K, dist[k1 k2 p1 p2], rms,
    rvecs, tvecs) or None. ``corners``: per-view (N, 2); ``objp``: (N, 3)
    planar (z = 0) board points."""
    views = [np.asarray(c, np.float64) for c in corners]
    op2 = np.asarray(objp, np.float64)[:, :2]
    Hs = [find_homography(op2, c) for c in views]
    K0 = _zhang_init(Hs)
    if K0 is None:
        # fall back to a sane prior: principal point at center, f ~ width
        K0 = np.array([[image_size[0], 0, image_size[0] / 2],
                       [0, image_size[0], image_size[1] / 2], [0, 0, 1.0]])
    poses = [_pose_from_homography(K0, H) for H in Hs]
    objp3 = np.asarray(objp, np.float64)

    nv = len(views)
    x0 = np.concatenate(
        [[K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2], 0, 0, 0, 0]]
        + [np.concatenate([r, t]) for r, t in poses])

    def resid(x):
        pk = x[:8]
        out = []
        for i, c in enumerate(views):
            r = x[8 + 6 * i: 11 + 6 * i]
            t = x[11 + 6 * i: 14 + 6 * i]
            out.append((_project(pk, r, t, objp3) - c).ravel())
        return np.concatenate(out)

    sol = least_squares(resid, x0, method="lm", max_nfev=200 * len(x0))
    pk = sol.x[:8]
    K = np.array([[pk[0], 0, pk[2]], [0, pk[1], pk[3]], [0, 0, 1]])
    dist = pk[4:8].copy()
    rms = float(np.sqrt(np.mean(sol.fun ** 2) * 2))  # per-point, both coords
    rvecs = [sol.x[8 + 6 * i: 11 + 6 * i] for i in range(nv)]
    tvecs = [sol.x[11 + 6 * i: 14 + 6 * i] for i in range(nv)]
    return K, dist, rms, rvecs, tvecs


# ---------------------------------------------------------------------------
# stereo extrinsic
# ---------------------------------------------------------------------------


def _avg_rotation(Rs: List[np.ndarray]) -> np.ndarray:
    """Chordal L2 rotation average (SVD of the summed matrices)."""
    M = np.sum(Rs, axis=0)
    u, _, vt = np.linalg.svd(M)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = u @ np.diag([1, 1, -1]) @ vt
    return R


def calibrate_stereo_np(corners0: Sequence[np.ndarray],
                        corners1: Sequence[np.ndarray],
                        objp: np.ndarray,
                        K0: np.ndarray, dist0: np.ndarray,
                        K1: np.ndarray, dist1: np.ndarray
                        ) -> Optional[Tuple[np.ndarray, float]]:
    """cv2.stereoCalibrate(CALIB_FIX_INTRINSIC) equivalent: camera-1 ->
    camera-0 rigid transform from shared checkerboard views, LM-refined
    jointly with the per-view board poses."""
    objp3 = np.asarray(objp, np.float64)
    op2 = objp3[:, :2]
    v0 = [np.asarray(c, np.float64) for c in corners0]
    v1 = [np.asarray(c, np.float64) for c in corners1]
    nv = len(v0)
    if nv < 2:
        return None

    pk0 = np.array([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2],
                    *np.asarray(dist0, np.float64)[:4]])
    pk1 = np.array([K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2],
                    *np.asarray(dist1, np.float64)[:4]])

    # init: per-view poses from homographies, relative pose averaged
    rels_R, rels_t, poses0 = [], [], []
    for c0, c1 in zip(v0, v1):
        r0, t0 = _pose_from_homography(K0, find_homography(op2, c0))
        r1, t1 = _pose_from_homography(K1, find_homography(op2, c1))
        A0 = np.eye(4)
        A0[:3, :3] = _rodrigues_to_R(r0)
        A0[:3, 3] = t0
        A1 = np.eye(4)
        A1[:3, :3] = _rodrigues_to_R(r1)
        A1[:3, 3] = t1
        rel = A0 @ np.linalg.inv(A1)  # camera-1 -> camera-0
        rels_R.append(rel[:3, :3])
        rels_t.append(rel[:3, 3])
        poses0.append((r0, t0))
    R10 = _avg_rotation(rels_R)
    t10 = np.mean(rels_t, axis=0)

    x0 = np.concatenate([_R_to_rodrigues(R10), t10]
                        + [np.concatenate([r, t]) for r, t in poses0])

    def resid(x):
        r10 = x[:3]
        tt10 = x[3:6]
        Rrel = _rodrigues_to_R(r10)
        out = []
        for i, (c0, c1) in enumerate(zip(v0, v1)):
            r0 = x[6 + 6 * i: 9 + 6 * i]
            t0 = x[9 + 6 * i: 12 + 6 * i]
            out.append((_project(pk0, r0, t0, objp3) - c0).ravel())
            # board -> cam1 = inv(cam1->cam0) @ (board -> cam0)
            R0 = _rodrigues_to_R(r0)
            R1 = Rrel.T @ R0
            t1 = Rrel.T @ (t0 - tt10)
            out.append((_project(pk1, _R_to_rodrigues(R1), t1, objp3) - c1).ravel())
        return np.concatenate(out)

    sol = least_squares(resid, x0, method="lm", max_nfev=200 * len(x0))
    T = np.eye(4)
    T[:3, :3] = _rodrigues_to_R(sol.x[:3])
    T[:3, 3] = sol.x[3:6]
    rms = float(np.sqrt(np.mean(sol.fun ** 2) * 2))
    return T, rms
