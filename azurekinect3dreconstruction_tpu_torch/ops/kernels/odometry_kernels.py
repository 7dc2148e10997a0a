"""Per-level Gauss-Newton RGB-D odometry: the pyramid driver, the CUDA
kernel wrapper (``csrc/odometry_level.cu``) and its plain PyTorch version.

Each pyramid level runs all of its GN iterations against one device-side
state vector (pose, convergence flag, fitness, rmse, n_valid), so a whole
frame of odometry never waits on the host. Per iteration and source pixel:
back-project, transform by the pose, project into the target, sample target
intensity and depth bilinearly, form the photometric and geometric
residuals, gate them on depth range and ``|r_d| < max_depth_diff``,
Huber-weight them, and build the Jacobians from the *source* Sobel
gradients (the forward-compositional gradient swap: it changes the GN path,
not the fixed point). The 6x6 normal equations are damped, Jacobi
equilibrated and solved by Cholesky; the step is applied by se3 exp and
left-composed onto the pose.
"""

from __future__ import annotations

import torch

from azurekinect3dreconstruction_tpu_torch.config import OdometryConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.fmath import div, fma
from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid, sobel_gradients
from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
from azurekinect3dreconstruction_tpu_torch.tracking.odometry import OdometryResult, huber_weight

KERNEL = "odometry_level"
THREADS = 256  # pixels per CTA of the reduce kernel (kThreads in the .cu)
N_SUMS = 30  # 21 JtJ upper triangle + 6 Jtr + n_valid, squared cost, n_source
STATE = 16  # pose 3x4, convergence flag, fitness, rmse, n_valid

# (6, 6) -> index of the upper-triangle JtJ entry in the sums vector
_JTJ = [[0] * 6 for _ in range(6)]
_k = 0
for _a in range(6):
    for _b in range(_a, 6):
        _JTJ[_a][_b] = _JTJ[_b][_a] = _k
        _k += 1


def _level_params(li: Intrinsics, cfg: OdometryConfig, term_i: float, term_d: float):
    return (li.fx, li.fy, li.cx, li.cy, cfg.min_depth, cfg.max_depth, cfg.max_depth_diff,
            1.0 / cfg.sigma_intensity, 1.0 / cfg.sigma_depth, cfg.huber_delta,
            term_i, term_d, cfg.damping, cfg.convergence_delta ** 2)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _dp_dxi(jx, jy, jz, px, py, pz):
    """Point Jacobian (jx, jy, jz) contracted with dp'/dxi = [I | -hat(p')]."""
    return (jx, jy, jz, -jy * pz + jz * py, jx * pz - jz * px, -jx * py + jy * px)


def _gn_sums(state, src, tgt, li: Intrinsics, prm):
    """The 30 normal-equation sums of one GN iteration (plain version of
    the reduce kernel)."""
    fx, fy, cx, cy, min_d, max_d, max_dd, s_i, s_d, delta, term_i, term_d = prm[:12]
    H, W = li.height, li.width
    i_s, z, gx, gy, gdx, gdy = src
    dev = z.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = div(u - cx, fx) * z
    ys = div(v - cy, fy) * z
    valid_s = (z > min_d) & (z < max_d)
    # the warp decides which pixels are in bounds, so it is evaluated with
    # the reference's fused multiply-adds: at the identity pose a whole
    # border column sits on the 0 <= u < W-1 edge
    P = state[:12]
    px = fma(P[2], z, fma(P[0], xs, P[1] * ys)) + P[3]
    py = fma(P[6], z, fma(P[4], xs, P[5] * ys)) + P[7]
    pz = fma(P[10], z, fma(P[8], xs, P[9] * ys)) + P[11]
    zs = torch.clamp_min(pz, 1e-6)
    ut = fma(px / zs, fx, cx)
    vt = fma(py / zs, fy, cy)
    inb = (pz > min_d) & (ut >= 0) & (ut < W - 1) & (vt >= 0) & (vt < H - 1)

    u0 = torch.floor(torch.where(inb, ut, 0.0))
    v0 = torch.floor(torch.where(inb, vt, 0.0))
    fu, fv = ut - u0, vt - v0
    base = v0.to(torch.int64) * W + u0.to(torch.int64)

    def sample(img):
        f = img.reshape(-1)
        val = (f[base] * (1 - fu) * (1 - fv) + f[base + 1] * fu * (1 - fv)
               + f[base + W] * (1 - fu) * fv + f[base + W + 1] * fu * fv)
        return torch.where(inb, val, 0.0)

    it_w, dt_w = sample(tgt[0]), sample(tgt[1])
    r_i = it_w - i_s
    r_d = dt_w - pz
    valid = valid_s & inb & (dt_w > min_d) & (torch.abs(r_d) < max_dd)

    inv_z = 1.0 / zs
    ju0, ju2 = fx * inv_z, -fx * px * inv_z * inv_z
    jv1, jv2 = fy * inv_z, -fy * py * inv_z * inv_z
    J_i = _dp_dxi(gx * ju0, gy * jv1, gx * ju2 + gy * jv2, px, py, pz)
    J_d = _dp_dxi(gdx * ju0, gdy * jv1, gdx * ju2 + gdy * jv2 - 1.0, px, py, pz)
    # invalid pixels contribute nothing (their Jacobians may be huge)
    J_i = [torch.where(valid, j, 0.0) for j in J_i]
    J_d = [torch.where(valid, j, 0.0) for j in J_d]
    w_i = torch.where(valid, huber_weight(r_i * s_i, delta) * term_i, 0.0)
    w_d = torch.where(valid, huber_weight(r_d * s_d, delta) * term_d, 0.0)
    wi2 = w_i * w_i * s_i * s_i
    wd2 = w_d * w_d * s_d * s_d

    rows = [J_i[a] * J_i[b] * wi2 + J_d[a] * J_d[b] * wd2
            for a in range(6) for b in range(a, 6)]
    rows += [J_i[a] * r_i * wi2 + J_d[a] * r_d * wd2 for a in range(6)]
    rows += [valid.to(torch.float32),
             torch.where(valid, (r_i * s_i) ** 2 + (r_d * s_d) ** 2, 0.0),
             valid_s.to(torch.float32)]
    return torch.stack([r.reshape(-1) for r in rows]).sum(dim=1)


def _chol_solve6(A, b):
    """Cholesky solve of a 6x6 SPD system (sqrt guarded at 1e-30)."""
    L = torch.zeros_like(A)
    for j in range(6):
        ljj = torch.sqrt(torch.clamp_min(A[j, j] - (L[j, :j] * L[j, :j]).sum(), 1e-30))
        L[j, j] = ljj
        if j < 5:
            L[j + 1:, j] = (A[j + 1:, j] - (L[j + 1:, :j] * L[j, :j]).sum(dim=1)) / ljj
    y = torch.zeros_like(b)
    for i in range(6):
        y[i] = (b[i] - (L[i, :i] * y[:i]).sum()) / L[i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(6)):
        x[i] = (y[i] - (L[i + 1:, i] * x[i + 1:]).sum()) / L[i, i]
    return x


def _solve_step(state, sums, prm) -> None:
    """Plain version of the solve kernel: updates ``state`` in place unless
    its convergence flag is already set."""
    damping, tol2 = prm[12], prm[13]
    dev = state.device
    idx = torch.tensor(_JTJ, device=dev)
    A = sums[idx] + damping * torch.eye(6, dtype=torch.float32, device=dev)
    rhs = -sums[21:27]
    # Jacobi equilibration: JtJ mixes pixel^2 and metric units (cond ~1e6+)
    d = torch.rsqrt(torch.clamp_min(torch.diagonal(A), 1e-30))
    delta = _chol_solve6(A * d[:, None] * d[None, :], rhs * d) * d
    delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
    T = torch.cat([state[:12].reshape(3, 4), torch.eye(4, device=dev)[3:]])
    pose = (se3.se3_exp(delta) @ T)[:3].reshape(-1)
    conv = ((tol2 > 0.0) & (torch.sum(delta * delta) < tol2)).to(torch.float32)
    n_valid = sums[27]
    fitness = n_valid / torch.clamp_min(sums[29], 1.0)
    rmse = torch.sqrt(sums[28] / torch.clamp_min(n_valid, 1.0))
    new = torch.cat([pose, torch.stack([conv, fitness, rmse, n_valid])])
    state.copy_(torch.where(state[12] != 0.0, state, new))


def level_plain(state, src, tgt, li: Intrinsics, cfg: OdometryConfig, iters: int,
                term_i: float, term_d: float) -> None:
    """All GN iterations of one level in plain PyTorch; updates ``state``."""
    prm = _level_params(li, cfg, term_i, term_d)
    for _ in range(iters):
        _solve_step(state, _gn_sums(state, src, tgt, li, prm), prm)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def level_cuda(state, src, tgt, li: Intrinsics, cfg: OdometryConfig, iters: int,
               term_i: float, term_d: float) -> None:
    """All GN iterations of one level on the card: per iteration one reduce
    launch and one solve launch on PyTorch's current stream; updates
    ``state`` in place with no host synchronization."""
    H, W = li.height, li.width
    dev = state.device
    build.check_tensor(state, torch.float32, (STATE,), dev, "state")
    build.check_tensor(src, torch.float32, (6, H, W), dev, "source planes")
    build.check_tensor(tgt, torch.float32, (2, H, W), dev, "target planes")
    n_blocks = -(-H * W // THREADS)
    partials = torch.empty((n_blocks, N_SUMS), dtype=torch.float32, device=dev)
    params = build.float_params(*_level_params(li, cfg, term_i, term_d))
    lib = build.library()
    stream = build.stream_handle(dev)
    for _ in range(iters):
        build.check(lib.akr_odometry_reduce(src.data_ptr(), tgt.data_ptr(), H, W,
                                            state.data_ptr(), partials.data_ptr(),
                                            n_blocks, params, stream), "odometry_reduce")
        build.launches[KERNEL] += 1
        build.check(lib.akr_odometry_solve(partials.data_ptr(), n_blocks, state.data_ptr(),
                                           params, stream), "odometry_solve")
        build.launches[KERNEL] += 1


# ---------------------------------------------------------------------------
# pyramid driver
# ---------------------------------------------------------------------------


def level_inputs(intensity_s, depth_s, intensity_t, depth_t):
    """Stacked (6, H, W) source planes [I, D, dI/du, dI/dv, dD/du, dD/dv]
    and (2, H, W) target planes [I, D] of one pyramid level. Depth
    gradients are zeroed where any 4-neighbour (wrapping at the image
    edges, as the JAX package's roll does) has no depth."""
    gx, gy = sobel_gradients(intensity_s)
    gdx, gdy = sobel_gradients(depth_s)
    dv = depth_s > 0
    okg = (dv & torch.roll(dv, 1, 0) & torch.roll(dv, -1, 0)
           & torch.roll(dv, 1, 1) & torch.roll(dv, -1, 1))
    gdx = torch.where(okg, gdx, 0.0)
    gdy = torch.where(okg, gdy, 0.0)
    return (torch.stack([intensity_s, depth_s, gx, gy, gdx, gdy]).contiguous(),
            torch.stack([intensity_t, depth_t]).contiguous())


def odometry_pyramid(level, intensity_s, depth_s, intensity_t, depth_t, intr: Intrinsics,
                     cfg: OdometryConfig, init=None) -> OdometryResult:
    """Coarse-to-fine GN over the image pyramid, running each level with
    ``level`` (:func:`level_cuda` or :func:`level_plain`). The result stays
    on the input device."""
    dev = depth_s.device
    levels = len(cfg.pyramid_iters)
    pyr_s = build_pyramid(intensity_s, depth_s, levels)
    pyr_t = build_pyramid(intensity_t, depth_t, levels)
    term_i = 0.0 if cfg.term == "depth" else 1.0
    term_d = 0.0 if cfg.term == "color" else 1.0

    state = torch.zeros(STATE, dtype=torch.float32, device=dev)
    T0 = torch.eye(4, device=dev) if init is None else init.to(device=dev, dtype=torch.float32)
    state[:12] = T0[:3].reshape(-1)
    for lvl in reversed(range(levels)):
        src, tgt = level_inputs(*pyr_s[lvl], *pyr_t[lvl])
        state[12] = 0.0  # each level starts unconverged
        level(state, src, tgt, intr.scaled(1.0 / (1 << lvl)), cfg, cfg.pyramid_iters[lvl],
              term_i, term_d)

    T = torch.cat([state[:12].reshape(3, 4), torch.eye(4, device=dev)[3:]])
    return OdometryResult(T_target_source=T, fitness=state[13], rmse=state[14],
                          inliers=state[15].to(torch.int32))


def compute_odometry_fast(intensity_s, depth_s, intensity_t, depth_t, intr: Intrinsics,
                          cfg: OdometryConfig = OdometryConfig(), init=None) -> OdometryResult:
    """Hybrid odometry source -> target (``T_target_source``): CUDA tensors
    run the kernels, CPU tensors the plain version."""
    level = level_cuda if depth_s.device.type == "cuda" else level_plain
    return odometry_pyramid(level, intensity_s, depth_s, intensity_t, depth_t, intr, cfg, init)
