"""Gauss-Newton RGB-D odometry over the image pyramid: the pyramid loop, the
CUDA kernel wrapper (``csrc/odometry_pyramid.cu``) and its plain PyTorch version.

All GN iterations of all pyramid levels run against one device-side state
vector (pose, convergence flag, fitness, rmse, n_valid), so a whole frame
pair of odometry never waits on the host; on the card it is one launch. Per
iteration and source pixel: back-project, transform by the pose, project
into the target, sample target intensity and depth bilinearly, form the
photometric and geometric residuals, gate them on depth range and
``|r_d| < max_depth_diff``, Huber-weight them, and build the Jacobians from
the *source* Sobel gradients (the forward-compositional gradient swap: it
changes the GN path, not the fixed point). The 6x6 normal equations are
damped, Jacobi equilibrated and solved by Cholesky; the step is applied by
se3 exp and left-composed onto the pose. A level with no iterations passes
the pose through.
"""

from __future__ import annotations

import ctypes

import torch

from azurekinect3dreconstruction_tpu_torch.config import OdometryConfig
from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.core.fmath import div, fma
from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid, sobel_gradients
from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
from azurekinect3dreconstruction_tpu_torch.tracking.odometry import (
    OdometryResult,
    dp_dxi,
    huber_weight,
)

KERNEL = "odometry_pyramid"
N_SUMS = 30  # 21 JtJ upper triangle + 6 Jtr + n_valid, squared cost, n_source
STATE = 16  # pose 3x4, convergence flag, fitness, rmse, n_valid
MAX_LEVELS = 16  # kMaxLevels in the .cu
PLANES = 8  # kPlanes in the .cu: i_s, z, xs, ys, gx, gy, gdx, gdy per source pixel
RESIDENT_PLANES = 4  # kResidentPlanes: the large route's gx, gy, gdx, gdy per resident pixel
SHARED = -1  # kShared: a level's route with all PLANES planes of its band in shared memory
MAX_PIXELS = 1 << 24  # kMaxPixels: the most pixels a level may have (exact float coordinates)

# (6, 6) -> index of the upper-triangle JtJ entry in the sums vector
_JTJ = [[0] * 6 for _ in range(6)]
_k = 0
for _a in range(6):
    for _b in range(_a, 6):
        _JTJ[_a][_b] = _JTJ[_b][_a] = _k
        _k += 1


def _level_params(li: Intrinsics, cfg: OdometryConfig, term_i: float, term_d: float):
    return (li.fx, li.fy, li.cx, li.cy, *_shared_params(cfg, term_i, term_d))


def _shared_params(cfg: OdometryConfig, term_i: float, term_d: float):
    """The parameters every level shares, in the kernel's order."""
    return (cfg.min_depth, cfg.max_depth, cfg.max_depth_diff, 1.0 / cfg.sigma_intensity,
            1.0 / cfg.sigma_depth, cfg.huber_delta, term_i, term_d, cfg.damping,
            cfg.convergence_delta ** 2)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _gn_sums(state, src, tgt, li: Intrinsics, prm):
    """The 30 normal-equation sums of one GN iteration."""
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
    J_i = dp_dxi(gx * ju0, gy * jv1, gx * ju2 + gy * jv2, px, py, pz)
    J_d = dp_dxi(gdx * ju0, gdy * jv1, gdx * ju2 + gdy * jv2 - 1.0, px, py, pz)
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
    """One GN step from the sums: updates ``state`` in place unless its
    convergence flag is already set."""
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


def level_inputs(intensity_s, depth_s, intensity_t, depth_t):
    """Stacked (6, H, W) source planes [I, D, dI/du, dI/dv, dD/du, dD/dv]
    and (2, H, W) target planes [I, D] of one pyramid level. Depth
    gradients are zeroed where any 4-neighbour (wrapping at the image
    edges, as the JAX package's roll does) has no depth. The kernel computes
    the same source planes on chip."""
    gx, gy = sobel_gradients(intensity_s)
    gdx, gdy = sobel_gradients(depth_s)
    dv = depth_s > 0
    okg = (dv & torch.roll(dv, 1, 0) & torch.roll(dv, -1, 0)
           & torch.roll(dv, 1, 1) & torch.roll(dv, -1, 1))
    gdx = torch.where(okg, gdx, 0.0)
    gdy = torch.where(okg, gdy, 0.0)
    return (torch.stack([intensity_s, depth_s, gx, gy, gdx, gdy]).contiguous(),
            torch.stack([intensity_t, depth_t]).contiguous())


def pyramid_plain(state, pyr_s, pyr_t, intr: Intrinsics, cfg: OdometryConfig,
                  term_i: float, term_d: float) -> None:
    """Every level, coarse to fine, in plain PyTorch; updates ``state``."""
    for lvl in reversed(range(len(cfg.pyramid_iters))):
        state[12] = 0.0  # each level starts unconverged
        iters = cfg.pyramid_iters[lvl]
        if iters <= 0:
            continue
        src, tgt = level_inputs(*pyr_s[lvl], *pyr_t[lvl])
        level_plain(state, src, tgt, intr.scaled(1.0 / (1 << lvl)), cfg, iters, term_i, term_d)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_PLANES = ("source intensity", "source depth", "target intensity", "target depth")


def pack_levels(pyr_s, pyr_t, intr: Intrinsics, cfg: OdometryConfig, device):
    """Check every level's planes and pack them for the kernel: (plane
    pointers [I_s, D_s, I_t, D_t] per level, [H, W, iterations] per level,
    [fx, fy, cx, cy] per level). Raises ``ValueError`` on a level count
    outside 1..MAX_LEVELS, a pyramid of another depth, or a plane that is
    not a contiguous float32 (H, W) tensor on ``device``."""
    levels = len(cfg.pyramid_iters)
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"odometry_pyramid: {levels} pyramid levels, the kernel takes "
                         f"1 to {MAX_LEVELS}")
    if len(pyr_s) != levels or len(pyr_t) != levels:
        raise ValueError(f"odometry_pyramid: {levels} levels configured, pyramids of "
                         f"{len(pyr_s)} and {len(pyr_t)} given")
    ptrs, dims, intr_f = [], [], []
    for lvl in range(levels):
        li = intr.scaled(1.0 / (1 << lvl))
        for t, what in zip((*pyr_s[lvl], *pyr_t[lvl]), _PLANES):
            build.check_tensor(t, torch.float32, (li.height, li.width), device,
                               f"level {lvl} {what}")
            ptrs.append(t.data_ptr())
        dims += [li.height, li.width, int(cfg.pyramid_iters[lvl])]
        intr_f += [li.fx, li.fy, li.cx, li.cy]
    return ptrs, dims, intr_f


def resident_pixels(H: int, W: int, grid: int, band: int) -> int:
    """The pixels of each of a level's ``grid`` bands (``ceil(H * W /
    grid)`` pixels) whose ``RESIDENT_PLANES`` gradient planes the
    large-frame route keeps in shared memory: as many as fit where the
    shared route keeps ``band`` pixels' ``PLANES`` planes."""
    return min(-(-H * W // grid), band * PLANES // RESIDENT_PLANES)


def level_routes(dims, grid: int, band: int) -> list:
    """Where each level's source planes live in the launch, one int a level
    for the kernel: :data:`SHARED` when its band, ``ceil(H * W / grid)``
    pixels, fits the ``band`` pixels whose ``PLANES`` planes one CTA's
    shared memory holds (930,072 pixels over 132 CTAs on an H100: 640x576,
    1280x720 and every coarser level); else the large-frame route, with
    :func:`resident_pixels` of each band resident; the kernel recomputes
    the rest from the source planes in every iteration. A level that does
    not iterate is :data:`SHARED` (it is skipped). ``dims`` is
    :func:`pack_levels`' [H, W, iterations] per level. Raises
    ``ValueError`` on a level of more than :data:`MAX_PIXELS` pixels, which
    the kernel refuses, iterated or not."""
    routes = []
    for lvl in range(len(dims) // 3):
        H, W, iters = dims[3 * lvl:3 * lvl + 3]
        if H * W > MAX_PIXELS:
            raise ValueError(f"odometry_pyramid: level {lvl} has {H}x{W} pixels, over the "
                             f"{MAX_PIXELS} any route takes")
        fits = -(-H * W // grid) <= band
        routes.append(SHARED if iters <= 0 or fits else resident_pixels(H, W, grid, band))
    return routes


def launch_grid() -> tuple[int, int]:
    """(grid, band) on the current card: the kernel's fixed co-resident
    CTAs and the most pixels one CTA's shared memory holds, computed once
    per process by the library."""
    n, band = ctypes.c_int(0), ctypes.c_int(0)
    build.check(build.library().akr_odometry_pyramid_grid(ctypes.byref(n), ctypes.byref(band)),
                "odometry_pyramid grid")
    return n.value, band.value


def pyramid_cuda(state, pyr_s, pyr_t, intr: Intrinsics, cfg: OdometryConfig,
                 term_i: float, term_d: float) -> None:
    """Every level, coarse to fine, on the card in ONE cooperative launch on
    PyTorch's current stream; updates ``state`` in place with no host
    synchronization. Every level's planes are checked before the launch,
    and each level takes the route :func:`level_routes` plans for it: a
    level larger than the grid's shared memory keeps what fits there and
    recomputes the rest, so nothing is allocated per pixel, at any frame
    size; the launch stays capture-safe."""
    dev = state.device
    build.check_tensor(state, torch.float32, (STATE,), dev, "state")
    ptrs, dims, intr_f = pack_levels(pyr_s, pyr_t, intr, cfg, dev)
    if dev.type != "cuda":
        raise ValueError(f"pyramid_cuda needs CUDA tensors, got {dev}")
    lib = build.library()
    with torch.cuda.device(dev):
        grid, band = launch_grid()
        routes = level_routes(dims, grid, band)
        # the partial rows: one tagged 64-bit word per sum (zeroed by the launch)
        partials = torch.empty((2, grid, N_SUMS), dtype=torch.int64, device=dev)
        build.check(lib.akr_odometry_pyramid(
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(dims))(*dims),
            build.float_params(*intr_f), len(routes), (ctypes.c_int * len(routes))(*routes),
            build.float_params(*_shared_params(cfg, term_i, term_d)), state.data_ptr(),
            partials.data_ptr(), grid, build.stream_handle(dev)), KERNEL)
    build.launches[KERNEL] += 1


# ---------------------------------------------------------------------------
# pyramid loop
# ---------------------------------------------------------------------------


def odometry_pyramid(run, intensity_s, depth_s, intensity_t, depth_t, intr: Intrinsics,
                     cfg: OdometryConfig, init=None) -> OdometryResult:
    """Coarse-to-fine GN over the image pyramid, all levels run by ``run``
    (:func:`pyramid_cuda` or :func:`pyramid_plain`). The result stays on
    the input device."""
    dev = depth_s.device
    levels = len(cfg.pyramid_iters)
    pyr_s = build_pyramid(intensity_s, depth_s, levels)
    pyr_t = build_pyramid(intensity_t, depth_t, levels)
    term_i = 0.0 if cfg.term == "depth" else 1.0
    term_d = 0.0 if cfg.term == "color" else 1.0

    state = torch.zeros(STATE, dtype=torch.float32, device=dev)
    T0 = torch.eye(4, device=dev) if init is None else init.to(device=dev, dtype=torch.float32)
    state[:12] = T0[:3].reshape(-1)
    run(state, pyr_s, pyr_t, intr, cfg, term_i, term_d)

    T = torch.cat([state[:12].reshape(3, 4), torch.eye(4, device=dev)[3:]])
    return OdometryResult(T_target_source=T, fitness=state[13], rmse=state[14],
                          inliers=state[15].to(torch.int32))


def compute_odometry_fast(intensity_s, depth_s, intensity_t, depth_t, intr: Intrinsics,
                          cfg: OdometryConfig = OdometryConfig(), init=None) -> OdometryResult:
    """Hybrid odometry source -> target (``T_target_source``): CUDA tensors
    run the kernel, CPU tensors the plain version."""
    run = pyramid_cuda if depth_s.device.type == "cuda" else pyramid_plain
    return odometry_pyramid(run, intensity_s, depth_s, intensity_t, depth_t, intr, cfg, init)
