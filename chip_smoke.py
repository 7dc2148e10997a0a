"""Drive the PyTorch/CUDA port once on one GPU, end to end, and check it.

    python3 chip_smoke.py

Builds the hand-written kernels of ``azurekinect3dreconstruction_tpu_torch/csrc``
with nvcc, then, at the bench headline configuration (640x576 NFOV depth,
5 mm voxels in 16^3 blocks, 16384-block pool, 65536-slot hash, 2048-block
worklist, odometry pyramid [20, 10, 5]):

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times both with CUDA events;
2. drives ``MonoOdometryTSDF(..., device="cuda").process_frame`` over the
   first 16 poses of the bench sweep (``orbit_trajectory(64, radius=0.35,
   angle_span=1.3)``), rendered on the card and quantized to u16 mm / u8 RGB,
   with every launch counter zeroed just before and read just after;
3. checks the result: every frame through the fitness gate, no overflow,
   ATE RMSE against the ground-truth poses <= 2 cm, finite surface points.

Prints the card's name and power limit, the build time, the launch counts,
per-frame fitness, ATE/RPE, ms/frame, one JSON line of per-kernel results,
and, as the last line, ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, on any failure or when no CUDA device is available.
Needs no jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "azurekinect3dreconstruction_tpu_torch"
N_FRAMES = 16
ATE_LIMIT_M = 0.02
# kernel vs plain, on the card (see PERF.md): B1 differs only where a voxel
# sits on a half-pixel edge; B2 sums ~370k pixels in another order
B1_WEIGHT_EQUAL_MIN = 0.9999
B1_VALUE_TOL = 1e-5
B2_POSE_TOL = 1e-4
B2_FITNESS_TOL = 1e-3


def _log(msg: str) -> None:
    print(msg, flush=True)


def _fail(msg: str) -> int:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def _gpu_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(REPO, PKG)):
        return _fail(f"the {PKG} package is not beside this script")
    sys.path.insert(0, REPO)
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
    from azurekinect3dreconstruction_tpu_torch.core.types import decode_raw_frame
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
        SyntheticCamera,
        orbit_trajectory,
    )
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate, rpe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gpu = _gpu_line()
    _log(f"gpu: {gpu}")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    _log(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s) "
         f"-> {os.path.relpath(lib_path, REPO)}")

    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=16,
                                         block_capacity=16384, hash_capacity=65536))
    tcfg, ocfg = cfg.tsdf, cfg.odometry
    intr = Intrinsics.azure_kinect_depth_nfov()
    cam = SyntheticCamera(intrinsics=intr, device=dev)
    poses = orbit_trajectory(64, radius=0.35, angle_span=1.3)[:N_FRAMES]
    raw = []
    for T in poses:
        z, c = cam.render(T)
        raw.append((torch.round(z * 1000.0).cpu().numpy().astype(np.uint16),
                    torch.round(c * 255.0).cpu().numpy().astype(np.uint8)))
    camc = cfg.camera
    scal = (1.0 / camc.depth_scale, camc.depth_min, camc.depth_trunc)
    dec = [decode_raw_frame(torch.from_numpy(d).to(dev), torch.from_numpy(c).to(dev), *scal)
           for d, c in raw[:3]]
    gt = [torch.as_tensor(np.linalg.inv(poses[0]) @ T, dtype=torch.float32, device=dev)
          for T in poses]
    rays = pixel_rays(intr, dev)
    kernels = []
    failures = []

    # -- B1: one frame into a 2-frame volume, kernel vs plain ----------------
    vol = tsdf.create(tcfg, dev)
    for i in range(2):
        vol = tsdf.integrate_frame(vol, dec[i][0], dec[i][1], rays, gt[i], intr, tcfg)
    d2, c2, _ = dec[2]
    vol = tsdf.allocate(vol, d2, rays, gt[2], tcfg)
    wl, n_active = tk.build_worklist(vol.block_coords, vol.n_blocks, gt[2], intr, tcfg)
    wl = wl[:2048].contiguous()
    base = {k: getattr(vol, k).clone() for k in ("tsdf", "weight", "color")}
    vk = vol._replace(**{k: v.clone() for k, v in base.items()})
    vp = vol._replace(**{k: v.clone() for k, v in base.items()})
    tk.integrate_worklist_cuda(vk, wl, d2, c2, gt[2], intr, tcfg)
    tk.integrate_worklist_plain(vp, wl, d2, c2, gt[2], intr, tcfg)
    torch.cuda.synchronize()
    live = wl[: min(int(n_active), wl.shape[0]), 0].long()
    wk, wp = vk.weight[live], vp.weight[live]
    agree = wk == wp
    frac = float(agree.float().mean())
    err_t = float((vk.tsdf[live] - vp.tsdf[live]).abs()[agree].max())
    err_c = float((vk.color[live] - vp.color[live]).abs()[agree[:, None].expand(-1, 3, -1)].max())
    updated = float((wk != base["weight"][live]).float().mean())
    _log(f"B1 tsdf_integrate: {int(n_active)} live worklist rows, {updated:.3%} of their voxels "
         f"updated; weights equal on {frac:.6%}, max |dtsdf| {err_t:.3g}, max |dcolor| "
         f"{err_c:.3g} where they agree")
    if not (frac >= B1_WEIGHT_EQUAL_MIN and err_t <= B1_VALUE_TOL and err_c <= B1_VALUE_TOL):
        failures.append("B1 kernel disagrees with its plain version")
    ms_k = _time_ms(lambda: tk.integrate_worklist_cuda(vk, wl, d2, c2, gt[2], intr, tcfg), 50)
    ms_p = _time_ms(lambda: tk.integrate_worklist_plain(vp, wl, d2, c2, gt[2], intr, tcfg), 5)
    _log(f"B1 time at M=2048 ({int(n_active)} live): kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
    kernels.append(dict(name="tsdf_integrate", route="cuda",
                        source=f"{PKG}/csrc/tsdf_integrate.cu",
                        replaces="azurekinect3dreconstruction_tpu/ops/pallas/tsdf_kernels.py:323",
                        max_abs_err=max(err_t, err_c), ms=ms_k, plain_ms=ms_p,
                        weight_equal_fraction=frac))
    del vol, vk, vp, base

    # -- B2: one frame pair at [20,10,5], kernel vs plain ---------------------
    (d0, _, i0), (d1, _, i1) = dec[0], dec[1]
    args = (i0, d0, i1, d1, intr, ocfg)
    rk = odo.odometry_pyramid(odo.level_cuda, *args)
    rp = odo.odometry_pyramid(odo.level_plain, *args)
    torch.cuda.synchronize()
    err_T = float((rk.T_target_source - rp.T_target_source).abs().max())
    err_f = abs(float(rk.fitness) - float(rp.fitness))
    _log(f"B2 odometry_level: max |dpose| {err_T:.3g}, |dfitness| {err_f:.3g} "
         f"(fitness kernel {float(rk.fitness):.6f}, plain {float(rp.fitness):.6f})")
    if not (err_T <= B2_POSE_TOL and err_f <= B2_FITNESS_TOL):
        failures.append("B2 kernel disagrees with its plain version")
    # per frame: the pyramid's 3 level launches of both versions
    ms_k = _time_ms(lambda: odo.odometry_pyramid(odo.level_cuda, *args), 20)
    ms_p = _time_ms(lambda: odo.odometry_pyramid(odo.level_plain, *args), 3)
    _log(f"B2 time per frame pair (35 GN iterations): kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
    kernels.append(dict(name="odometry_level", route="cuda",
                        source=f"{PKG}/csrc/odometry_level.cu",
                        replaces="azurekinect3dreconstruction_tpu/ops/pallas/odometry_kernels.py:487",
                        max_abs_err=max(err_T, err_f), ms=ms_k, plain_ms=ms_p))

    # -- the main path: the live loop over 16 frames ---------------------------
    warm = MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048)
    for d, c in raw[:3]:
        warm.process_frame(d, c)
    torch.cuda.synchronize()
    del warm
    pipe = MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048)
    torch.cuda.synchronize()
    build.launches.clear()
    frame_ms = []
    for d, c in raw:
        t0 = time.perf_counter()
        pipe.process_frame(d, c)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {"tsdf_integrate": build.launches[tk.KERNEL],
              "odometry_level": build.launches[odo.KERNEL]}
    _log(f"launches on the main path: {json.dumps(counts)}")
    if counts["tsdf_integrate"] < N_FRAMES or \
            counts["odometry_level"] != 2 * sum(ocfg.pyramid_iters) * (N_FRAMES - 1):
        failures.append("a kernel of the main path was not launched as expected")
    for k in kernels:
        k["launches"] = counts[k["name"]]

    fit = pipe.fitness
    n_rejected = pipe.odometry_failures
    traj = pipe.trajectory[1:]
    gt_np = [g.cpu().numpy().astype(np.float64) for g in gt]
    a = ate(traj, gt_np)
    r = rpe(traj, gt_np)
    n_blocks, overflow = int(pipe.volume.n_blocks), bool(pipe.volume.overflow)
    pts, cols = pipe.extract_point_cloud()
    _log("fitness per tracked frame: " + " ".join(f"{f:.4f}" for f in fit))
    _log(f"ATE rmse {a['rmse'] * 1e3:.3f} mm (max {a['max'] * 1e3:.3f} mm, final drift "
         f"{a['final_drift'] * 1e3:.3f} mm); RPE trans {r['trans_rmse'] * 1e3:.3f} mm, "
         f"rot {np.degrees(r['rot_rmse']):.4f} deg")
    _log(f"n_blocks {n_blocks}, overflow {overflow}, surface points {pts.shape[0]}, "
         f"volume {tsdf.memory_bytes(tcfg) / 2**30:.3f} GiB")
    steady = sorted(frame_ms[1:])
    _log(f"ms/frame (host clock, synchronized per frame): frame 0 {frame_ms[0]:.3f}, "
         f"tracked median {steady[len(steady) // 2]:.3f}, min {steady[0]:.3f}, "
         f"max {steady[-1]:.3f}  [{gpu}]")
    # the live loop's own pace: the same frames again, one sync at the end
    pipe.reset()
    t0 = time.perf_counter()
    for d, c in raw:
        pipe.process_frame(d, c)
    torch.cuda.synchronize()
    _log(f"ms/frame (host clock, one sync after {N_FRAMES} frames): "
         f"{(time.perf_counter() - t0) * 1e3 / N_FRAMES:.3f}  [{gpu}]")
    if n_rejected or len(fit) != N_FRAMES - 1:
        failures.append(f"{n_rejected} frame(s) rejected by the fitness gate")
    if overflow:
        failures.append("volume overflow")
    if not a["rmse"] <= ATE_LIMIT_M:
        failures.append(f"ATE rmse {a['rmse']:.4f} m over {ATE_LIMIT_M} m")
    if not (pts.shape[0] > 10000 and np.isfinite(pts).all() and np.isfinite(cols).all()):
        failures.append("surface extraction is empty or not finite")
    if failures:
        return _fail("; ".join(failures))

    _log(json.dumps({"kernels": kernels}))
    _log(gpu)
    _log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
