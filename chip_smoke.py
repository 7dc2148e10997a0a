"""Drive the PyTorch/CUDA port once on one GPU, end to end, and check it.

    python3 chip_smoke.py

Builds the hand-written kernels of ``azurekinect3dreconstruction_tpu_torch/csrc``
with nvcc, then, at the bench headline configuration (640x576 NFOV depth,
5 mm voxels in 16^3 blocks, 16384-block pool, 65536-slot hash, 2048-block
worklist, odometry pyramid [20, 10, 5]):

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, times both with CUDA events, reads each
   kernel's device time per launch from ``torch.profiler``, computes its
   bound from this run's data, and captures one odometry call into a CUDA
   graph and replays it;
2. drives ``MonoOdometryTSDF(..., device="cuda").process_frame`` over the
   first 16 poses of the bench sweep (``orbit_trajectory(64, radius=0.35,
   angle_span=1.3)``), rendered on the card and quantized to u16 mm / u8 RGB,
   with every launch counter zeroed just before and read just after;
3. checks the result: every frame through the fitness gate, no overflow,
   ATE RMSE against the ground-truth poses <= 2 cm, finite surface points;
4. saves the mesh as the live entry point does: ``pipe.extract_mesh()`` on
   the card, ``weld_vertices``, ``write_ply_mesh`` to a temporary directory
   and ``read_ply`` back, and extracts again from a CPU copy of the same
   volume: same triangle count, vertices <= 1e-5 after a canonical sort;
5. drives ``MonoOdometryTSDF(..., tracking="frame_to_model")`` over the
   first 32 poses of the sweep, with frame-to-frame tracking over the same
   poses beside it, the launch counters zeroed just before and read just
   after: ATE <= 2 cm and <= the frame-to-frame ATE + 0.5 mm, refinements
   accepted, no gate rejection, no overflow, both kernels launched; then
   times the phases of one frame-to-model frame;
6. drives two-camera fusion, ``DualCameraFusion(..., device="cuda")``:
   auto-calibrates the rig of ``tests/test_pipelines.py`` (within 2 cm /
   0.03 rad of the truth) and times its stages; fuses the bench's rig
   (camera 1 35 cm left, toed in 0.26 rad) with its extrinsics set by
   hand, the static pair 24 times and the moving rig over the first 24
   sweep poses, each synchronized per pair and with one sync at the end,
   the launch counters zeroed just before the moving pass and read just
   after: B1 launched exactly twice a pair, blocks allocated throughout, no
   overflow; holds the first 4 moving pairs on the card against a CPU
   pipeline (plain B1) by block key with B1's tolerances; saves the merged
   cloud and the mesh and reads them back.

Prints the card's name and power limit, the build time, the launch counts,
per-frame fitness, ATE/RPE, ms/frame, mesh, frame-to-model and two-camera
results, one JSON line of per-kernel results, and, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, on
any failure or when no CUDA device is available. Needs no jax.

    python3 chip_smoke.py --odometry

times only the odometry of the package beside the script, with calls that
every version of the port has: B2's device time and launches per frame pair
and the odometry phase (``compute_odometry_fast`` on the first frame pair),
and the mono loop's ms/frame over the 16 frames. It prints the card's name
and power limit, then one JSON line. To compare a change with its parent on
one card, copy this script into an unpacked parent commit and run both in
one call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "azurekinect3dreconstruction_tpu_torch"
N_FRAMES = 16
ODO_REPS = 50  # odometry calls per timing of one frame pair
N_F2M_FRAMES = 32
ATE_LIMIT_M = 0.02
F2M_ATE_SLACK_M = 0.0005  # frame-to-model may not drift more than frame-to-frame + this
MESH_VERTEX_TOL = 1e-5  # card vs CPU copy, canonical sort (test_marching_cubes.py's bound)
# kernel vs plain, on the card (see PERF.md): B1 differs only where a voxel
# sits on a half-pixel edge; B2 sums ~370k pixels in another order
B1_WEIGHT_EQUAL_MIN = 0.9999
B1_VALUE_TOL = 1e-5
B2_POSE_TOL = 1e-4
B2_FITNESS_TOL = 1e-3
# published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): float32
# outside the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# B1 per updated voxel: read and write tsdf, weight and 3 colors (5 x 4 B each way)
B1_BYTES_PER_UPDATED_VOXEL = 40
# B2 flops: per source pixel of a level (Sobel of 2 planes, back-projection),
# per pixel-iteration with valid source depth (transform, projection), and
# per valid pixel-iteration (2 bilinear samples, Jacobians, weights, 27
# weighted products, cost); fma counted as 2
B2_FLOPS_PROLOGUE = 38
B2_FLOPS_WARP = 25
B2_FLOPS_VALID = 220
N_DUAL_PAIRS = 24
N_DUAL_CPU_PAIRS = 4
# the calibration rig of tests/test_pipelines.py and its bounds there
CALIB_RIG_XI = (0.12, 0.03, -0.02, 0.05, -0.12, 0.04)
CALIB_T_LIMIT_M = 0.02
CALIB_R_LIMIT_RAD = 0.03


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


def _device_us(fn, reps: int, kernel: str):
    """Device time per call of the CUDA kernels whose name holds ``kernel``,
    from ``torch.profiler`` over ``reps`` calls after one warm-up, and their
    launches per call; (None, 0) when the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if kernel in e.key and t > 0:
            total += t
            count += e.count
    return (total / reps if total > 0 else None), count / reps


def _bound(n_bytes: float, flops: float):
    """(bound ms, what sets it): the larger of bytes over HBM bandwidth and
    flops over the float32 peak."""
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.3f} us"


def b2_work(pyr_s, pyr_t, intr, cfg, terms):
    """The work of one frame pair at this run's data, from the plain
    version's own iterations: (source pixels of the levels that iterate,
    pixel-iterations with valid source depth, valid pixel-iterations)."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo

    dev = pyr_s[0][0].device
    state = torch.zeros(odo.STATE, device=dev)
    state[:12] = torch.eye(4, device=dev)[:3].reshape(-1)
    pixels = src = valid = 0.0
    for lvl in reversed(range(len(cfg.pyramid_iters))):
        state[12] = 0.0
        iters = cfg.pyramid_iters[lvl]
        if iters <= 0:
            continue
        li = intr.scaled(1.0 / (1 << lvl))
        planes = odo.level_inputs(*pyr_s[lvl], *pyr_t[lvl])
        prm = odo._level_params(li, cfg, *terms)
        pixels += li.height * li.width
        for _ in range(iters):
            if float(state[12]) != 0.0:
                break
            sums = odo._gn_sums(state, *planes, li, prm)
            src += float(sums[29])
            valid += float(sums[27])
            odo._solve_step(state, sums, prm)
    return pixels, src, valid


def _median_ms(fn, dev, reps: int = 5) -> float:
    """Median time of ``fn`` over ``reps`` calls, each closed by a device
    synchronization: CUDA events on a card, the host clock on the CPU."""
    import torch

    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def odometry_timing(odo, args, dev):
    """One frame pair through ``compute_odometry_fast(*args)``: device us
    per call of its odometry kernels and their launches per call
    (``torch.profiler``), and the call's ms, synchronized after each call
    (median of ``ODO_REPS``, CUDA events)."""
    call = lambda: odo.compute_odometry_fast(*args)
    us, per_call = _device_us(call, ODO_REPS, "odometry")
    return us, per_call, _median_ms(call, dev, ODO_REPS)


def _quantize(rendered):
    """A rendered (depth m, color 0..1) pair as the sensor gives it: u16 mm
    and u8 RGB on the host."""
    import numpy as np
    import torch

    z, c = rendered
    return (torch.round(z * 1000.0).cpu().numpy().astype(np.uint16),
            torch.round(c * 255.0).cpu().numpy().astype(np.uint8))


def _bench(dev, n: int):
    """The bench headline configuration, its intrinsics and synthetic
    camera, the first ``n`` poses of the bench sweep and their frames."""
    from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
        SyntheticCamera,
        orbit_trajectory,
    )

    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=16,
                                         block_capacity=16384, hash_capacity=65536))
    intr = Intrinsics.azure_kinect_depth_nfov()
    cam = SyntheticCamera(intrinsics=intr, device=dev)
    poses = orbit_trajectory(64, radius=0.35, angle_span=1.3)[:n]
    return cfg, intr, cam, poses, [_quantize(cam.render(T)) for T in poses]


def _decode(raw_pair, cfg, dev):
    """(depth, color, intensity) on the card, decoded as the live loop does."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.core.types import decode_raw_frame

    d, c = raw_pair
    cc = cfg.camera
    return decode_raw_frame(torch.from_numpy(d).to(dev), torch.from_numpy(c).to(dev),
                            1.0 / cc.depth_scale, cc.depth_min, cc.depth_trunc)


def _run_frames(pipe, raw, each: bool):
    """Host-clock ms of ``pipe.process_frame`` over ``raw``: each frame's,
    synchronized after each, when ``each``; else ms/frame with one
    synchronization at the end."""
    import torch

    frame_ms = []
    t0 = time.perf_counter()
    for d, c in raw:
        pipe.process_frame(d, c)
        if each:
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    return frame_ms if each else (time.perf_counter() - t0) * 1e3 / len(raw)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def mesh_phase(pipe, tcfg, dev, gpu: str) -> list:
    """The save path on the card, checked against a CPU copy of the same
    volume. Returns the failures."""
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
    from azurekinect3dreconstruction_tpu_torch.tsdf.marching_cubes import (
        extract_mesh,
        weld_vertices,
    )
    from azurekinect3dreconstruction_tpu_torch.viz.savers import read_ply, write_ply_mesh

    failures = []
    mesh = pipe.extract_mesh()
    soup = mesh.compact()
    nt = soup.triangles.shape[0]
    welded = weld_vertices(soup)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.ply")
        write_ply_mesh(path, welded)
        size = os.path.getsize(path)
        v, _, f = read_ply(path)
    round_trip = (v.shape == welded.vertices.shape and np.array_equal(v, welded.vertices)
                  and np.array_equal(f, welded.triangles))
    host = pipe.volume._replace(**{k: t.cpu() for k, t in pipe.volume._asdict().items()})
    ref = extract_mesh(host, tcfg).compact()

    def canon(a):
        return a[np.lexsort(a.T)]

    same_count = ref.triangles.shape[0] == nt
    err = (float(np.abs(canon(soup.vertices) - canon(ref.vertices)).max())
           if same_count and nt else float("inf"))
    same_order = same_count and np.array_equal(soup.vertices, ref.vertices)
    ms = _median_ms(pipe.extract_mesh, dev)
    # its phases: survey (case codes, padded corner cubes), emission at the
    # exact budgets, the soup's copy to the host; then the host-side save
    vol = pipe.volume
    E = mc.snap_extract_blocks(int(vol.n_blocks), vol.tsdf.shape[0])
    sv = mc._survey(vol, tcfg, extract_blocks=E)
    cells = max(65536, int(mc._active_groups(sv.case).sum()) * mc.GROUP)  # as extract_mesh
    out = mc._emit(sv, tcfg, cells, nt)
    with tempfile.TemporaryDirectory() as tmp:
        phases = {
            "survey": lambda: mc._survey(vol, tcfg, extract_blocks=E),
            "emit": lambda: mc._emit(sv, tcfg, cells, nt),
            "copy_to_host": lambda: [a.permute(2, 0, 1).reshape(-1, 3).cpu() for a in out[:2]],
            "weld (host)": lambda: weld_vertices(soup),
            "write_ply (host)": lambda: write_ply_mesh(os.path.join(tmp, "m.ply"), welded),
        }
        times = {k: round(_median_ms(fn, dev), 4) for k, fn in phases.items()}
    _log(f"mesh: {nt} triangles, {welded.vertices.shape[0]} welded vertices, PLY {size} bytes "
         f"read back {'equal' if round_trip else 'DIFFERENT'}; CPU copy {ref.triangles.shape[0]} "
         f"triangles, max |dvertex| {err:.3g} after canonical sort, same order {same_order}, "
         f"overflow {mesh.overflow}  [{gpu}]")
    _log(f"extract_mesh ms (CUDA events, median of 5, host copy included): {ms:.3f}; phase ms "
         f"(synchronized after each, median of 5): {json.dumps(times)}  [{gpu}]")
    if nt == 0 or not (np.isfinite(soup.vertices).all() and np.isfinite(soup.vertex_colors).all()):
        failures.append("the mesh is empty or not finite")
    if not round_trip:
        failures.append("the PLY file does not read back as written")
    if not (same_count and err <= MESH_VERTEX_TOL):
        failures.append("the card's mesh differs from the CPU copy's")
    if mesh.overflow:
        failures.append("mesh extraction overflowed")
    return failures


def f2m_phase(intr, cfg, raw, gt, dev, gpu: str):
    """Frame-to-model tracking over ``raw`` beside frame-to-frame, checked
    against the ground truth ``gt``, then a phase breakdown of one frame.
    Returns (failures, launch counts of the frame-to-model pass)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.core.types import decode_raw_frame
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
        apply_odometry_gate,
    )
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import (
        GraphedICP,
        TargetMaps,
        icp_projective,
    )
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate

    n = len(raw)
    gt_np = [g.cpu().numpy().astype(np.float64) for g in gt]
    kw = dict(device=dev, worklist_size=2048)
    pf = MonoOdometryTSDF(intr, cfg, **kw)
    for d, c in raw:
        pf.process_frame(d, c)
    a_f = ate(pf.trajectory[1:], gt_np)

    warm = MonoOdometryTSDF(intr, cfg, tracking="frame_to_model", **kw)
    for d, c in raw[:7]:  # a refresh at frame 5, then refinements
        warm.process_frame(d, c)
    _sync(dev)
    del warm
    pm = MonoOdometryTSDF(intr, cfg, tracking="frame_to_model", model_refine_interval=5, **kw)
    _sync(dev)
    build.launches.clear()
    frame_ms = []
    for d, c in raw:
        t0 = time.perf_counter()
        pm.process_frame(d, c)
        _sync(dev)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    a_m = ate(pm.trajectory[1:], gt_np)
    ev = pm.counts
    rejected = pm.odometry_failures
    overflow = bool(pm.volume.overflow)
    _log(f"frame_to_model launches: {json.dumps(counts)}  [{gpu}]")
    _log(f"frame_to_model over {n} frames: ATE rmse {a_m['rmse'] * 1e3:.3f} mm (max "
         f"{a_m['max'] * 1e3:.3f} mm, final drift {a_m['final_drift'] * 1e3:.3f} mm); "
         f"frame_to_frame ATE rmse {a_f['rmse'] * 1e3:.3f} mm (max {a_f['max'] * 1e3:.3f} mm); "
         f"refinements {json.dumps(ev)}, gate rejections {rejected}, overflow {overflow}, "
         f"n_blocks {int(pm.volume.n_blocks)}  [{gpu}]")
    steady = sorted(frame_ms[1:])
    _log(f"frame_to_model ms/frame (host clock, synchronized per frame): frame 0 "
         f"{frame_ms[0]:.3f}, tracked median {steady[len(steady) // 2]:.3f}, min "
         f"{steady[0]:.3f}, max {steady[-1]:.3f}  [{gpu}]")
    pm.reset()
    t0 = time.perf_counter()
    for d, c in raw:
        pm.process_frame(d, c)
    _sync(dev)
    _log(f"frame_to_model ms/frame (host clock, one sync after {n} frames): "
         f"{(time.perf_counter() - t0) * 1e3 / n:.3f}  [{gpu}]")

    failures = []
    if not (a_m["rmse"] <= ATE_LIMIT_M and a_m["rmse"] <= a_f["rmse"] + F2M_ATE_SLACK_M):
        failures.append(f"frame_to_model ATE {a_m['rmse']:.5f} m over the limit "
                        f"(frame_to_frame {a_f['rmse']:.5f} m)")
    if ev.get("model_icp_ok", 0) == 0:
        failures.append("frame_to_model never accepted a refinement")
    if rejected or pf.odometry_failures:
        failures.append("a frame was rejected by the fitness gate")
    if overflow or bool(pf.volume.overflow):
        failures.append("volume overflow on the frame_to_model pass")
    if counts[tk.KERNEL] < n or counts[odo.KERNEL] != n - 1:
        failures.append("a kernel was not launched as expected on the frame_to_model pass "
                        "(B2 once per frame pair)")

    # phases of one frame (the last pair) against the pipeline's final model
    cam = cfg.camera
    up = lambda a: torch.from_numpy(a).to(dev)
    scal = (1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc)
    prev = decode_raw_frame(up(raw[-2][0]), up(raw[-2][1]), *scal)
    d, c, inten = decode_raw_frame(up(raw[-1][0]), up(raw[-1][1]), *scal)
    mp, mm = pm._model
    T_prev = pm._traj[-2]
    vol = pm.volume._replace(**{k: t.clone() for k, t in pm.volume._asdict().items()})
    res = odo.compute_odometry_fast(prev[2], prev[0], inten, d, intr, cfg.odometry)
    T_odo, _ = apply_odometry_gate(T_prev, res, pm.MIN_FITNESS)
    dist_thr = cfg.registration.icp_distance_threshold
    refine = GraphedICP(intr, 10, dist_thr)
    maps = TargetMaps.from_depth(d, pm.rays)
    refine(mp, mm, maps, se3.inverse(T_odo))  # capture outside the timing
    phases = {
        "decode": lambda: decode_raw_frame(up(raw[-1][0]), up(raw[-1][1]), *scal),
        "odometry": lambda: odo.compute_odometry_fast(prev[2], prev[0], inten, d, intr,
                                                      cfg.odometry),
        "gate": lambda: apply_odometry_gate(T_prev, res, pm.MIN_FITNESS),
        "icp_refine": lambda: refine(mp, mm, TargetMaps.from_depth(d, pm.rays),
                                     se3.inverse(T_odo)),
        "icp_refine_eager": lambda: icp_projective(
            mp, mm, TargetMaps.from_depth(d, pm.rays), intr, init=se3.inverse(T_odo),
            max_iters=10, dist_thr=dist_thr),
        "fuse": lambda: tk.integrate_step(vol, d, c, T_odo, pm.rays, intr, cfg.tsdf, 2048),
        "model_refresh": lambda: mc.extract_sampled_surface_model(
            pm.volume, cfg.tsdf, pm.model_points, pm._T, pm._model_reach(),
            sample_blocks=pm.model_sample_blocks),
    }
    times = {k: round(_median_ms(fn, dev), 4) for k, fn in phases.items()}
    _log(f"frame_to_model phase ms (synchronized after each, median of 5; icp_refine = the "
         f"CUDA-graph replay the step runs, icp_refine_eager = the same loop launched op by op; "
         f"fuse = allocate + worklist + B1): {json.dumps(times)}  [{gpu}]")
    return failures, counts


def bench_rig():
    """Camera 1 in camera 0's frame on the bench's two-camera rig: 35 cm to
    the left, 5 cm forward, toed in 0.26 rad about y."""
    import numpy as np

    a = 0.26
    rig = np.eye(4)
    rig[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    rig[:3, 3] = [-0.35, 0.0, 0.05]
    return rig


def _volumes_by_key(vg, vc):
    """Two volumes' blocks matched by key: (same key set, weights equal
    fraction, max |dtsdf|, max |dcolor| where the weights agree)."""
    import numpy as np

    def keyed(v):
        n = int(v.n_blocks)
        return {tuple(k): s for s, k in enumerate(v.block_coords[:n].cpu().numpy().tolist())}

    kg, kc = keyed(vg), keyed(vc)
    if kg.keys() != kc.keys() or not kg:
        return False, 0.0, float("inf"), float("inf")
    keys = sorted(kg)
    rows = lambda v, k, f: getattr(v, f)[[k[x] for x in keys]].cpu().numpy()
    wg, wc = rows(vg, kg, "weight"), rows(vc, kc, "weight")
    agree = wg == wc
    err_t = float(np.abs(rows(vg, kg, "tsdf") - rows(vc, kc, "tsdf"))[agree].max())
    dcol = np.abs(rows(vg, kg, "color") - rows(vc, kc, "color"))
    err_c = float(dcol[np.broadcast_to(agree[:, None], dcol.shape)].max())
    return True, float(agree.mean()), err_t, err_c


def dual_phase(intr, cfg, dev, gpu: str, n_pairs: int = N_DUAL_PAIRS,
               cpu_pairs: int = N_DUAL_CPU_PAIRS):
    """Two-camera fusion, ``DualCameraFusion(..., device=dev)``: (a) auto-
    calibration of the test rig with its stage times; (b) fusion at the
    bench rig with its extrinsics set by hand, the static pair and the
    moving rig over the sweep, synchronized per pair and with one sync at
    the end; (c) the first ``cpu_pairs`` moving pairs on the card against
    a CPU pipeline, by block key; (d) the save, read back. Returns
    (failures, B1 launches of the moving-rig pass)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.core.device import upload
    from azurekinect3dreconstruction_tpu_torch.core.types import decode_raw_frame
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
        SyntheticCamera,
        orbit_trajectory,
    )
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import DualCameraFusion
    from azurekinect3dreconstruction_tpu_torch.viz.savers import read_obj, read_ply

    failures = []
    cam = SyntheticCamera(intrinsics=intr, device=dev)
    ms_since = lambda t0: (time.perf_counter() - t0) * 1e3
    tmp = tempfile.TemporaryDirectory()

    def pipeline(device=dev, calibrated=False):
        p = DualCameraFusion((intr, intr), cfg, device=device, output_dir=tmp.name)
        p.calibrated = calibrated
        return p

    # -- a. auto-calibration of the test rig --------------------------------------
    T1 = se3.se3_exp(torch.tensor(CALIB_RIG_XI, dtype=torch.float64)).numpy()
    pair = (cam.capture(np.eye(4)), cam.capture(T1))
    warm = pipeline()
    warm.process_frames(pair)  # lazy library and handle set-up stays out of the timing
    _sync(dev)
    del warm
    pc = pipeline()
    t0 = time.perf_counter()
    pc.process_frames(pair)
    _sync(dev)
    calib_ms = ms_since(t0)
    err = (np.zeros(6) if pc.extrinsics[1] is None else se3.se3_log(
        torch.as_tensor(np.linalg.inv(T1) @ pc.extrinsics[1])).numpy())
    et, er = float(np.linalg.norm(err[:3])), float(np.linalg.norm(err[3:]))
    stages = {k: round(v, 4) for k, v in pc.calib_stage_ms.items()}
    _log(f"dual calibration (test rig): calibrated {pc.calibrated}, extrinsic error "
         f"{et * 1e3:.4f} mm / {er * 1e3:.4f} mrad; first pair {calib_ms:.3f} ms (host clock, "
         f"calibration + fuse); stage ms (synchronized after each): {json.dumps(stages)} "
         f"(sum {sum(stages.values()):.3f})  [{gpu}]")
    if not (pc.calibrated and et <= CALIB_T_LIMIT_M and er <= CALIB_R_LIMIT_RAD):
        failures.append(f"dual calibration off: calibrated {pc.calibrated}, "
                        f"{et:.4f} m / {er:.4f} rad")
    del pc

    # -- b. fusion at the bench rig, extrinsics set by hand ------------------------
    poses = orbit_trajectory(64, radius=0.35, angle_span=1.3)[:n_pairs]
    rig = bench_rig()
    static = (cam.capture(poses[0]), cam.capture(poses[0] @ rig))
    moving = [((cam.capture(T), cam.capture(T @ rig)), T, T @ rig) for T in poses]
    ps = pipeline(calibrated=True)
    ps.extrinsics = [poses[0], poses[0] @ rig]
    for _ in range(2):
        ps.process_frames(static)
    _sync(dev)
    per_pair = []
    for _ in range(n_pairs):
        t0 = time.perf_counter()
        ps.process_frames(static)
        _sync(dev)
        per_pair.append(ms_since(t0))
    t0 = time.perf_counter()
    for _ in range(n_pairs):
        ps.process_frames(static)
    _sync(dev)
    static_one = ms_since(t0) / n_pairs
    overflow = bool(ps.volume.overflow)
    del ps

    pm = pipeline(calibrated=True)
    _sync(dev)
    build.launches.clear()
    mv, n_blocks = [], {}
    for j, (pr, A, B) in enumerate(moving):
        t0 = time.perf_counter()
        pm.extrinsics = [A, B]
        pm.process_frames(pr)
        _sync(dev)
        mv.append(ms_since(t0))
        if j + 1 in (n_pairs // 2, n_pairs):
            n_blocks[j + 1] = int(pm.volume.n_blocks)
    launches = build.launches[tk.KERNEL]
    pm2 = pipeline(calibrated=True)
    _sync(dev)
    t0 = time.perf_counter()
    for pr, A, B in moving:
        pm2.extrinsics = [A, B]
        pm2.process_frames(pr)
    _sync(dev)
    moving_one = ms_since(t0) / n_pairs
    overflow = overflow or bool(pm.volume.overflow) or bool(pm2.volume.overflow)
    del pm2
    med = lambda a: sorted(a)[len(a) // 2]
    _log(f"dual launches on the moving-rig pass: {json.dumps({tk.KERNEL: launches})} over "
         f"{n_pairs} pairs  [{gpu}]")
    _log(f"dual ms/pair (host clock; raw pairs uploaded from host memory): static pair "
         f"synchronized per pair median {med(per_pair):.3f} (min {min(per_pair):.3f}, max "
         f"{max(per_pair):.3f}), one sync after {n_pairs} {static_one:.3f}; moving rig "
         f"synchronized per pair median {med(mv):.3f} (min {min(mv):.3f}, max {max(mv):.3f}), "
         f"one sync after {n_pairs} {moving_one:.3f}; n_blocks {json.dumps(n_blocks)}, "
         f"overflow {overflow}  [{gpu}]")
    # phases of one moving pair, on a copy of the moving rig's volume
    cc = cfg.camera
    scal = (1.0 / cc.depth_scale, cc.depth_min, cc.depth_trunc)
    (pr, A, B) = moving[-1]
    raw = [(upload(d, dev), upload(c, dev)) for d, c in pr]
    dec = [decode_raw_frame(d, c, *scal) for d, c in raw]
    vol = pm.volume._replace(**{k: t.clone() for k, t in pm.volume._asdict().items()})
    TA, TB = (torch.as_tensor(T, dtype=torch.float32, device=dev) for T in (A, B))
    rays = pm.rays[0]
    phases = {
        "upload (2 raw frames)": lambda: [(upload(d, dev), upload(c, dev)) for d, c in pr],
        "decode x2": lambda: [decode_raw_frame(d, c, *scal) for d, c in raw],
        "fuse camera 0": lambda: tk.integrate_step(vol, *dec[0][:2], TA, rays, intr, cfg.tsdf,
                                                   2048),
        "fuse camera 1": lambda: tk.integrate_step(vol, *dec[1][:2], TB, rays, intr, cfg.tsdf,
                                                   2048),
        "step": lambda: pm._step(vol, *raw[0], *raw[1], rays, rays, TA, TB, *scal,
                                 torch.ones((), device=dev)),
    }
    times = {k: round(_median_ms(fn, dev), 4) for k, fn in phases.items()}
    del vol
    _log(f"dual pair phase ms (synchronized after each, median of 5; fuse = allocate + worklist "
         f"+ B1, step = decode x2 + fuse x2 as process_frames enqueues it): "
         f"{json.dumps(times)}  [{gpu}]")
    half, full = n_blocks.get(n_pairs // 2, 0), n_blocks.get(n_pairs, 0)
    if not 0 < half < full:
        failures.append(f"the moving rig did not allocate throughout ({half} -> {full})")
    if overflow:
        failures.append("volume overflow in dual fusion")
    if launches != 2 * n_pairs:
        failures.append(f"B1 launched {launches} times over {n_pairs} dual pairs, not 2 each")

    # -- c. the card against the CPU (plain B1) on the first moving pairs ----------
    pg, pcpu = pipeline(calibrated=True), pipeline(torch.device("cpu"), calibrated=True)
    t0 = time.perf_counter()
    for pr, A, B in moving[:cpu_pairs]:
        for p in (pg, pcpu):
            p.extrinsics = [A, B]
            p.process_frames(pr)
    same_keys, frac, err_t, err_c = _volumes_by_key(pg.volume, pcpu.volume)
    _log(f"dual card vs CPU over {cpu_pairs} moving pairs: same block keys {same_keys} "
         f"({int(pg.volume.n_blocks)} blocks), weights equal on {frac:.6%}, max |dtsdf| "
         f"{err_t:.3g}, max |dcolor| {err_c:.3g} where they agree ({ms_since(t0) / 1e3:.1f} s)")
    if not (same_keys and frac >= B1_WEIGHT_EQUAL_MIN and err_t <= B1_VALUE_TOL
            and err_c <= B1_VALUE_TOL):
        failures.append("dual fusion on the card differs from the CPU pipeline")
    del pg, pcpu

    # -- d. the save (into the pipelines' temporary output directory) -----------------
    t0 = time.perf_counter()
    paths = pm.save_current_state()
    save_ms = ms_since(t0)
    cv, cc, _ = read_ply(paths["pointcloud"]) if "pointcloud" in paths else (None,) * 3
    mv_, _, mf = read_obj(paths["mesh"])
    ok_cloud = cv is not None and len(cv) > 10000 and np.isfinite(cv).all() and cc is not None
    ok_mesh = mf is not None and len(mf) > 10000 and np.isfinite(mv_).all() and mf.max() < len(mv_)
    _log(f"dual save: merged cloud {0 if cv is None else len(cv)} points, mesh "
         f"{len(mv_)} vertices / {0 if mf is None else len(mf)} triangles read back; "
         f"save_current_state {save_ms:.1f} ms (host)  [{gpu}]")
    if not (ok_cloud and ok_mesh):
        failures.append("the dual save did not read back non-empty and finite")
    tmp.cleanup()
    return failures, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(REPO, PKG)):
        return _fail(f"the {PKG} package is not beside this script")
    sys.path.insert(0, REPO)
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory
    from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid
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

    cfg, intr, cam, poses, raw = _bench(dev, N_FRAMES)
    tcfg, ocfg = cfg.tsdf, cfg.odometry
    dec = [_decode(r, cfg, dev) for r in raw[:3]]
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
    n_updated = int((wk != base["weight"][live]).sum())
    updated = n_updated / max(wk.numel(), 1)
    _log(f"B1 tsdf_integrate: {int(n_active)} live worklist rows, {updated:.3%} of their voxels "
         f"updated; weights equal on {frac:.6%}, max |dtsdf| {err_t:.3g}, max |dcolor| "
         f"{err_c:.3g} where they agree")
    if not (frac >= B1_WEIGHT_EQUAL_MIN and err_t <= B1_VALUE_TOL and err_c <= B1_VALUE_TOL):
        failures.append("B1 kernel disagrees with its plain version")
    b1_call = lambda: tk.integrate_worklist_cuda(vk, wl, d2, c2, gt[2], intr, tcfg)
    ms_k = _time_ms(b1_call, 50)
    ms_p = _time_ms(lambda: tk.integrate_worklist_plain(vp, wl, d2, c2, gt[2], intr, tcfg), 5)
    us_k, per_call = _device_us(b1_call, 20, "tsdf_integrate_kernel")
    # bound: the voxels this frame updates, read and written once; the live
    # worklist rows, the depth and color images and the pose read once
    n_live = live.numel()
    b1_bytes = (n_updated * B1_BYTES_PER_UPDATED_VOXEL + n_live * 16 + d2.numel() * 4
                + c2.numel() * 4 + 64)
    b1_bound, b1_by = _bound(b1_bytes, 0.0)
    _log(f"B1 time at M=2048 ({int(n_active)} live): wrapper {ms_k:.4f} ms (CUDA events), "
         f"device {_fmt_us(us_k)} per launch ({per_call:g} kernel/call, torch.profiler), plain "
         f"{ms_p:.4f} ms; bound {b1_bound * 1e3:.3f} us ({b1_by}: {n_updated} voxels updated, "
         f"{b1_bytes / 1e6:.2f} MB)  [{gpu}]")
    kernels.append(dict(name=tk.KERNEL, route="cuda",
                        source=f"{PKG}/csrc/tsdf_integrate.cu",
                        replaces="azurekinect3dreconstruction_tpu/ops/pallas/tsdf_kernels.py:323",
                        max_abs_err=max(err_t, err_c), ms=ms_k, plain_ms=ms_p,
                        bound_ms=b1_bound, bound_by=b1_by, library_ms=None,
                        device_us=us_k, weight_equal_fraction=frac))
    del vol, vk, vp, base

    # -- B2: one frame pair at [20,10,5], kernel vs plain ---------------------
    (d0, _, i0), (d1, _, i1) = dec[0], dec[1]
    args = (i0, d0, i1, d1, intr, ocfg)
    rk = odo.odometry_pyramid(odo.pyramid_cuda, *args)
    rp = odo.odometry_pyramid(odo.pyramid_plain, *args)
    torch.cuda.synchronize()
    err_T = float((rk.T_target_source - rp.T_target_source).abs().max())
    err_f = abs(float(rk.fitness) - float(rp.fitness))
    rk2 = odo.odometry_pyramid(odo.pyramid_cuda, *args)
    same = bool(torch.equal(rk.T_target_source, rk2.T_target_source))
    _log(f"B2 odometry_pyramid: max |dpose| {err_T:.3g}, |dfitness| {err_f:.3g} "
         f"(fitness kernel {float(rk.fitness):.6f}, plain {float(rp.fitness):.6f}); "
         f"a second launch equal to the bit: {same}")
    if not (err_T <= B2_POSE_TOL and err_f <= B2_FITNESS_TOL and same):
        failures.append("B2 kernel disagrees with its plain version or with itself")
    # the runners on one prebuilt pyramid (the wrapper alone), then the whole call
    levels = len(ocfg.pyramid_iters)
    pyr_s, pyr_t = build_pyramid(i0, d0, levels), build_pyramid(i1, d1, levels)
    terms = (0.0 if ocfg.term == "depth" else 1.0, 0.0 if ocfg.term == "color" else 1.0)
    state0 = torch.zeros(odo.STATE, device=dev)
    state0[:12] = torch.eye(4, device=dev)[:3].reshape(-1)
    runner = lambda run: (lambda: run(state0.clone(), pyr_s, pyr_t, intr, ocfg, *terms))
    ms_k = _time_ms(runner(odo.pyramid_cuda), 20)
    ms_p = _time_ms(runner(odo.pyramid_plain), 3)
    us_k, per_call, ms_call = odometry_timing(odo, args, dev)
    grid, band = odo.launch_grid()
    pixels, n_src, n_valid = b2_work(pyr_s, pyr_t, intr, ocfg, terms)
    b2_flops = (pixels * B2_FLOPS_PROLOGUE + n_src * B2_FLOPS_WARP + n_valid * B2_FLOPS_VALID)
    b2_bytes = 4 * 4 * pixels + 64  # I_s, D_s, I_t, D_t of every level, read once
    b2_bound, b2_by = _bound(b2_bytes, b2_flops)
    _log(f"B2 per frame pair ({sum(ocfg.pyramid_iters)} GN iterations, one launch): wrapper "
         f"{ms_k:.4f} ms (CUDA events), device {_fmt_us(us_k)} per launch ({per_call:g} "
         f"kernel/call, torch.profiler), plain {ms_p:.4f} ms; compute_odometry_fast "
         f"(pyramids + launch, synchronized, median of {ODO_REPS}) {ms_call:.4f} ms; bound "
         f"{b2_bound * 1e3:.3f} us ({b2_by}: {pixels:.0f} level pixels, {n_src:.0f} / "
         f"{n_valid:.0f} source-valid / valid pixel-iterations, {b2_flops / 1e9:.3f} GFLOP, "
         f"{b2_bytes / 1e6:.2f} MB)  [{gpu}]")
    _log(f"B2 grid: {grid} CTAs x {band} pixels of shared memory each, so a level that "
         f"iterates may hold up to {grid * band} pixels")
    # one odometry call captured into a CUDA graph, replayed on the next pair
    static = [a.clone() for a in (i0, d0, i1, d1)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        odo.compute_odometry_fast(*static, intr, ocfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = odo.compute_odometry_fast(*static, intr, ocfg)
    (d2_, _, i2_) = dec[2]
    for t, a in zip(static, (i1, d1, i2_, d2_)):
        t.copy_(a)
    graph.replay()
    want = odo.compute_odometry_fast(i1, d1, i2_, d2_, intr, ocfg)
    torch.cuda.synchronize()
    replay_equal = bool(torch.equal(out.T_target_source, want.T_target_source))
    ms_graph = _median_ms(graph.replay, dev, 11)
    _log(f"B2 CUDA graph: one compute_odometry_fast call captured, its replay on the next pair "
         f"equal to the eager pose to the bit: {replay_equal}; replay {ms_graph:.4f} ms vs eager "
         f"{ms_call:.4f} ms (synchronized, median of 11)  [{gpu}]")
    if not replay_equal:
        failures.append("the CUDA-graph replay of B2 differs from the eager call")
    del graph
    kernels.append(dict(name=odo.KERNEL, route="cuda",
                        source=f"{PKG}/csrc/odometry_pyramid.cu",
                        replaces="azurekinect3dreconstruction_tpu/ops/pallas/odometry_kernels.py:487",
                        max_abs_err=max(err_T, err_f), ms=ms_k, plain_ms=ms_p,
                        bound_ms=b2_bound, bound_by=b2_by, library_ms=None, device_us=us_k,
                        odometry_call_ms=ms_call, graph_replay_ms=ms_graph,
                        max_level_pixels=grid * band))

    # -- the main path: the live loop over 16 frames ---------------------------
    _run_frames(MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048), raw[:3], False)
    pipe = MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048)
    torch.cuda.synchronize()
    build.launches.clear()
    frame_ms = _run_frames(pipe, raw, True)
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    _log(f"launches on the main path: {json.dumps(counts)}")
    if counts[tk.KERNEL] < N_FRAMES or counts[odo.KERNEL] != N_FRAMES - 1:
        failures.append("a kernel of the main path was not launched as expected "
                        "(B2 once per frame pair)")
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
    _log(f"ms/frame (host clock, one sync after {N_FRAMES} frames): "
         f"{_run_frames(pipe, raw, False):.3f}  [{gpu}]")
    if n_rejected or len(fit) != N_FRAMES - 1:
        failures.append(f"{n_rejected} frame(s) rejected by the fitness gate")
    if overflow:
        failures.append("volume overflow")
    if not a["rmse"] <= ATE_LIMIT_M:
        failures.append(f"ATE rmse {a['rmse']:.4f} m over {ATE_LIMIT_M} m")
    if not (pts.shape[0] > 10000 and np.isfinite(pts).all() and np.isfinite(cols).all()):
        failures.append("surface extraction is empty or not finite")

    # -- the save path and frame-to-model tracking -----------------------------
    failures += mesh_phase(pipe, tcfg, dev, gpu)
    del pipe
    poses32 = orbit_trajectory(64, radius=0.35, angle_span=1.3)[:N_F2M_FRAMES]
    raw32 = raw + [_quantize(cam.render(T)) for T in poses32[N_FRAMES:]]
    gt32 = [torch.as_tensor(np.linalg.inv(poses32[0]) @ T, dtype=torch.float32, device=dev)
            for T in poses32]
    f2m_failures, f2m_counts = f2m_phase(intr, cfg, raw32, gt32, dev, gpu)
    failures += f2m_failures
    for k in kernels:
        k["launches_frame_to_model"] = f2m_counts[k["name"]]
    dual_failures, dual_launches = dual_phase(intr, cfg, dev, gpu)
    failures += dual_failures
    kernels[0]["launches_dual"] = dual_launches
    if failures:
        return _fail("; ".join(failures))

    _log(json.dumps({"kernels": kernels}))
    _log(gpu)
    _log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


def odometry_main() -> int:
    """``--odometry``: the odometry numbers of the package beside this
    script, through calls every version of the port has."""
    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device is available")
    pkg_dir = os.path.join(REPO, PKG)
    if not os.path.isdir(pkg_dir):
        return _fail(f"the {PKG} package is not beside this script")
    sys.path.insert(0, REPO)
    import statistics

    import azurekinect3dreconstruction_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(pkg_dir + os.sep):
        return _fail(f"imported {port.__file__}, not the package beside this script")
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gpu = _gpu_line()
    _log(f"gpu: {gpu}")
    build.library()
    cfg, intr, _, _, raw = _bench(dev, N_FRAMES)
    (d0, _, i0), (d1, _, i1) = [_decode(r, cfg, dev) for r in raw[:2]]
    args = (i0, d0, i1, d1, intr, cfg.odometry)
    before = build.launches[odo.KERNEL]
    res = odo.compute_odometry_fast(*args)
    counter = build.launches[odo.KERNEL] - before
    us, per_call, ms_call = odometry_timing(odo, args, dev)
    pipe = MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048)
    frame_ms = _run_frames(pipe, raw, True)
    rejected = pipe.odometry_failures
    pipe.reset()
    loop_ms = _run_frames(pipe, raw, False)
    _log(json.dumps({
        "checkout": REPO, "gpu": gpu,
        "odometry_device_us_per_call": us, "odometry_kernels_per_call": per_call,
        "launch_counter_per_call": counter,
        "odometry_call_ms_synced_median": ms_call,
        "mono_ms_per_frame_synced_median": statistics.median(frame_ms[1:]),
        "mono_ms_per_frame_one_sync": loop_ms, "mono_gate_rejections": rejected,
        "pose": res.T_target_source.cpu().numpy().round(7).tolist(),
        "fitness": float(res.fitness)}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--odometry", action="store_true",
                    help="time only the odometry of the package beside this script")
    sys.exit(odometry_main() if ap.parse_args().odometry else main())
