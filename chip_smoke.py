"""Drive the PyTorch/CUDA port once on one GPU, end to end, and check it.

    python3 chip_smoke.py

Builds the hand-written kernels of ``azurekinect3dreconstruction_tpu_torch/csrc``
with nvcc, then, at the bench headline configuration (640x576 NFOV depth,
5 mm voxels in 16^3 blocks, 16384-block pool, 65536-slot hash, 2048-block
worklist, odometry pyramid [20, 10, 5]):

1. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, times both with CUDA events, reads each
   kernel's device time per launch from ``torch.profiler``, computes its
   bound from this run's data (B1's from the voxels the update rule
   updates, ``tsdf_kernels.updated_voxels``), prints B1's persistent grid,
   and captures one odometry call into a CUDA graph and replays it;
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
   cloud and the mesh and reads them back;
7. drives the recorder, ``Recorder(..., device="cuda")``, over the first 32
   sweep poses at the default keyframe interval (10), the launch counters
   zeroed just before and read just after: B1 exactly once a recorded
   frame, B2 never, every keyframe accepted by colored ICP, no overflow,
   the keyframes' ATE <= 2 cm; saves and reads back, times one keyframe
   step, its colored ICP and one interval step; then the keyframe jump of
   ``tests/test_pipelines.py`` must be rebased through the fallback ladder;
8. drives the offline bundle, ``OfflineBundle(..., device="cuda")``, over
   the first 12 sweep poses out and back (24 frames) and ``finalize``, the
   counters zeroed just before and read just after: B1 exactly once a
   logged frame, all in the reintegration, B2 never, a loop closure, the
   optimized ATE <= the raw chain's, no overflow, the mesh read back; and
   reintegrates 4 logged frames on the card and on the CPU, by block key;
9. drives relocalization, ``MonoOdometryTSDF(..., relocalize=True,
   reloc_window=2, reloc_interval=4)``: sweep poses 0-11, 6 dark frames,
   then the sweep resumed at pose 13, the counters zeroed just before and
   read just after: the loss declared once, ``n_blocks`` frozen from the
   first dark frame until the recovery, the final pose within 6 cm / 0.12
   rad, B2 exactly once a tracked frame, B1 once a tracked frame plus the
   first frame plus the recovery, no overflow; then a standalone
   ``Relocalizer`` on that volume from a neighbor hint (rung 0 must
   recover) and a garbage hint (None or a correct pose), the hint rung
   against a CPU copy of the volume (pose <= 1e-4), the attempts' and the
   8,192-hypothesis RANSAC's ms and memory, the warmup, and healthy
   ms/frame with and without ``relocalize`` over the 16 mono frames;
10. drives incremental extraction, ``IncrementalExtractor.update`` after
   each of the 16 mono frames and after a frame with only the central
   quarter of its depth (the compact path): every soup equal to
   ``extract_mesh``'s (count and centroid set), with its stage times and
   pull bytes beside the full extraction's ms;
11. drives the fragment pipeline, ``FragmentPipeline(..., device="cuda")``,
   on sweep poses 0, 4, 8 and 12: make fragments (each meshed from its own
   whole-pool volume at 10 mm voxels, 100k mesh samples), register, then
   integrate the scene, each stage timed, the counters zeroed just before
   and read just after: B1 exactly twice a captured frame, B2 never, every
   fragment pose within 3 cm of the true relative motion, a scene mesh, the
   peak device memory; and the scene volume against a CPU copy integrated
   at the card's poses, by block key;
12. drives the point-cloud accumulator, ``CloudAccumulator(...,
   device="cuda")``, every frame a keyframe (the JAX bench's
   configuration), over the first 8 sweep frames: keyframes/s with one sync
   at the end and the synchronized ms per keyframe, B1 and B2 never, the
   chain's ATE; the large-motion pair of ``tests/test_pipelines.py``
   recovered by the coarse FPFH + RANSAC seed (6 cm / 0.10 rad); the save
   read back; ``mesh_with_fallback`` on the model cloud (the SDF mesher:
   no Open3D, over 60k points) with its ms; the model's splat against a CPU
   copy by block key (weights within 1e-5 relative, tsdf and color within
   1e-5: float32 atomics on the card); the first 2 keyframes' poses against
   a CPU accumulator within 1e-4;
13. drives host streaming at the JAX bench's streaming configuration
   (``bench.py``'s corridor: a checkered wall at 0.55 m and 33 spheres;
   5 mm voxels, 16^3 blocks, a 1,024-block pool, ``depth_trunc`` 0.7 m):
   ``MonoOdometryTSDF(..., streaming=StreamingTSDF.for_pipeline(cfg,
   check_interval=8, margin=...))`` over 120 frames at 640x576 every
   0.045 m (margin 0.4) and 240 at quarter resolution every 0.04 m (margin
   0.3), each warm and then timed with the counters zeroed just before and
   read just after, and the same frames into a plain 4,096-block pool:
   no overflow, evictions, B1 exactly once a frame and B2 once a tracked
   frame, the trajectory and the sorted ``extract_mesh`` soup equal to the
   plain pass's to the bit, the point cloud's rows equal; frames/s of both,
   tick ms by stage, the host store's bytes; then
   ``python -m azurekinect3dreconstruction_tpu_torch.cli.live_mono --source
   synthetic --frames 24 --streaming`` in a subprocess must save a mesh, a
   cloud and a trajectory.

After step 4 it times ``tsdf.streaming._compact`` over the main path's
volume (the identity permutation) beside its bound. Between steps 1 and 2
it runs one 1024x1024 (WFOV unbinned) frame pair
through ``compute_odometry_fast``: B2 on its global-memory path against
the plain version on the card, with its device time and bound.

Prints the card's name and power limit, the build time, the launch counts,
per-frame fitness, ATE/RPE, ms/frame, mesh, frame-to-model and two-camera
results and each later phase's, one JSON line of per-kernel results (with
each path's launches), and, as the last line,
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

    python3 chip_smoke.py --integrate

does the same for B1 (TSDF integrate): its device time per launch on the
stated input (the third sweep frame into a 2-frame volume through
``integrate_worklist(..., worklist_size=2048)``), on the first frame's
whole-pool worklist (``integrate_frame``), and over the 16-frame mono loop,
with the bound and its bytes (null for a version without
``updated_voxels``).
"""

from __future__ import annotations

import argparse
import gc
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
N_REC_FRAMES = 32
# tests/test_pipelines.py's keyframe jump and its bounds there (at its registration budgets)
JUMP_T_LIMIT_M = 0.06
JUMP_R_LIMIT_RAD = 0.08
N_OFFLINE_OUT = 12  # the offline scan: 12 sweep poses out and back, 24 frames
N_OFFLINE_CPU = 4
# Azure Kinect WFOV unbinned depth: width, height, fx, fy, cx, cy
WFOV = (1024, 1024, 504.0, 504.0, 511.5, 511.5)
# relocalization: sweep poses 0-11 tracked, 6 dark frames, the sweep resumed at
# pose 13; the first attempt that can succeed (the 4th lost frame, at
# reloc_interval=4) sees pose 15, 4 sweep steps (0.08 rad, 2.9 cm) past the
# frozen pose: inside the hint rung's basin
N_RELOC_TRACK = 12
N_RELOC_DARK = 6
RELOC_RESUME = 13
N_RELOC_RESUMED = 6
RELOC_T_LIMIT_M = 0.06  # tests/test_relocalize.py's bounds after a recovery
RELOC_R_LIMIT_RAD = 0.12
HINT_T_LIMIT_M = 0.05  # its bounds on a direct attempt
HINT_R_LIMIT_RAD = 0.1
RELOC_POSE_TOL = 1e-4  # the hint rung on the card against a CPU copy of the volume
# the fragment pipeline: sweep poses 0, 4, 8, 12; JAX's 3 cm bound on each fragment pose
FRAGMENT_POSES = (0, 4, 8, 12)
FRAGMENT_T_LIMIT_M = 0.03
# the cloud accumulator (bench.py's configuration: every frame a keyframe, 8 keyframes);
# its large-motion pair within tests/test_pipelines.py's bounds
N_CLOUD_KF = 8
COARSE_T_LIMIT_M = 0.06
COARSE_R_LIMIT_RAD = 0.10
CLOUD_POSE_TOL = 1e-4  # the accumulator on the card against a CPU copy
# the SDF splat's sums are float32 atomics in no fixed order on the card: weights
# within 1e-5 relative, tsdf and color within 1e-5 of the CPU's
SPLAT_TOL = 1e-5
# host streaming, bench.py's corridor runs: (image scale, frames, metres a frame, margin)
# into its 1,024-block pool (5 mm voxels, depth_trunc 0.7 m, a tick every 8 frames); the
# plain comparators take the same frames into a 4,096-block pool
STREAM_RUNS = ((1.0, 120, 0.045, 0.4), (0.25, 240, 0.04, 0.3))
STREAM_PLAIN_BLOCKS = 4096
N_CLI_FRAMES = 24


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


def _profiled(fn, kernel: str):
    """Run ``fn`` once under ``torch.profiler``, synchronized: (device us,
    launches) of the CUDA kernels whose name holds ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if kernel in e.key and t > 0:
            total += t
            count += e.count
    return total, count


def _device_us(fn, reps: int, kernel: str):
    """Device time per call of the CUDA kernels whose name holds ``kernel``,
    from ``torch.profiler`` over ``reps`` calls after one warm-up, and their
    launches per call; (None, 0) when the profiler sees no device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    total, count = _profiled(lambda: [fn() for _ in range(reps)], kernel)
    return (total / reps if total > 0 else None), count / reps


def _bound(n_bytes: float, flops: float):
    """(bound ms, what sets it): the larger of bytes over HBM bandwidth and
    flops over the float32 peak."""
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b1_bound_bytes(n_updated: int, n_live: int, depth, color) -> int:
    """B1's least bytes: the voxels the frame updates (by the update rule,
    saturated weights included), read and written once; the live worklist
    rows, the depth and color images and the pose read once."""
    return (n_updated * B1_BYTES_PER_UPDATED_VOXEL + n_live * 16 + depth.numel() * 4
            + color.numel() * 4 + 64)


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


def _matched_rows(vg, vc):
    """Two volumes' pool rows matched by block key: None unless both hold
    the same non-empty key set, else ``rows(field) -> (g rows, c rows)`` as
    host arrays in one key order."""
    def keyed(v):
        n = int(v.n_blocks)
        return {tuple(k): s for s, k in enumerate(v.block_coords[:n].cpu().numpy().tolist())}

    kg, kc = keyed(vg), keyed(vc)
    if kg.keys() != kc.keys() or not kg:
        return None
    keys = sorted(kg)
    return lambda f: tuple(getattr(v, f)[[k[x] for x in keys]].cpu().numpy()
                           for v, k in ((vg, kg), (vc, kc)))


def _volumes_by_key(vg, vc):
    """Two volumes' blocks matched by key: (same key set, weights equal
    fraction, max |dtsdf|, max |dcolor| where the weights agree)."""
    import numpy as np

    rows = _matched_rows(vg, vc)
    if rows is None:
        return False, 0.0, float("inf"), float("inf")
    wg, wc = rows("weight")
    agree = wg == wc
    err_t = float(np.abs(np.subtract(*rows("tsdf")))[agree].max())
    dcol = np.abs(np.subtract(*rows("color")))
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


def wfov_check(cfg, dev, gpu: str):
    """One 1024x1024 (WFOV unbinned) frame pair of the sweep through
    ``compute_odometry_fast`` (B2 on its global-memory path) against the
    plain version on the card: pose and fitness to B2's tolerances, a
    second launch equal to the bit; B2's device time beside its bound.
    Returns (failures, keys for B2's entry of the kernels line)."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
        SyntheticCamera,
        orbit_trajectory,
    )
    from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo

    intr, ocfg = Intrinsics(*WFOV), cfg.odometry
    cam = SyntheticCamera(intrinsics=intr, device=dev)
    (d0, _, i0), (d1, _, i1) = [_decode(_quantize(cam.render(T)), cfg, dev)
                                for T in orbit_trajectory(64, radius=0.35, angle_span=1.3)[:2]]
    args = (i0, d0, i1, d1, intr, ocfg)
    levels = len(ocfg.pyramid_iters)
    pyr_s, pyr_t = build_pyramid(i0, d0, levels), build_pyramid(i1, d1, levels)
    grid, band = odo.launch_grid()
    _, dims, _ = odo.pack_levels(pyr_s, pyr_t, intr, ocfg, dev)
    oversized = odo.oversized_levels(dims, grid, band)
    rk = odo.compute_odometry_fast(*args)
    rp = odo.odometry_pyramid(odo.pyramid_plain, *args)
    rk2 = odo.compute_odometry_fast(*args)
    torch.cuda.synchronize()
    err_T = float((rk.T_target_source - rp.T_target_source).abs().max())
    err_f = abs(float(rk.fitness) - float(rp.fitness))
    same = bool(torch.equal(rk.T_target_source, rk2.T_target_source))
    terms = (0.0 if ocfg.term == "depth" else 1.0, 0.0 if ocfg.term == "color" else 1.0)
    state0 = torch.zeros(odo.STATE, device=dev)
    state0[:12] = torch.eye(4, device=dev)[:3].reshape(-1)
    runner = lambda run: (lambda: run(state0.clone(), pyr_s, pyr_t, intr, ocfg, *terms))
    ms_k = _time_ms(runner(odo.pyramid_cuda), 20)
    ms_p = _time_ms(runner(odo.pyramid_plain), 2)
    us_k, per_call, ms_call = odometry_timing(odo, args, dev)
    pixels, n_src, n_valid = b2_work(pyr_s, pyr_t, intr, ocfg, terms)
    flops = pixels * B2_FLOPS_PROLOGUE + n_src * B2_FLOPS_WARP + n_valid * B2_FLOPS_VALID
    n_bytes = 4 * 4 * pixels + 64
    bound, by = _bound(n_bytes, flops)
    _log(f"B2 at 1024x1024 (WFOV unbinned): levels {oversized} over the grid's {grid * band} "
         f"shared-memory pixels, so the global-memory path ({odo.scratch_floats(dims, grid) * 4 / 1e6:.2f} "
         f"MB scratch); max |dpose| {err_T:.3g}, |dfitness| {err_f:.3g} (fitness kernel "
         f"{float(rk.fitness):.6f}, plain {float(rp.fitness):.6f}); a second launch equal to the "
         f"bit: {same}")
    _log(f"B2 at 1024x1024 per frame pair: wrapper {ms_k:.4f} ms (CUDA events), device "
         f"{_fmt_us(us_k)} per launch ({per_call:g} kernel/call, torch.profiler), plain "
         f"{ms_p:.4f} ms; compute_odometry_fast {ms_call:.4f} ms (synchronized, median of "
         f"{ODO_REPS}); bound {bound * 1e3:.3f} us ({by}: {pixels:.0f} level pixels, "
         f"{n_src:.0f} / {n_valid:.0f} source-valid / valid pixel-iterations, "
         f"{flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB)  [{gpu}]")
    failures = []
    if oversized != [0]:
        failures.append(f"the 1024x1024 pyramid's oversized levels are {oversized}, not [0]")
    if not (err_T <= B2_POSE_TOL and err_f <= B2_FITNESS_TOL and same and float(rk.fitness) > 0.5):
        failures.append("B2 at 1024x1024 disagrees with its plain version or with itself")
    return failures, dict(wfov_max_abs_err=max(err_T, err_f), wfov_ms=ms_k, wfov_plain_ms=ms_p,
                          wfov_device_us=us_k, wfov_bound_ms=bound, wfov_bound_by=by)


def recorder_phase(intr, cfg, cam, raw, gt, dev, gpu: str):
    """The recorder, ``Recorder(..., device=dev)``, over ``raw`` at ``cfg``
    (a keyframe every ``cfg.keyframe_interval`` frames), the launch counters
    zeroed just before and read just after: B1 once a recorded frame, B2
    never, every keyframe accepted by colored ICP, no overflow, the
    keyframes' ATE against ``gt``; the save read back; the ms of one
    keyframe step, its colored ICP and one interval step. Then the keyframe
    jump of tests/test_pipelines.py (a keyframe every frame) must be caught
    by the deferred check and rebased through the fallback ladder. Returns
    (failures, launch counts)."""
    import dataclasses

    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.config import RegistrationConfig
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.core.device import upload
    from azurekinect3dreconstruction_tpu_torch.core.types import decode_raw_frame
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory
    from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.recorder import Recorder
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import TargetMaps, icp_projective
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate
    from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver, read_geometry

    failures = []
    n = len(raw)
    ms_since = lambda t0: (time.perf_counter() - t0) * 1e3
    tmp = tempfile.TemporaryDirectory()
    rec = Recorder(intr, cfg, device=dev, output_dir=tmp.name)
    rec.toggle_recording()
    _sync(dev)
    build.launches.clear()
    t0 = time.perf_counter()
    for d, c in raw:
        rec.process_frame(d, c)
    traj = rec.trajectory  # runs the deferred check of the last keyframe, then syncs
    loop_ms = ms_since(t0) / n
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    ev = rec.telemetry.counters
    kf = [i for i in range(n) if i % cfg.keyframe_interval == 0]
    gt_np = [g.cpu().numpy().astype(np.float64) for g in gt]
    # in the first camera's frame, as both start there (no alignment)
    a_kf = ate([traj[1 + i] for i in kf], [gt_np[i] for i in kf], align=False)
    a_all = ate(traj[1:], gt_np, align=False)
    overflow = bool(rec.volume.overflow)
    _log(f"recorder launches: {json.dumps(counts)} over {n} recorded frames  [{gpu}]")
    _log(f"recorder over {n} frames, a keyframe every {cfg.keyframe_interval}: keyframes' ATE "
         f"rmse {a_kf['rmse'] * 1e3:.3f} mm (max {a_kf['max'] * 1e3:.3f} mm) over {len(kf)} "
         f"keyframes; all frames (interval frames hold the last keyframe's pose) "
         f"{a_all['rmse'] * 1e3:.3f} mm; events {json.dumps(ev)}, overflow {overflow}, "
         f"n_blocks {int(rec.volume.n_blocks)}; {loop_ms:.3f} ms/frame (host clock, one sync "
         f"after {n}); host ms a step (telemetry): keyframe "
         f"{rec.telemetry.mean_time_ms('keyframe'):.3f}, interval "
         f"{rec.telemetry.mean_time_ms('integrate'):.3f}  [{gpu}]")
    if counts[tk.KERNEL] != n or counts[odo.KERNEL] != 0:
        failures.append(f"recorder launches {counts}: B1 not once a recorded frame or B2 run")
    if not a_kf["rmse"] <= ATE_LIMIT_M:
        failures.append(f"recorder keyframe ATE {a_kf['rmse']:.4f} m over {ATE_LIMIT_M} m")
    if ev.get("colored_icp_reject", 0) or ev.get("colored_icp_ok", 0) != len(kf) - 1:
        failures.append(f"recorder keyframes not all accepted by colored ICP: {ev}")
    if overflow:
        failures.append("volume overflow in the recorder")

    t0 = time.perf_counter()
    paths = rec.save_model()
    save_ms = ms_since(t0)
    v, _, f = read_geometry(paths["mesh"])
    pts, cols, _ = read_geometry(paths["pointcloud"])
    saved = np.stack(ResultSaver.load_trajectory(paths["trajectory"]))
    ok_save = (f is not None and len(f) > 10000 and np.isfinite(v).all() and f.max() < len(v)
               and len(pts) > 10000 and cols is not None and np.isfinite(pts).all()
               and saved.shape == (n + 1, 4, 4) and np.allclose(saved, np.stack(traj), atol=1e-6))
    _log(f"recorder save: mesh {len(v)} vertices / {0 if f is None else len(f)} triangles, "
         f"cloud {len(pts)} points, trajectory {saved.shape[0]} poses read back; save_model "
         f"{save_ms:.1f} ms (host)  [{gpu}]")
    if not ok_save:
        failures.append("the recorder's save did not read back non-empty, finite and whole")

    # the steps of the last frame, on the recorder's volume (synchronized)
    cc = cfg.camera
    scal = (1.0 / cc.depth_scale, cc.depth_min, cc.depth_trunc)
    rawd = (upload(raw[-1][0], dev), upload(raw[-1][1], dev))
    d, _, inten = decode_raw_frame(*rawd, *scal)
    src = backproject_depth(d, rec.rays)[::4, ::4].reshape(-1, 3)
    reg = cfg.registration
    maps = TargetMaps(*rec._maps)
    phases = {
        "keyframe step": lambda: rec._kf_step(rec.volume, rec._T, rec._W_prev_kf, *rec._maps,
                                              *rawd, rec.rays, *scal),
        "colored ICP of the keyframe step (eager)": lambda: icp_projective(
            src, src[:, 2] > 0, maps, intr, init=torch.eye(4, device=dev),
            max_iters=reg.colored_icp_max_iters, dist_thr=reg.icp_distance_threshold,
            lambda_geometric=reg.colored_icp_lambda_geometric, colored=True,
            src_intensity=inten[::4, ::4].reshape(-1)),
        "interval step": lambda: rec._int_step(rec.volume, rec._T, *rawd, rec.rays, *scal),
    }
    times = {k: round(_median_ms(fn, dev), 4) for k, fn in phases.items()}
    _log(f"recorder step ms (synchronized after each, median of 5; {reg.colored_icp_max_iters} "
         f"colored ICP iterations): {json.dumps(times)}  [{gpu}]")
    del rec

    # the jump: frames 0-2 of an 8-pose orbit, then frame 7, at the test's
    # registration budgets (30 colored ICP iterations, which the jump defeats)
    JUMP_REG = RegistrationConfig(ransac_hypotheses=1024, icp_max_iters=20,
                                  colored_icp_max_iters=30)
    orbit = orbit_trajectory(8, radius=0.45, angle_span=1.3, height_wobble=0.0)
    jump = orbit[:3] + [orbit[7]]
    rj = Recorder(intr, dataclasses.replace(cfg, keyframe_interval=1, registration=JUMP_REG),
                  device=dev, output_dir=tmp.name)
    rj.toggle_recording()
    for T in jump:
        rj.process_frame(*_quantize(cam.render(T)))
    deferred = len(rj._pending) > 0
    rj.save_model()
    evj = rj.telemetry.counters
    err = se3.se3_log(torch.as_tensor(np.linalg.inv(np.linalg.inv(jump[0]) @ jump[-1])
                                      @ rj.T_world_cam)).numpy()
    et, er = float(np.linalg.norm(err[:3])), float(np.linalg.norm(err[3:]))
    _log(f"recorder jump (orbit[:3] + [orbit[7]]): rejection pending until the check {deferred}; "
         f"events {json.dumps(evj)}; rebased pose off by {et * 1e3:.3f} mm / {er * 1e3:.3f} mrad; "
         f"fallback ladder {rj.telemetry.mean_time_ms('fallback'):.1f} ms (host clock)  [{gpu}]")
    if not (evj.get("colored_icp_reject", 0) >= 1 and evj.get("fallback_rebase", 0) >= 1
            and et < JUMP_T_LIMIT_M and er < JUMP_R_LIMIT_RAD):
        failures.append(f"the recorder's jump was not rebased through the ladder: {evj}, "
                        f"{et:.4f} m / {er:.4f} rad")
    del rj
    tmp.cleanup()
    return failures, counts


def offline_phase(intr, cfg, cam, poses, dev, gpu: str, cpu_frames: int = N_OFFLINE_CPU):
    """The offline bundle, ``OfflineBundle(..., device=dev)``, over ``poses``
    out and back, then ``finalize``, the launch counters zeroed just before
    the first frame and read just after finalize: B1 once a logged frame,
    all in the reintegration, B2 never (the bundle tracks with the plain
    odometry, as the JAX package does); at least one loop closure; the
    optimized ATE <= the raw odometry chain's; no overflow; the mesh read
    back. Then the first ``cpu_frames`` logged frames reintegrated at their
    optimized poses on the card and on the CPU, by block key. Returns
    (failures, launch counts)."""
    import itertools

    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu_torch.core.device import upload
    from azurekinect3dreconstruction_tpu_torch.io.replay import NpzReplaySource
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        make_raw_batch_fn,
    )
    from azurekinect3dreconstruction_tpu_torch.pipelines.offline_bundle import OfflineBundle
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate
    from azurekinect3dreconstruction_tpu_torch.viz.savers import read_geometry

    failures = []
    seq = list(poses) + list(poses)[::-1]
    raw = [_quantize(cam.render(T)) for T in seq]
    gt = [np.linalg.inv(seq[0]) @ T for T in seq]
    ms_since = lambda t0: (time.perf_counter() - t0) * 1e3
    tmp = tempfile.TemporaryDirectory()
    ob = OfflineBundle(intr, cfg, device=dev, output_dir=tmp.name)
    _sync(dev)
    build.launches.clear()
    frame_ms = []
    for d, c in raw:
        t0 = time.perf_counter()
        ob.process_frame(d, c)
        _sync(dev)
        frame_ms.append(ms_since(t0))
    tracked_b1 = build.launches[tk.KERNEL]
    t0 = time.perf_counter()
    try:
        ob.finalize()
    except RuntimeError as e:
        failures.append(f"offline finalize: {e}")
    finalize_ms = ms_since(t0)
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    chain = [np.eye(4)]
    for e in ob.graph.edges:
        if not e.uncertain and e.target == e.source + 1:
            chain.append(chain[-1] @ e.transformation)
    a_raw = ate(chain, gt, align=False)
    a_opt = ate(ob.graph.nodes, gt, align=False)
    ev = ob.telemetry.counters
    loops = [(e.source, e.target) for e in ob.graph.edges if e.uncertain]
    overflow = ob.volume is None or bool(ob.volume.overflow)
    v, _, f = read_geometry(os.path.join(tmp.name, "latest_optimized_mesh.ply"))
    stats = {k: round(x, 4) for k, x in ob.last_finalize_stats.items()}
    steady = sorted(frame_ms[1:])
    _log(f"offline launches: {json.dumps(counts)} over {len(raw)} logged frames, "
         f"{tracked_b1} of B1 while tracking  [{gpu}]")
    _log(f"offline bundle over {len(raw)} frames out and back: loop closures kept {loops}, "
         f"events {json.dumps(ev)}; ATE rmse raw chain {a_raw['rmse'] * 1e3:.3f} mm (final drift "
         f"{a_raw['final_drift'] * 1e3:.3f} mm), optimized {a_opt['rmse'] * 1e3:.3f} mm (final "
         f"drift {a_opt['final_drift'] * 1e3:.3f} mm); overflow {overflow}; mesh "
         f"{0 if f is None else len(f)} triangles read back  [{gpu}]")
    _log(f"offline ms: process_frame (host clock, synchronized per frame) median "
         f"{steady[len(steady) // 2]:.3f} (min {steady[0]:.3f}, max {steady[-1]:.3f}); finalize "
         f"{finalize_ms:.1f}; last_finalize_stats (s) {json.dumps(stats)}  [{gpu}]")
    if counts[tk.KERNEL] != len(raw) or tracked_b1 != 0 or counts[odo.KERNEL] != 0:
        failures.append(f"offline launches {counts} ({tracked_b1} while tracking): B1 not once a "
                        f"logged frame in the reintegration, or B2 run")
    if ev.get("loop_closures", 0) < 1:
        failures.append("the offline bundle closed no loop")
    if not a_opt["rmse"] <= a_raw["rmse"]:
        failures.append(f"optimized ATE {a_opt['rmse']:.5f} m over the raw chain's "
                        f"{a_raw['rmse']:.5f} m")
    if overflow:
        failures.append("volume overflow in the offline reintegration")
    if not (f is not None and len(f) > 10000 and np.isfinite(v).all() and f.max() < len(v)):
        failures.append("the offline mesh did not read back non-empty and finite")

    # the first logged frames reintegrated on the card and on the CPU
    ds, cs = zip(*itertools.islice(NpzReplaySource(ob.frames_dir).frames(), cpu_frames))
    Ts = np.stack(ob.graph.nodes[:cpu_frames]).astype(np.float32)
    cc = cfg.camera
    scal = (1.0 / cc.depth_scale, cc.depth_min, cc.depth_trunc)
    del ob
    vols = []
    t0 = time.perf_counter()
    for device in (dev, torch.device("cpu")):
        vols.append(make_raw_batch_fn(intr, cfg.tsdf)(
            tsdf.create(cfg.tsdf, device), upload(np.stack(ds), device),
            upload(np.stack(cs), device), upload(Ts, device), pixel_rays(intr, device), *scal))
    same_keys, frac, err_t, err_c = _volumes_by_key(*vols)
    _log(f"offline reintegration card vs CPU over {cpu_frames} frames: same block keys "
         f"{same_keys} ({int(vols[0].n_blocks)} blocks), weights equal on {frac:.6%}, max |dtsdf| "
         f"{err_t:.3g}, max |dcolor| {err_c:.3g} where they agree; overflow "
         f"{[bool(x.overflow) for x in vols]} ({ms_since(t0) / 1e3:.1f} s)")
    if not (same_keys and frac >= B1_WEIGHT_EQUAL_MIN and err_t <= B1_VALUE_TOL
            and err_c <= B1_VALUE_TOL) or any(bool(x.overflow) for x in vols):
        failures.append("the offline reintegration on the card differs from the CPU's")
    del vols
    tmp.cleanup()
    return failures, counts


def reloc_phase(intr, cfg, cam, poses, raw_healthy, dev, gpu: str, cpu_check: bool = True):
    """Relocalization, ``MonoOdometryTSDF(..., relocalize=True,
    reloc_window=2, reloc_interval=4)``: the first ``N_RELOC_TRACK`` sweep
    poses, ``N_RELOC_DARK`` dark frames, then the sweep resumed at pose
    ``RELOC_RESUME``, the launch counters zeroed just before and read just
    after: the loss declared once, nothing fused from the first dark frame
    until the recovery, the final pose within the JAX test's bounds, B2 once
    a tracked frame, B1 once a tracked frame plus the first frame plus each
    recovery, no overflow. Then a standalone ``Relocalizer`` on the phase's
    volume from a neighbor hint (rung 0 must recover) and from a garbage
    hint (None or a correct pose), the hint rung against a CPU copy of the
    volume (``cpu_check``), the attempts' ms, the 8,192-hypothesis RANSAC's
    ms and memory, the warmup's s, and healthy ms/frame over
    ``raw_healthy`` with and without ``relocalize``. Returns (failures,
    launch counts)."""
    import dataclasses

    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.ops.neighbors import voxel_downsample_arrays
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )
    from azurekinect3dreconstruction_tpu_torch.tracking.ransac import global_registration
    from azurekinect3dreconstruction_tpu_torch.tracking.relocalize import Relocalizer
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc

    failures = []
    ms_since = lambda t0: (time.perf_counter() - t0) * 1e3
    world = [np.linalg.inv(poses[0]) @ T for T in poses]

    def err(T, k):
        xi = se3.se3_log(torch.as_tensor(np.linalg.inv(world[k]) @ np.asarray(T))).numpy()
        return float(np.linalg.norm(xi[:3])), float(np.linalg.norm(xi[3:]))

    H, W = intr.height, intr.width
    dark = (np.zeros((H, W), np.uint16), np.zeros((H, W, 3), np.uint8))
    resumed = list(range(RELOC_RESUME, RELOC_RESUME + N_RELOC_RESUMED))
    seq = ([_quantize(cam.render(poses[i])) for i in range(N_RELOC_TRACK)]
           + [dark] * N_RELOC_DARK + [_quantize(cam.render(poses[i])) for i in resumed])
    kw = dict(device=dev, worklist_size=2048)
    pipe = MonoOdometryTSDF(intr, cfg, relocalize=True, reloc_window=2, reloc_interval=4, **kw)
    _sync(dev)
    build.launches.clear()
    n_blocks, frame_ms = [], []
    lost_at = recovered_at = None
    stepped = 0  # frames through the step (B2 once each)
    for j, (d, c) in enumerate(seq):
        stepped += j > 0 and not pipe.lost
        t0 = time.perf_counter()
        pipe.process_frame(d, c)
        _sync(dev)
        frame_ms.append(ms_since(t0))
        if pipe.lost and lost_at is None:
            lost_at = j
        if lost_at is not None and not pipe.lost and recovered_at is None:
            recovered_at = j
        n_blocks.append(int(pipe.volume.n_blocks))
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    ev = pipe.counts
    rel = pipe._relocalizer
    overflow = bool(pipe.volume.overflow)
    te, re_ = err(pipe.T_world_cam, resumed[-1])
    frozen = (recovered_at is not None
              and len(set(n_blocks[N_RELOC_TRACK - 1:recovered_at])) == 1)
    want_b1 = stepped + 1 + ev.get("relocalized", 0)
    _log(f"relocalization launches: {json.dumps(counts)} over {len(seq)} frames ({stepped} "
         f"through the step)  [{gpu}]")
    rec_pose = (None if recovered_at is None
                else resumed[recovered_at - N_RELOC_TRACK - N_RELOC_DARK])
    rung = "0 (hint)" if rel is not None and rel.n_hint_success else "global"
    rec_ms = "n/a" if recovered_at is None else f"{frame_ms[recovered_at]:.1f}"
    first_lost_ms = ("n/a" if lost_at is None or lost_at + 1 >= len(seq)
                     else f"{frame_ms[lost_at + 1]:.1f}")
    _log(f"relocalization: tracked poses 0-{N_RELOC_TRACK - 1}, {N_RELOC_DARK} dark frames, "
         f"resumed at pose {RELOC_RESUME} (the chain froze at pose {N_RELOC_TRACK - 1}); loss "
         f"declared at frame {lost_at}, recovered at frame {recovered_at} (pose {rec_pose}) by "
         f"rung {rung}; events {json.dumps(ev)}; n_blocks {n_blocks[N_RELOC_TRACK - 1]}, frozen "
         f"until the recovery {frozen}, {n_blocks[-1]} at the end; final pose off by "
         f"{te * 1e3:.3f} mm / {re_ * 1e3:.3f} mrad; overflow {overflow}; ms (host clock, "
         f"synchronized): recovery frame {rec_ms}, first lost frame (an empty-frame attempt) "
         f"{first_lost_ms}  [{gpu}]")
    if not (ev.get("tracking_lost", 0) == 1 and ev.get("relocalized", 0) == 1 and frozen):
        failures.append(f"relocalization: loss or recovery not as expected ({ev}, n_blocks "
                        f"{n_blocks})")
    if not (te <= RELOC_T_LIMIT_M and re_ <= RELOC_R_LIMIT_RAD):
        failures.append(f"relocalization: final pose off by {te:.4f} m / {re_:.4f} rad")
    if counts[odo.KERNEL] != stepped or counts[tk.KERNEL] != want_b1:
        failures.append(f"relocalization launches {counts}: B2 not once a tracked frame "
                        f"({stepped}) or B1 not {want_b1}")
    if overflow:
        failures.append("volume overflow in the relocalization phase")

    # -- a standalone relocalizer on the phase's volume -----------------------------
    vol = pipe.volume
    probe = resumed[-1] + 2  # a pose no frame fused
    d_probe = _decode(_quantize(cam.render(poses[probe])), cfg, dev)[0]
    hint = world[resumed[-1]]
    bad = hint.copy()
    bad[:3, 3] += [0.9, -0.6, 0.8]
    reloc = Relocalizer(intr, cfg, device=dev)
    # what the model sample covers: the surface sampler emits at most 4x the
    # budget, in pool order, before it thins
    E = mc.snap_extract_blocks(int(vol.n_blocks), vol.tsdf.shape[0])
    _, total = mc.exact_budgets(mc._survey(vol, cfg.tsdf, extract_blocks=E, colors=False), cfg.tsdf)
    _, mm, m_ovf = mc.extract_surface_samples(vol, cfg.tsdf, reloc.model_points)
    ms_model = _median_ms(lambda: mc.extract_surface_samples(vol, cfg.tsdf, reloc.model_points),
                          dev)
    _log(f"relocalizer model sample: {int(mm.sum())} points from the first "
         f"{min(total, 4 * (reloc.model_points // 3))} of the volume's {total} triangles in "
         f"pool order, overflow {bool(m_ovf)}; extract_surface_samples {ms_model:.3f} ms "
         f"(synchronized, median of 5)  [{gpu}]")

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, ms_since(t0)

    T_h, ms_cold = timed(lambda: reloc.attempt(vol, d_probe, T_hint=hint))
    rung0 = reloc.n_hint_success == 1
    _, ms_cached = timed(lambda: reloc.attempt(vol, d_probe, T_hint=hint))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    T_g, ms_garbage = timed(lambda: reloc.attempt(vol, d_probe, T_hint=bad))
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    garbage_rung0 = reloc.n_hint_success != 2
    eh = err(T_h, probe) if T_h is not None else (float("inf"),) * 2
    eg = err(T_g, probe) if T_g is not None else None
    garbage = ("None (" + reloc.last_reject + ")" if eg is None
               else f"a pose off by {eg[0] * 1e3:.3f} mm / {eg[1] * 1e3:.3f} mrad")
    _log(f"relocalizer from a neighbor hint (pose {resumed[-1]} for pose {probe}): "
         f"{'recovered' if T_h is not None else 'rejected'} by rung "
         f"{'0' if rung0 else 'global'}, off by {eh[0] * 1e3:.3f} mm / {eh[1] * 1e3:.3f} mrad; "
         f"attempt {ms_cold:.1f} ms with the model extracted, {ms_cached:.1f} ms from the cached "
         f"model; from a garbage hint: rung 0 accepted {garbage_rung0}, {garbage}, "
         f"{ms_garbage:.1f} ms (model, rung 0, descriptors, {reloc.restarts} RANSAC restarts, "
         f"refine), peak device memory {peak:.2f} GiB (host clock, synchronized)  [{gpu}]")
    if not (T_h is not None and rung0 and eh[0] < HINT_T_LIMIT_M and eh[1] < HINT_R_LIMIT_RAD):
        failures.append(f"the relocalizer did not recover by rung 0 from a neighbor hint "
                        f"({reloc.last_reject}, {eh})")
    if garbage_rung0 or (eg is not None and not (eg[0] < HINT_T_LIMIT_M
                                                 and eg[1] < HINT_R_LIMIT_RAD)):
        failures.append(f"the relocalizer returned a wrong pose from a garbage hint ({eg})")

    # one 8,192-hypothesis RANSAC call on the attempt's own clouds and features
    _, _, _, _, m_feats = reloc._model_cache
    vox, (m_ds, m_dm, m_f) = max(m_feats.items())
    if m_f is not None:
        src = backproject_depth(d_probe, reloc.rays)[::reloc.stride, ::reloc.stride].reshape(-1, 3)
        s_ds, s_dm, _, _ = voxel_downsample_arrays(src, src[:, 2] > 0, vox, reloc.feature_points)
        s_f = reloc._enrich(s_ds, s_dm, np.zeros(3), vox)
        reg = dataclasses.replace(cfg.registration, ransac_hypotheses=max(
            8192, cfg.registration.ransac_hypotheses))
        gen = torch.Generator(dev).manual_seed(1)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ms_ransac = _median_ms(lambda: global_registration(
            s_ds, s_f, s_dm, m_ds, m_f, m_dm, reg, distance_threshold=max(0.04, 2.5 * vox),
            generator=gen), dev, 3)
        peak_r = (torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda"
                  else float("nan"))
        _log(f"global_registration ({reg.ransac_hypotheses} hypotheses, {int(s_dm.sum())} / "
             f"{int(m_dm.sum())} frame / model points at a {vox * 1e3:.1f} mm voxel): "
             f"{ms_ransac:.1f} ms (synchronized, median of 3), peak device memory "
             f"{peak_r:.2f} GiB  [{gpu}]")

    if cpu_check:
        host = vol._replace(**{k: t.cpu() for k, t in vol._asdict().items()})
        t0 = time.perf_counter()
        rc = Relocalizer(intr, cfg, device="cpu")
        T_c = rc.attempt(host, d_probe.cpu(), T_hint=hint)
        d_pose = (float("inf") if T_c is None or T_h is None
                  else float(np.abs(T_c - T_h).max()))
        _log(f"hint rung on the card against a CPU copy of the volume: CPU "
             f"{'rung 0' if rc.n_hint_success else 'not rung 0: ' + rc.last_reject}, max |dpose| "
             f"{d_pose:.3g} ({ms_since(t0) / 1e3:.1f} s)")
        if not (rc.n_hint_success == 1 and d_pose <= RELOC_POSE_TOL):
            failures.append(f"the hint rung on the card differs from the CPU copy's ({d_pose})")
        del host

    t0 = time.perf_counter()
    warm = Relocalizer(intr, cfg, device=dev).warmup()
    _log(f"Relocalizer.warmup (scratch volume; both rungs once): {warm:.2f} s, "
         f"{ms_since(t0) / 1e3:.2f} s with construction  [{gpu}]")
    del pipe, vol

    # healthy tracking with and without the latch and its checks, in turns
    loops = {False: [], True: []}
    for on in (False, True, True, False):
        p = MonoOdometryTSDF(intr, cfg, relocalize=on, **kw)
        _sync(dev)
        t0 = time.perf_counter()
        for d, c in raw_healthy:
            p.process_frame(d, c)
        _sync(dev)
        loops[on].append(ms_since(t0) / len(raw_healthy))
        if on and (p.lost or p.counts):
            failures.append(f"healthy tracking with relocalize took events {p.counts}")
        del p
    _log(f"healthy ms/frame over {len(raw_healthy)} frames (host clock, one sync at the end; "
         f"off, on, on, off): relocalize=False {loops[False][0]:.3f}, {loops[False][1]:.3f}; "
         f"relocalize=True (a check every 8 frames) {loops[True][0]:.3f}, "
         f"{loops[True][1]:.3f}  [{gpu}]")
    return failures, counts


def incremental_phase(intr, cfg, raw, dev, gpu: str):
    """Incremental extraction over the live loop: ``IncrementalExtractor``
    ``update`` after every frame of ``raw``, then once after a frame with
    only the central quarter of its depth, which must take the compact path
    with 0 < touched < n_blocks. Every assembled soup must equal
    ``extract_mesh``'s: the same count and the same centroid set at 5
    decimals. Prints the median ms per stage, the pull bytes and the full
    ``extract_mesh`` ms of the same volume. Returns the failures."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
    from azurekinect3dreconstruction_tpu_torch.tsdf.incremental import IncrementalExtractor

    failures = []
    pipe = MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048)
    inc = IncrementalExtractor(cfg.tsdf)

    def centroids(v):
        c = np.round(v.reshape(-1, 3, 3).mean(1), 5)
        return c[np.lexsort(c.T)]

    def check(mesh, what):
        full = pipe.extract_mesh().compact()
        same = (mesh.triangles.shape[0] == full.triangles.shape[0]
                and np.array_equal(centroids(mesh.vertices), centroids(full.vertices)))
        if not same:
            failures.append(f"incremental soup differs from extract_mesh at {what} "
                            f"({mesh.triangles.shape[0]} / {full.triangles.shape[0]} triangles)")
        return full.triangles.shape[0]

    stages, pulls, modes, touched = {}, [], [], []
    for j, (d, c) in enumerate(raw):
        pipe.process_frame(d, c)
        _sync(dev)
        mesh = inc.update(pipe.volume)
        for k, v in inc.timings.items():
            stages.setdefault(k, []).append(v * 1e3)
        pulls.append(inc.last_pull_bytes)
        modes.append(inc.last_mode)
        touched.append(inc.last_touched)
        nt = check(mesh, f"frame {j}")
    # a frame with only the central quarter of its depth: a few blocks change
    d, col, _ = _decode(raw[-1], cfg, dev)
    crop = torch.zeros_like(d)
    H, W = d.shape
    crop[3 * H // 8: 5 * H // 8, 3 * W // 8: 5 * W // 8] = d[3 * H // 8: 5 * H // 8,
                                                              3 * W // 8: 5 * W // 8]
    pipe.volume = tsdf.integrate_frame(pipe.volume, crop, col, pipe.rays, pipe._T, intr, cfg.tsdf)
    _sync(dev)
    mesh = inc.update(pipe.volume)
    nb = int(pipe.volume.n_blocks)
    crop_stages = {k: round(v * 1e3, 3) for k, v in inc.timings.items()}
    crop_mode, crop_touched, crop_pull = inc.last_mode, inc.last_touched, inc.last_pull_bytes
    nt_crop = check(mesh, "the cropped frame")
    full_ms = _median_ms(pipe.extract_mesh, dev)
    med = {k: round(sorted(v)[len(v) // 2], 3) for k, v in stages.items()}
    _log(f"incremental over {len(raw)} frames: modes {''.join(m[0] for m in modes)} "
         f"(f full, c compact, n none), blocks re-extracted {touched}, pull MB "
         f"{[round(p / 1e6, 2) for p in pulls]}; median stage ms (host clock; the checksum and "
         f"extract_pull stages end in a device read) {json.dumps(med)}; {nt} triangles at the "
         f"last frame  [{gpu}]")
    _log(f"incremental after a cropped-depth frame: mode {crop_mode}, {crop_touched} of {nb} "
         f"blocks re-extracted, pull {crop_pull / 1e6:.3f} MB, stage ms {json.dumps(crop_stages)} "
         f"(sum {sum(crop_stages.values()):.3f}); {nt_crop} triangles; full extract_mesh of the "
         f"same volume {full_ms:.3f} ms (CUDA events, median of 5, host copy included)  [{gpu}]")
    if not (crop_mode == "compact" and 0 < crop_touched < nb):
        failures.append(f"the cropped frame did not take the compact path ({crop_mode}, "
                        f"{crop_touched} of {nb})")
    if modes[0] != "full":
        failures.append(f"the first incremental update was {modes[0]}, not full")
    return failures


def fragments_phase(intr, cfg, cam, dev, gpu: str, cpu_check: bool = True):
    """The fragment pipeline, ``FragmentPipeline(..., device=dev)``, on
    ``FRAGMENT_POSES`` of the bench sweep: capture, then make fragments
    (each meshed from its own whole-pool volume at 10 mm), register and
    integrate the scene, each stage synchronized and timed, the launch
    counters zeroed just before and read just after: B1 exactly twice a
    captured frame, B2 never; every fragment pose within 3 cm of the true
    relative motion; a scene mesh; no overflow; peak device memory. Then
    the scene volume against a CPU copy integrated at the card's poses, by
    block key with B1's tolerances. Returns (failures, launch counts)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.fragments import FragmentPipeline
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

    failures = []
    sweep = orbit_trajectory(64, radius=0.35, angle_span=1.3)
    poses = [sweep[i] for i in FRAGMENT_POSES]
    raw = [_quantize(cam.render(T)) for T in poses]
    pipe = FragmentPipeline(intr, cfg, device=dev)
    for d, c in raw:
        pipe.capture(d, c)
    _sync(dev)
    gc.collect()  # earlier phases' dropped volumes
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    build.launches.clear()
    stage_ms = {}
    for name, stage in (("make", pipe.make_fragments), ("register", pipe.register_fragments),
                        ("integrate", pipe.integrate_scene)):
        t0 = time.perf_counter()
        out = stage()
        _sync(dev)
        stage_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if dev.type == "cuda" else 0.0
    errs = []
    for frag, T in zip(pipe.fragments, poses):
        e = se3.se3_log(torch.as_tensor(np.linalg.inv(np.linalg.inv(poses[0]) @ T) @ frag.pose))
        errs.append((float(e[:3].norm()), float(e[3:].norm())))
    overflow = bool(pipe.volume.overflow)
    _log(f"fragments launches: {json.dumps(counts)} over {len(raw)} captured frames  [{gpu}]")
    _log(f"fragments over sweep poses {list(FRAGMENT_POSES)}: stage ms (host clock, synchronized "
         f"after each) {json.dumps(stage_ms)}; fragment pose error vs the true relative motion "
         f"mm/mrad {[(round(t * 1e3, 3), round(r * 1e3, 3)) for t, r in errs]}; scene mesh "
         f"{out.triangles.shape[0]} triangles, n_blocks {int(pipe.volume.n_blocks)}, overflow "
         f"{overflow}; peak device memory {peak:.3f} GiB above the {base / 2**30:.3f} GiB held "
         f"before the first stage  [{gpu}]")
    if counts[tk.KERNEL] != 2 * len(raw) or counts[odo.KERNEL] != 0:
        failures.append(f"fragments launches {counts}: B1 not twice a captured frame or B2 run")
    if not all(t < FRAGMENT_T_LIMIT_M for t, _ in errs):
        failures.append(f"a fragment pose is {max(t for t, _ in errs):.4f} m off")
    if out.triangles.shape[0] < 10000 or overflow:
        failures.append("the fragment scene mesh is empty or the volume overflowed")

    if cpu_check:
        cpu = torch.device("cpu")
        host = FragmentPipeline(intr, cfg, device=cpu, mesh_fragments=False)
        for d, c in raw:
            host.capture(d, c)
        t0 = time.perf_counter()
        vol = tsdf.create(cfg.tsdf, cpu)
        for f, frag in zip(host.captured, pipe.fragments):
            vol = tsdf.integrate_frame(vol, f.depth, f.color, host.rays,
                                       torch.as_tensor(frag.pose, dtype=torch.float32), intr,
                                       cfg.tsdf)
        same_keys, frac, err_t, err_c = _volumes_by_key(pipe.volume, vol)
        _log(f"fragments scene card vs CPU at the card's poses: same block keys {same_keys} "
             f"({int(vol.n_blocks)} blocks), weights equal on {frac:.6%}, max |dtsdf| "
             f"{err_t:.3g}, max |dcolor| {err_c:.3g} where they agree "
             f"({time.perf_counter() - t0:.1f} s)")
        if not (same_keys and frac >= B1_WEIGHT_EQUAL_MIN and err_t <= B1_VALUE_TOL
                and err_c <= B1_VALUE_TOL):
            failures.append("the fragment scene volume on the card differs from the CPU's")
        del vol
    del pipe
    return failures, counts


def _splat_by_key(vg, vc):
    """Two splat volumes' blocks matched by key: (same key set, max relative
    weight difference, max |dtsdf|, max |dcolor|)."""
    import numpy as np

    rows = _matched_rows(vg, vc)
    if rows is None:
        return False, float("inf"), float("inf"), float("inf")
    wg, wc = rows("weight")
    rel_w = float((np.abs(wg - wc) / np.maximum(wc, 1e-30))[wc > 0].max())
    err = lambda f: float(np.abs(np.subtract(*rows(f))).max())
    return True, rel_w, err("tsdf"), err("color")


def cloud_phase(intr, cfg, cam, raw, gt, dev, gpu: str, cpu_check: bool = True):
    """The point-cloud accumulator, ``CloudAccumulator(..., device=dev)``,
    every frame a keyframe, over the first ``N_CLOUD_KF`` frames of ``raw``:
    keyframes/s with one sync at the end, the launch counters zeroed just
    before and read just after (B1 and B2 never); then again synchronized
    after each keyframe (median ms); the chain's ATE against ``gt``, the
    coarse and rejected keyframes; the large-motion pair of
    tests/test_pipelines.py with ``coarse=True`` (within 6 cm / 0.10 rad, the
    coarse seed wins); ``save_model()`` read back; ``mesh_with_fallback`` on
    the model cloud (the SDF mesher: no Open3D, over 60k points) with its
    ms; the model's splat against a CPU copy by key (``SPLAT_TOL``); the
    first 2 keyframes' poses against a CPU accumulator. Returns (failures,
    launch counts)."""
    import dataclasses

    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory
    from azurekinect3dreconstruction_tpu_torch.meshing.poisson import (
        BALL_PIVOT_MAX_POINTS,
        mesh_with_fallback,
    )
    from azurekinect3dreconstruction_tpu_torch.meshing.sdf_mesh import splat_cloud
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.cloud_accumulator import CloudAccumulator
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import TargetMaps, icp_point_to_plane
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate
    from azurekinect3dreconstruction_tpu_torch.viz.savers import read_geometry

    failures = []
    ms_since = lambda t0: (time.perf_counter() - t0) * 1e3
    tmp = tempfile.TemporaryDirectory()
    ca_cfg = dataclasses.replace(cfg, keyframe_interval=1)
    frames = raw[:N_CLOUD_KF]
    acc = lambda device=dev, **kw: CloudAccumulator(intr, ca_cfg, device=device,
                                                    output_dir=tmp.name, **kw)
    warm = acc()
    for d, c in frames[:2]:  # first-call set-up stays out of the timing
        warm.process_frame(d, c)
    del warm
    ca = acc()
    _sync(dev)
    build.launches.clear()
    t0 = time.perf_counter()
    traj = []
    for d, c in frames:
        ca.process_frame(d, c)
        traj.append(ca.T_world_cam.copy())
    _sync(dev)
    kf_fps = len(frames) / (ms_since(t0) / 1e3)
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    per_kf = []
    ca2 = acc()
    for d, c in frames:
        t0 = time.perf_counter()
        ca2.process_frame(d, c)
        _sync(dev)
        per_kf.append(ms_since(t0))
    # the stages of the last keyframe, synchronized: its projective ICP against
    # the previous keyframe's maps, and the maps it leaves for the next one
    reg = ca_cfg.registration
    dl, cl, _ = _decode(frames[-1], cfg, dev)
    flat = backproject_depth(dl, ca2.rays)[::4, ::4].reshape(-1, 3)
    maps = ca2.prev_maps
    stages = {
        f"icp_point_to_plane ({reg.icp_max_iters} iterations, eager)": lambda: (
            icp_point_to_plane(flat, flat[:, 2] > 0, maps, intr, cfg=reg)),
        "target maps": lambda: TargetMaps.from_depth(dl, ca2.rays),
    }
    stage_ms = {k: round(_median_ms(fn, dev), 3) for k, fn in stages.items()}
    del ca2
    gt_np = [g.cpu().numpy().astype(np.float64) for g in gt[:len(frames)]]
    a = ate(traj, gt_np, align=False)
    ev = ca.telemetry.counters
    n_coarse = len(ca.telemetry._timers.get("coarse", []))
    steady = sorted(per_kf[1:])
    _log(f"cloud accumulator launches: {json.dumps(counts)} over {len(frames)} keyframes  [{gpu}]")
    _log(f"cloud accumulator over {len(frames)} keyframes (every frame a keyframe): "
         f"{kf_fps:.3f} keyframes/s (host clock, one sync at the end); synchronized per keyframe "
         f"median {steady[len(steady) // 2]:.3f} ms (min {steady[0]:.3f}, max {steady[-1]:.3f}); "
         f"ATE rmse {a['rmse'] * 1e3:.3f} mm (max {a['max'] * 1e3:.3f} mm); coarse stage ran on "
         f"{n_coarse}, events {json.dumps(ev)}; model {len(ca.model_points)} points  [{gpu}]")
    _log(f"cloud accumulator keyframe stage ms (synchronized after each, median of 5): "
         f"{json.dumps(stage_ms)}  [{gpu}]")
    if counts[tk.KERNEL] or counts[odo.KERNEL]:
        failures.append(f"cloud accumulator launches {counts}: a kernel ran")
    if not a["rmse"] <= ATE_LIMIT_M or ev.get("reg_fail", 0):
        failures.append(f"cloud accumulator ATE {a['rmse']:.4f} m or rejections {ev}")

    # the large-motion pair, coarse-seeded
    big = orbit_trajectory(2, radius=0.45, angle_span=1.3, height_wobble=0.0)
    cb = acc(coarse=True)
    t0 = time.perf_counter()
    for T in big:
        cb.process_frame(*_quantize(cam.render(T)))
    big_ms = ms_since(t0)
    e = se3.se3_log(torch.as_tensor(np.linalg.inv(np.linalg.inv(big[0]) @ big[1])
                                    @ cb.T_world_cam))
    et, er = float(e[:3].norm()), float(e[3:].norm())
    evb = cb.telemetry.counters
    _log(f"cloud accumulator large-motion pair (orbit(2, 0.45, 1.3)): pose off by "
         f"{et * 1e3:.3f} mm / {er * 1e3:.3f} mrad, events {json.dumps(evb)}, coarse stage "
         f"{cb.telemetry.mean_time_ms('coarse'):.1f} ms, both keyframes {big_ms:.1f} ms "
         f"(host clock)  [{gpu}]")
    if not (et < COARSE_T_LIMIT_M and er < COARSE_R_LIMIT_RAD and evb.get("coarse_won", 0) == 1):
        failures.append(f"the large-motion pair was not recovered by the coarse seed: "
                        f"{et:.4f} m / {er:.4f} rad, {evb}")
    del cb

    # the save, read back; the model cloud meshed through the fallback chain
    t0 = time.perf_counter()
    paths = ca.save_model()
    save_ms = ms_since(t0)
    v, cols, _ = read_geometry(paths["pointcloud"])
    cloud = ca.model_cloud()
    ok_save = (len(v) == len(ca.model_points) > 10000 and np.isfinite(v).all()
               and cols is not None and cloud.normals is not None)
    t0 = time.perf_counter()
    mesh = mesh_with_fallback(cloud, voxel=0.01, device=dev)
    mesh_ms = ms_since(t0)
    rung = ("the SDF mesher" if len(cloud) > BALL_PIVOT_MAX_POINTS else "ball pivoting")
    _log(f"cloud accumulator save: {len(v)} points read back, save_model {save_ms:.1f} ms; "
         f"mesh_with_fallback (no Open3D, {len(cloud)} points: {rung}) "
         f"{mesh_ms:.1f} ms, {0 if mesh is None else mesh.triangles.shape[0]} triangles "
         f"(host clock)  [{gpu}]")
    if not ok_save:
        failures.append("the accumulator's save did not read back whole and finite")
    if mesh is None or mesh.triangles.shape[0] < 10000:
        failures.append("mesh_with_fallback gave no mesh of the model cloud")

    # the model's splat (sdf_mesh_from_cloud's configuration) on the card and on the CPU
    scfg = TSDFConfig(voxel_size=0.01, sdf_trunc=0.015, block_resolution=8, block_capacity=8192,
                      hash_capacity=32768)
    cpu = torch.device("cpu")
    vols, splat_ms, splat_peak = [], None, 0.0
    for device in ((dev, cpu) if cpu_check else (dev,)):
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
        call = lambda: splat_cloud(t(cloud.points), t(cloud.normals), t(cloud.colors),
                                   torch.ones(len(cloud), dtype=torch.bool, device=device), scfg,
                                   torch.tensor(0.01, device=device),
                                   torch.tensor(0.015, device=device))
        if device.type == "cuda":
            _sync(device)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        vols.append(call())
        if device == dev:
            if dev.type == "cuda":
                splat_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            splat_ms = _median_ms(call, dev)
    overflow = bool(vols[0].overflow)
    _log(f"splat of the model cloud ({len(cloud)} points, 10 mm voxels): {splat_ms:.3f} ms "
         f"(synchronized, median of 5), {int(vols[0].n_blocks)} blocks, overflow {overflow}, "
         f"peak device memory {splat_peak:.1f} MiB above the call's inputs  [{gpu}]")
    if overflow:
        failures.append("the model cloud's splat overflowed its pool")
    if cpu_check:
        same_keys, rel_w, err_t, err_c = _splat_by_key(*vols)
        _log(f"splat card vs CPU: same block keys {same_keys}, max relative |dweight| "
             f"{rel_w:.3g}, max |dtsdf| {err_t:.3g}, max |dcolor| {err_c:.3g} (float32 atomics "
             f"on the card; tolerance {SPLAT_TOL})")
        if not (same_keys and rel_w <= SPLAT_TOL and err_t <= SPLAT_TOL and err_c <= SPLAT_TOL):
            failures.append("the splat on the card differs from the CPU's")

        # the first 2 keyframes on a CPU accumulator
        ch = acc(cpu)
        for d, c in frames[:2]:
            ch.process_frame(d, c)
        dpose = float(np.abs(ch.T_world_cam - traj[1]).max())
        _log(f"cloud accumulator card vs CPU over 2 keyframes: max |dpose| {dpose:.3g}")
        if not dpose <= CLOUD_POSE_TOL:
            failures.append(f"the accumulator's pose on the card is {dpose:.3g} off the CPU's")
    del vols, ca
    tmp.cleanup()
    return failures, counts


def compact_timing(vol, tcfg, dev, gpu: str) -> list:
    """``tsdf.streaming._compact`` over ``vol``'s alive prefix (the identity
    permutation, as an eviction that keeps every block): ms by CUDA events
    (median of 5) beside its bound, the bytes it must move: the alive rows
    gathered and written, the free rows' weights zeroed, the rebuilt table
    and coords written. Returns the failures."""
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import _compact

    n = int(vol.n_blocks)
    cap = vol.tsdf.shape[0]
    perm = np.arange(cap)
    out = _compact(vol, perm, n)
    same = bool((out.block_coords[:n] == vol.block_coords[:n]).all()) and not bool(out.overflow)
    del out
    ms = _median_ms(lambda: _compact(vol, perm, n), dev)
    r3 = tcfg.block_resolution ** 3
    row = 5 * 4 * r3 + 12  # tsdf, weight, 3 colors, coords
    n_bytes = 2 * n * row + (cap - n) * 4 * r3 + 8 * tcfg.hash_capacity
    bound, by = _bound(n_bytes, 0.0)
    _log(f"_compact of the headline volume ({n} alive of {cap} blocks, identity permutation): "
         f"{ms:.4f} ms (CUDA events, median of 5) against a bound of {bound:.4f} ms ({by}: "
         f"{n_bytes / 1e6:.1f} MB at {PEAK_HBM_BYTES / 1e12:.2f} TB/s); the same blocks after it: "
         f"{same}  [{gpu}]")
    return [] if same else ["_compact with the identity permutation changed the volume"]


def _corridor_scene():
    """bench.py's streaming corridor: a checkered wall 0.55 m ahead and 33
    spheres along +x."""
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import Plane, Scene, Sphere

    return Scene(
        planes=(Plane((0.0, 0.0, 0.55), (0.0, 0.0, -1.0), (0.7, 0.65, 0.6), checker=0.1),),
        spheres=tuple(Sphere((0.3 * k, 0.1 * (-1) ** k, 0.5), 0.05,
                             (0.3 + 0.5 * (k % 2), 0.4, 0.8 - 0.5 * (k % 2))) for k in range(33)))


def _soup_rows(mesh):
    """A triangle soup as (9 xyz + 9 rgb) rows in canonical (lexsorted)
    order: slot order differs between pools."""
    import numpy as np

    t = np.concatenate([np.asarray(mesh.vertices).reshape(-1, 9),
                        np.asarray(mesh.vertex_colors).reshape(-1, 9)], axis=1)
    return t[np.lexsort(t.T[::-1])]


def _corridor_pass(intr, cfg, raw, dev, streaming):
    """``raw`` through ``MonoOdometryTSDF(..., worklist_size=2048,
    streaming=streaming)`` with one sync at the end: (pipeline, seconds)."""
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )

    pipe = MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048, streaming=streaming)
    _sync(dev)
    t0 = time.perf_counter()
    for d, c in raw:
        pipe.process_frame(d, c)
    _sync(dev)
    return pipe, time.perf_counter() - t0


def streaming_phase(cfg, dev, gpu: str, runs=STREAM_RUNS, cli: bool = True):
    """Host streaming on bench.py's corridor runs (``STREAM_RUNS``):
    ``MonoOdometryTSDF(..., streaming=StreamingTSDF.for_pipeline(cfg,
    check_interval=8, margin=...))`` into the 1,024-block pool, one warm
    pass and one timed pass with the launch counters zeroed just before and
    read just after, then the same frames (warm, timed) into a plain
    4,096-block pool. Checks: no overflow and at least one eviction; B1
    exactly once a frame and B2 once a tracked frame; the trajectory equal
    to the comparator's to the bit; the assembled ``extract_mesh`` soup,
    sorted, equal to the comparator's to the bit; ``extract_point_cloud``
    with the comparator's row count. Prints frames/s of both and their
    ratio, tick ms by stage, the host store's bytes. Then, with ``cli``,
    runs the port's ``live_mono`` entry point with ``--streaming`` in a
    subprocess. Returns (failures, launch counts of each timed streamed
    pass)."""
    import dataclasses

    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF

    failures, all_counts = [], []
    scfg = dataclasses.replace(
        cfg, tsdf=TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=16,
                             block_capacity=1024, hash_capacity=8192),
        camera=cfg.camera.replace(depth_trunc=0.7))
    pcfg = dataclasses.replace(scfg, tsdf=scfg.tsdf.replace(
        block_capacity=STREAM_PLAIN_BLOCKS, hash_capacity=4 * STREAM_PLAIN_BLOCKS))
    scene = _corridor_scene()
    for scale, n, step, margin in runs:
        intr = Intrinsics.azure_kinect_depth_nfov().scaled(scale)
        cam = SyntheticCamera(scene=scene, intrinsics=intr, device=dev)
        poses = [np.eye(4) for _ in range(n)]
        for i, T in enumerate(poses):
            T[0, 3] = step * i
        raw = [_quantize(cam.render(T)) for T in poses]
        manager = lambda: StreamingTSDF.for_pipeline(scfg, check_interval=8, margin=margin,
                                                     device=dev)
        what = f"streaming {intr.width}x{intr.height}, {n} frames at {step} m"
        _corridor_pass(intr, scfg, raw, dev, manager())  # warm: set-up, the eviction path
        build.launches.clear()
        sp, s_sec = _corridor_pass(intr, scfg, raw, dev, manager())
        counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
        all_counts.append(counts)
        _corridor_pass(intr, pcfg, raw, dev, None)
        pp, p_sec = _corridor_pass(intr, pcfg, raw, dev, None)
        sv = sp.streaming
        t0 = time.perf_counter()
        ms_, mp = sp.extract_mesh(), pp.extract_mesh().compact()
        soups = _soup_rows(ms_), _soup_rows(mp)
        s_extract = time.perf_counter() - t0
        (sp_pts, _), (pp_pts, _) = sp.extract_point_cloud(), pp.extract_point_cloud()
        same_traj = np.array_equal(np.stack(sp.trajectory), np.stack(pp.trajectory))
        same_soup = soups[0].shape == soups[1].shape and np.array_equal(*soups)
        overflow = bool(sp.volume.overflow) or bool(pp.volume.overflow)
        ticks = max(sv.n_ticks, 1)
        stage = {k: round(v / ticks, 3)
                 for k, v in sorted(sv.tick_ms.items(), key=lambda kv: -kv[1])}
        _log(f"{what} launches: {json.dumps(counts)} (the timed streamed pass)  [{gpu}]")
        _log(f"{what}: streamed {n / s_sec:.3f} frames/s, plain ({STREAM_PLAIN_BLOCKS}-block "
             f"pool) {n / p_sec:.3f} frames/s, ratio {p_sec / s_sec:.4f} (host clock, one sync "
             f"at the end, warm passes first); reload<{sv.reload_dist:.3f} m, "
             f"evict>{sv.evict_dist:.3f} m, high water {sv.high_water}; {sv.n_ticks} ticks, "
             f"{sv.n_evictions} evictions, {sv.n_reloads} reloads, {sv.n_stored} blocks stored, "
             f"{sv.n_frozen} frozen, {int(sp.volume.n_blocks)} live (plain "
             f"{int(pp.volume.n_blocks)}); host store {sv.pinned_bytes / 2**20:.3f} MiB "
             f"({'page-locked' if dev.type == 'cuda' else 'CPU memory'}); gate rejections "
             f"{sp.odometry_failures}  [{gpu}]")
        _log(f"{what}: tick ms per tick by stage (host clock, {sv.n_ticks} ticks) "
             f"{json.dumps(stage)}  [{gpu}]")
        _log(f"{what}: trajectory equal to the plain pass's to the bit: {same_traj}; sorted soup "
             f"equal to the bit: {same_soup} ({soups[0].shape[0]} / {soups[1].shape[0]} "
             f"triangles; both extractions {s_extract * 1e3:.1f} ms); point cloud rows "
             f"{sp_pts.shape[0]} / {pp_pts.shape[0]}; overflow {overflow}")
        if overflow or sv.n_evictions == 0:
            failures.append(f"{what}: overflow {overflow}, {sv.n_evictions} evictions")
        if counts[tk.KERNEL] != n or counts[odo.KERNEL] != n - 1:
            failures.append(f"{what}: launches {counts}, not B1 once a frame and B2 once a "
                            "tracked frame")
        if not (same_traj and same_soup and sp_pts.shape[0] == pp_pts.shape[0]):
            failures.append(f"{what}: the streamed pass differs from the plain pass "
                            f"(trajectory {same_traj}, soup {same_soup}, cloud rows "
                            f"{sp_pts.shape[0]} / {pp_pts.shape[0]})")
        del sp, pp, sv, raw
    if cli:
        with tempfile.TemporaryDirectory() as out:
            args = ["--source", "synthetic", "--frames", str(N_CLI_FRAMES), "--streaming",
                    "--output", out]
            if dev.type != "cuda":
                args += ["--device", "cpu", "--scale", "0.25"]
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", f"{PKG}.cli.live_mono", *args],
                               capture_output=True, text=True, timeout=600, cwd=REPO)
            names = sorted(os.listdir(out))
            saved = all(any(k in f for f in names) for k in ("mesh", "volume_pcd", "trajectory"))
            tail = [ln for ln in r.stdout.splitlines() if "streaming:" in ln or "frames," in ln]
            _log(f"cli.live_mono --streaming over {N_CLI_FRAMES} frames: rc {r.returncode}, "
                 f"{time.perf_counter() - t0:.1f} s (host clock, process start included), wrote "
                 f"{names}; {' | '.join(tail)}")
            if r.returncode != 0 or not saved:
                failures.append(f"cli.live_mono --streaming: rc {r.returncode}, wrote {names}; "
                                f"{r.stderr[-1500:]}")
    return failures, all_counts


def main() -> int:
    import torch

    t_start = time.perf_counter()
    why = _port_beside()
    if why:
        return _fail(why)
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
    tk.integrate_worklist_cuda(vk, wl, d2, c2, gt[2], intr, tcfg, n_active)
    tk.integrate_worklist_plain(vp, wl, d2, c2, gt[2], intr, tcfg)
    torch.cuda.synchronize()
    live = wl[: min(int(n_active), wl.shape[0]), 0].long()
    wk, wp = vk.weight[live], vp.weight[live]
    agree = wk == wp
    frac = float(agree.float().mean())
    err_t = float((vk.tsdf[live] - vp.tsdf[live]).abs()[agree].max())
    err_c = float((vk.color[live] - vp.color[live]).abs()[agree[:, None].expand(-1, 3, -1)].max())
    bitwise = all(torch.equal(getattr(vk, k), getattr(vp, k)) for k in ("tsdf", "weight", "color"))
    n_updated = int(tk.updated_voxels(wl[: live.numel()], d2, gt[2], intr, tcfg))
    updated = n_updated / max(wk.numel(), 1)
    grid = tk.launch_grid(tcfg.block_resolution)
    _log(f"B1 tsdf_integrate: {int(n_active)} live worklist rows, {updated:.3%} of their voxels "
         f"updated (update rule); weights equal on {frac:.6%}, max |dtsdf| {err_t:.3g}, max "
         f"|dcolor| {err_c:.3g} where they agree; pools equal to the bit: {bitwise}; "
         f"persistent grid {grid} CTAs")
    if not (frac >= B1_WEIGHT_EQUAL_MIN and err_t <= B1_VALUE_TOL and err_c <= B1_VALUE_TOL):
        failures.append("B1 kernel disagrees with its plain version")
    b1_call = lambda: tk.integrate_worklist_cuda(vk, wl, d2, c2, gt[2], intr, tcfg, n_active)
    ms_k = _time_ms(b1_call, 50)
    ms_p = _time_ms(lambda: tk.integrate_worklist_plain(vp, wl, d2, c2, gt[2], intr, tcfg), 5)
    us_k, per_call = _device_us(b1_call, 20, "tsdf_integrate_kernel")
    b1_bytes = b1_bound_bytes(n_updated, live.numel(), d2, c2)
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
                        device_us=us_k, weight_equal_fraction=frac, bitwise=bitwise,
                        grid=grid))
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
    wfov_failures, wfov = wfov_check(cfg, dev, gpu)
    failures += wfov_failures
    kernels[1].update(wfov)

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
    failures += compact_timing(pipe.volume, tcfg, dev, gpu)
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
    rec_failures, rec_counts = recorder_phase(intr, cfg, cam, raw32[:N_REC_FRAMES],
                                              gt32[:N_REC_FRAMES], dev, gpu)
    failures += rec_failures
    off_failures, off_counts = offline_phase(intr, cfg, cam, poses32[:N_OFFLINE_OUT], dev, gpu)
    failures += off_failures
    for k in kernels:
        k["launches_recorder"] = rec_counts[k["name"]]
        k["launches_offline"] = off_counts[k["name"]]
    reloc_failures, reloc_counts = reloc_phase(intr, cfg, cam, poses32, raw, dev, gpu)
    failures += reloc_failures
    for k in kernels:
        k["launches_relocalize"] = reloc_counts[k["name"]]
    failures += incremental_phase(intr, cfg, raw, dev, gpu)
    frag_failures, frag_counts = fragments_phase(intr, cfg, cam, dev, gpu)
    failures += frag_failures
    cloud_failures, cloud_counts = cloud_phase(intr, cfg, cam, raw, gt, dev, gpu)
    failures += cloud_failures
    for k in kernels:
        k["launches_fragments"] = frag_counts[k["name"]]
        k["launches_cloud"] = cloud_counts[k["name"]]
    stream_failures, stream_counts = streaming_phase(cfg, dev, gpu)
    failures += stream_failures
    for k in kernels:
        k["launches_streaming"] = stream_counts[0][k["name"]]
        k["launches_streaming_quarter"] = stream_counts[1][k["name"]]
    _log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s (host clock)")
    if failures:
        return _fail("; ".join(failures))

    _log(json.dumps({"kernels": kernels}))
    _log(gpu)
    _log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


def _port_beside():
    """Why the package beside this script cannot be timed on a card (no
    card, no package, another copy imported), or None; puts it on the
    import path."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device is available"
    pkg_dir = os.path.join(REPO, PKG)
    if not os.path.isdir(pkg_dir):
        return f"the {PKG} package is not beside this script"
    sys.path.insert(0, REPO)
    import azurekinect3dreconstruction_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(pkg_dir + os.sep):
        return f"imported {port.__file__}, not the package beside this script"
    return None


def odometry_main() -> int:
    """``--odometry``: the odometry numbers of the package beside this
    script, through calls every version of the port has."""
    import statistics

    import torch

    why = _port_beside()
    if why:
        return _fail(why)
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


def integrate_main() -> int:
    """``--integrate``: B1's numbers of the package beside this script,
    through calls every version of the port has (the bound needs
    ``tsdf_kernels.updated_voxels``; a version without it prints null)."""
    import numpy as np
    import torch

    why = _port_beside()
    if why:
        return _fail(why)
    from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

    dev = torch.device("cuda:0")
    gpu = _gpu_line()
    _log(f"gpu: {gpu}")
    build.library()
    cfg, intr, _, poses, raw = _bench(dev, N_FRAMES)
    tcfg = cfg.tsdf
    dec = [_decode(r, cfg, dev) for r in raw[:3]]
    gt = [torch.as_tensor(np.linalg.inv(poses[0]) @ T, dtype=torch.float32, device=dev)
          for T in poses[:3]]
    rays = pixel_rays(intr, dev)
    count = getattr(tk, "updated_voxels", None)

    def bound(vol, d, c, T):
        """(live rows, updated voxels, bound us, bytes) of one frame into ``vol``."""
        wl, n_active = tk.build_worklist(vol.block_coords, vol.n_blocks, T, intr, tcfg)
        n_live = int(n_active)
        if count is None:
            return n_live, None, None, None
        n_upd = int(count(wl[:n_live], d, T, intr, tcfg))
        n_bytes = b1_bound_bytes(n_upd, n_live, d, c)
        return n_live, n_upd, _bound(n_bytes, 0.0)[0] * 1e3, n_bytes

    # the stated input: the third frame into a 2-frame volume, M = 2048
    vol = tsdf.create(tcfg, dev)
    for i in range(2):
        vol = tsdf.integrate_frame(vol, dec[i][0], dec[i][1], rays, gt[i], intr, tcfg)
    d2, c2, _ = dec[2]
    vol = tsdf.allocate(vol, d2, rays, gt[2], tcfg)
    n_live, n_upd, bound_us, n_bytes = bound(vol, d2, c2, gt[2])
    call = lambda: tk.integrate_worklist(vol, d2, c2, gt[2], intr, tcfg, worklist_size=2048)
    us, per_call = _device_us(call, 50, "tsdf_integrate")
    call_ms = _median_ms(call, dev, 50)
    del vol

    # the first frame: allocate + a whole-pool worklist (integrate_frame)
    d0, c0, _ = dec[0]
    fresh = tsdf.create(tcfg, dev)
    first = tsdf.allocate(fresh, d0, rays, gt[0], tcfg)
    first_live, first_upd, first_bound_us, _ = bound(first, d0, c0, gt[0])
    del first
    us_first, _ = _device_us(
        lambda: tsdf.integrate_frame(fresh, d0, c0, rays, gt[0], intr, tcfg), 20, "tsdf_integrate")
    del fresh

    # the 16-frame mono loop: B1's device time per launch
    _run_frames(MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048), raw[:3], False)
    pipe = MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048)
    torch.cuda.synchronize()
    total, launches = _profiled(lambda: _run_frames(pipe, raw, False), "tsdf_integrate")
    grid = tk.launch_grid(tcfg.block_resolution) if hasattr(tk, "launch_grid") else None
    _log(json.dumps({
        "checkout": REPO, "gpu": gpu, "grid": grid,
        "b1_device_us_per_launch": us, "b1_kernels_per_call": per_call,
        "integrate_worklist_ms_synced_median": call_ms,
        "worklist_rows": 2048, "live_rows": n_live, "updated_voxels": n_upd,
        "bound_us": bound_us, "bound_bytes": n_bytes,
        "first_frame_device_us_per_launch": us_first,
        "first_frame_worklist_rows": tcfg.block_capacity, "first_frame_live_rows": first_live,
        "first_frame_updated_voxels": first_upd, "first_frame_bound_us": first_bound_us,
        "mono_b1_device_us_per_launch": total / launches if launches else None,
        "mono_b1_launches": launches, "mono_frames": N_FRAMES}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--odometry", action="store_true",
                      help="time only the odometry of the package beside this script")
    mode.add_argument("--integrate", action="store_true",
                      help="time only B1 (TSDF integrate) of the package beside this script")
    args = ap.parse_args()
    sys.exit(odometry_main() if args.odometry else integrate_main() if args.integrate
             else main())
