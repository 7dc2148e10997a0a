"""The JAX package's ``bench.py`` on the port: the same sections, sizes,
timing methods and keys, on one card.

    python -m azurekinect3dreconstruction_tpu_torch.cli.bench [--device cuda|cpu]

Prints ONE JSON line on stdout: every key of ``bench.py``'s line (``KEYS``,
in its order) plus ``"errors"``, ``{section: message}`` for each section
that raised or failed one of ``bench.py``'s checks; that section's keys are
``null`` and the sections after it still run. The process exits 1 when
``"errors"`` is not empty. ``"device"`` is the card's name and power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, ``"cpu"`` on the CPU. Everything else the pipelines print, the
progress marks and each section's kernel launches (``build.launches`` of
``tsdf_integrate`` and ``odometry_pyramid`` beside the count the section
expects on the card) go to stderr.

The configuration is ``bench.py``'s: 640x576 NFOV depth, 5 mm voxels in
16^3 blocks, a 16,384-block pool and a 65,536-slot hash, a 2,048-block
worklist, the synthetic default scene and the 64-pose sweep
``orbit_trajectory(64, radius=0.35, angle_span=1.3)``. Each section is a
function that takes its sizes as arguments, with ``bench.py``'s as their
defaults, and returns its keys. Timing follows ``bench.py``: the same frame
counts, min-of-N and slopes over K dispatches, on the host clock; where
``bench.py`` pulls a value to wait for the device, the section calls
``torch.cuda.synchronize()``, and the pulls that are checks
(``volume_checksum``, the half-sweep ``n_blocks``) stay. The pools update in
place, so ``bench.py``'s threading of its donated volume is a plain reuse.

Two keys do not carry over and are ``null``: ``extract_incremental_preview_ms``
and ``incremental_pull_bytes_preview`` time the incremental extractor's
``wire="preview"`` encoding, which the port leaves out. The close-up frames
that ``bench.py`` integrates while it times that wire are integrated all
the same, so the sections after it see ``bench.py``'s volume.

The JAX bench's persistent compile cache has one counterpart here: the
kernel library built under ``build/kernels/``, which ``reloc_warmup_cached_s``
shows a second process loading and not rebuilding.

``--device cuda`` (the default) without a card raises at start; nothing
falls back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device, upload
from azurekinect3dreconstruction_tpu_torch.io.streams import prefetch_to_device
from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
    Plane,
    Scene,
    Sphere,
    SyntheticCamera,
    orbit_trajectory,
)
from azurekinect3dreconstruction_tpu_torch.ops.image import rgb_to_intensity
from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
from azurekinect3dreconstruction_tpu_torch.parallel import sharded_volume as sv
from azurekinect3dreconstruction_tpu_torch.pipelines.cloud_accumulator import CloudAccumulator
from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import DualCameraFusion
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
    MonoOdometryTSDF,
    make_device_slam_batch,
    make_raw_batch_fn,
)
from azurekinect3dreconstruction_tpu_torch.pipelines.offline_bundle import OfflineBundle
from azurekinect3dreconstruction_tpu_torch.pipelines.recorder import Recorder
from azurekinect3dreconstruction_tpu_torch.tracking.relocalize import Relocalizer
from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
from azurekinect3dreconstruction_tpu_torch.tsdf.incremental import IncrementalExtractor
from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF, _compact
from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate, rpe

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the keys of bench.py's JSON line, in its order
KEYS = (
    "metric", "value", "unit", "vs_baseline", "frame_ms", "fps_cold_scanning", "cold_frame_ms",
    "n_distinct_poses", "blocks_growing", "slam_fps_odometry_plus_fusion", "slam_frame_ms",
    "slam_ate_rmse_mm", "slam_final_drift_mm", "slam_rpe_trans_mm", "slam_rpe_rot_deg",
    "sharded_slam_fps", "sharded_slam_frame_ms", "pipeline_fps", "pipeline_frame_ms",
    "pipeline_fps_resident", "dual_fusion_pair_fps", "dual_fusion_fps_per_camera",
    "dual_fusion_pair_fps_moving", "recorder_fps", "recorder_keyframe_ms",
    "recorder_interval_ms", "streaming_fps", "streaming_n_evictions", "streaming_overflow",
    "corridor_plain_fps", "streaming_vs_plain", "streaming_tick_ms", "streaming_fullres_fps",
    "streaming_fullres_evictions", "reloc_warmup_s", "reloc_warmup_cached_s",
    "reloc_recovery_ms", "reloc_err_mm", "f2m_fps", "f2m_refines_ok",
    "offline_reintegrate_fps", "offline_optimize_s", "offline_finalize_s",
    "cloud_accumulator_kf_fps", "h2d_mbps", "d2h_mbps", "extract_ms", "extract_incremental_ms",
    "extract_incremental_preview_ms", "incremental_pull_bytes_exact",
    "incremental_pull_bytes_preview", "extract_full_refresh_ms", "incremental_touched_blocks",
    "evict_compact_ms", "min_sharded_fitness", "mesh_triangles", "extract_overflow", "n_blocks",
    "volume_checksum", "min_odometry_fitness", "device",
)
# the keys of the preview wire, which the port does not have
PREVIEW_KEYS = ("extract_incremental_preview_ms", "incremental_pull_bytes_preview")

# bench.py's sections in its order: (name, the keys its function returns)
SECTIONS = (
    ("fused", ("metric", "value", "unit", "vs_baseline", "frame_ms", "fps_cold_scanning",
               "cold_frame_ms", "n_distinct_poses", "blocks_growing", "volume_checksum",
               "n_blocks")),
    ("extract", ("extract_ms", "mesh_triangles", "extract_overflow")),
    ("slam", ("slam_fps_odometry_plus_fusion", "slam_frame_ms", "min_odometry_fitness")),
    ("accuracy", ("slam_ate_rmse_mm", "slam_final_drift_mm", "slam_rpe_trans_mm",
                  "slam_rpe_rot_deg")),
    ("sharded", ("sharded_slam_fps", "sharded_slam_frame_ms", "min_sharded_fitness")),
    ("pipeline", ("pipeline_fps", "pipeline_frame_ms", "pipeline_fps_resident", "h2d_mbps",
                  "d2h_mbps")),
    ("incremental", ("extract_incremental_ms", "incremental_pull_bytes_exact",
                     "incremental_touched_blocks", "extract_full_refresh_ms")),
    ("compact", ("evict_compact_ms",)),
    ("dual", ("dual_fusion_pair_fps", "dual_fusion_fps_per_camera",
              "dual_fusion_pair_fps_moving")),
    ("recorder", ("recorder_fps", "recorder_keyframe_ms", "recorder_interval_ms")),
    ("streaming", ("streaming_fps", "streaming_n_evictions", "streaming_overflow",
                   "corridor_plain_fps", "streaming_vs_plain", "streaming_tick_ms",
                   "streaming_fullres_fps", "streaming_fullres_evictions")),
    ("relocalize", ("reloc_warmup_s", "reloc_recovery_ms", "reloc_err_mm")),
    ("frame_to_model", ("f2m_fps", "f2m_refines_ok")),
    ("offline", ("offline_reintegrate_fps", "offline_optimize_s", "offline_finalize_s")),
    ("cloud", ("cloud_accumulator_kf_fps",)),
    ("cached_warmup", ("reloc_warmup_cached_s",)),
)

# bench.py's configuration
BENCH_TSDF = TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=16,
                        block_capacity=16384, hash_capacity=65536)
N_SWEEP = 64
WORKLIST = 2048
STRIDE = 2
KERNELS = (tk.KERNEL, odo.KERNEL)


class SectionCheckFailed(RuntimeError):
    """One of ``bench.py``'s checks failed in a section."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise SectionCheckFailed(msg)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _quantize(z, c):
    """A rendered (depth m, color 0..1) pair as the sensor gives it: u16 mm
    and u8 RGB on the host."""
    return (torch.round(z * 1000.0).cpu().numpy().astype(np.uint16),
            torch.round(c * 255.0).cpu().numpy().astype(np.uint8))


@dataclasses.dataclass
class Inputs:
    """What the sections share: the configuration, the camera, the sweep
    rendered on the device, a scratch directory, and the objects one
    section leaves for later ones (``bench.py``'s locals)."""

    dev: torch.device
    cfg: PipelineConfig
    intr: Intrinsics
    cam: SyntheticCamera
    rays: torch.Tensor
    sweep: list  # camera-to-world poses (host float64)
    depths: torch.Tensor  # (F, H, W) m
    colors: torch.Tensor  # (F, H, W, 3)
    poses: torch.Tensor  # (F, 4, 4) float32
    out_dir: str
    vol: Optional[tsdf.TSDFVolume] = None  # the fused sweep, warm (section fused)
    host_frames: Optional[list] = None  # u16 / u8 sweep frames on the host (section pipeline)
    dev_frames: Optional[list] = None  # the same on the device
    reloc: Optional[Relocalizer] = None  # section relocalize's relocalizer


def render_all(cam: SyntheticCamera, poses, dev):
    """(depths, colors, poses as float32) of ``poses``, rendered on ``dev``."""
    r = [cam.render(T) for T in poses]
    return (torch.stack([z for z, _ in r]), torch.stack([c for _, c in r]),
            torch.as_tensor(np.stack(poses), dtype=torch.float32, device=dev))


def make_inputs(dev, out_dir: str, scale: float = 1.0, tsdf_cfg: TSDFConfig = BENCH_TSDF,
                n_sweep: int = N_SWEEP) -> Inputs:
    """``bench.py``'s configuration and its sweep, rendered on ``dev``."""
    dev = resolve_device(dev)
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(scale)
    cam = SyntheticCamera(intrinsics=intr, device=dev)
    sweep = [np.asarray(T, np.float64)
             for T in orbit_trajectory(n_sweep, radius=0.35, angle_span=1.3)]
    depths, colors, poses = render_all(cam, sweep, dev)
    return Inputs(dev=dev, cfg=PipelineConfig(tsdf=tsdf_cfg), intr=intr, cam=cam,
                  rays=pixel_rays(intr, dev), sweep=sweep, depths=depths, colors=colors,
                  poses=poses, out_dir=out_dir)


def _need(value, what: str):
    if value is None:
        raise RuntimeError(f"needs {what}, which an earlier section did not leave")
    return value


# -- the sections (bench.py's order) ---------------------------------------------------


def fused_section(b: Inputs, expect, warm_frames: int = 32, worklist_size: int = WORKLIST,
                  stride: int = STRIDE, cold_passes: int = 3) -> dict:
    """``bench.py:46-132``: ``make_fused_batch_fn`` warmed on its own
    trajectory into a volume then dropped; the sweep cold in two half
    batches (``n_blocks`` must grow between them: ``blocks_growing``), the
    min of ``cold_passes`` cold passes (``fps_cold_scanning``), then the
    steady re-pass of the first half into the warm pool by slope
    (``value``). Leaves the warm volume in ``b.vol``."""
    dev, tcfg = b.dev, b.cfg.tsdf
    n = len(b.sweep)
    half = n // 2
    D, C, P = b.depths, b.colors, b.poses
    batch = tk.make_fused_batch_fn(b.intr, tcfg, worklist_size, stride)
    wd, wc, wp = render_all(b.cam, orbit_trajectory(warm_frames, radius=0.3, angle_span=1.2,
                                                    center=(0.05, 0.05, 1.3)), dev)
    batch(tsdf.create(tcfg, dev), wd, wc, wp, b.rays)
    _sync(dev)
    expect[tk.KERNEL] += warm_frames
    del wd, wc, wp
    gc.collect()

    vol = batch(tsdf.create(tcfg, dev), D[:half], C[:half], P[:half], b.rays)
    n_blocks_mid = int(vol.n_blocks)
    vol = batch(vol, D[half:], C[half:], P[half:], b.rays)
    checksum = float(vol.weight.sum())
    n_blocks = int(vol.n_blocks)
    growing = 0 < n_blocks_mid < n_blocks
    expect[tk.KERNEL] += n

    def cold_pass():
        t0 = time.perf_counter()
        v = batch(tsdf.create(tcfg, dev), D[:half], C[:half], P[:half], b.rays)
        batch(v, D[half:], C[half:], P[half:], b.rays)
        _sync(dev)
        return time.perf_counter() - t0

    dt_cold = min(cold_pass() for _ in range(cold_passes)) / n
    expect[tk.KERNEL] += cold_passes * n

    state = {"v": vol}

    def repass(k):
        t0 = time.perf_counter()
        for _ in range(k):
            state["v"] = batch(state["v"], D[:half], C[:half], P[:half], b.rays)
        _sync(dev)
        return time.perf_counter() - t0

    repass(1)
    t1 = min(repass(1) for _ in range(2))
    t3 = min(repass(3) for _ in range(2))
    expect[tk.KERNEL] += half * (1 + 2 * 1 + 2 * 3)
    dt_steady = (t3 - t1) / (2 * half)
    b.vol = state["v"]
    fps_steady = 1.0 / dt_steady
    return {
        "metric": "depth_fps_into_5mm_tsdf_640x576",
        "value": round(fps_steady, 2),
        "unit": "fps",
        "vs_baseline": round(fps_steady / 30.0, 3),
        "frame_ms": round(dt_steady * 1000.0, 2),
        "fps_cold_scanning": round(1.0 / dt_cold, 2),
        "cold_frame_ms": round(dt_cold * 1000.0, 2),
        "n_distinct_poses": n,
        "blocks_growing": bool(growing),
        "volume_checksum": checksum,
        "n_blocks": n_blocks,
    }


def fitted_budgets(vol, tcfg: TSDFConfig, max_tris: int = 786432):
    """``bench.py:144-147``: (max_cells fitted to the scene's active
    bricks, max_tris, extract_blocks)."""
    E = 4096 if int(vol.n_blocks) > 2048 else 2048
    nbricks = int(mc.count_active_bricks(vol, tcfg, extract_blocks=E))
    mcells = max(1 << 16, ((nbricks * 9 // 8) + 4095) // 4096 * 4096 * 64)
    return mcells, max_tris, E


def extract_section(b: Inputs, expect, max_tris: int = 786432) -> dict:
    """``bench.py:134-168``: ``extract_mesh_arrays`` at the fitted cell
    budget, by slope (6 extractions less 1, over 5)."""
    vol, tcfg, dev = _need(b.vol, "the fused volume"), b.cfg.tsdf, b.dev
    mcells, mtris, E = fitted_budgets(vol, tcfg, max_tris)

    def extract():
        return mc.extract_mesh_arrays(vol, tcfg, max_cells=mcells, max_tris=mtris,
                                      extract_blocks=E)

    _, _, n_tris, ovf = extract()
    _sync(dev)

    def ext_run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            extract()
        _sync(dev)
        return time.perf_counter() - t0

    ext_run(1)
    e1 = min(ext_run(1) for _ in range(3))
    e6 = min(ext_run(6) for _ in range(2))
    return {"extract_ms": round((e6 - e1) / 5 * 1000.0, 2), "mesh_triangles": int(n_tris),
            "extract_overflow": bool(ovf)}


def slam_section(b: Inputs, expect, n_slam: int = 16, worklist_size: int = WORKLIST,
                 stride: int = STRIDE) -> dict:
    """``bench.py:170-204``: ``make_device_slam_batch`` over the first
    ``n_slam`` sweep frames (B2 and B1 once a tracked frame), by slope (3
    batches less 1, over 2 x (n_slam - 1) frames); the first batch's
    least fitness."""
    dev, tcfg = b.dev, b.cfg.tsdf
    slam = make_device_slam_batch(b.intr, b.cfg, worklist_size=worklist_size, stride=stride)
    intens = torch.stack([rgb_to_intensity(c) for c in b.colors[:n_slam]])
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    run = lambda v: slam(v, eye, intens, b.depths[:n_slam], b.colors[:n_slam], b.rays)
    _, _, fits = run(tsdf.create(tcfg, dev))
    _sync(dev)

    def slam_run(k):
        t0 = time.perf_counter()
        v, _, _ = run(tsdf.create(tcfg, dev))
        for _ in range(k - 1):
            v, _, _ = run(v)
        _sync(dev)
        return time.perf_counter() - t0

    s1 = min(slam_run(1) for _ in range(2))
    s3 = min(slam_run(3) for _ in range(2))
    for k in KERNELS:
        expect[k] += (n_slam - 1) * (1 + 2 * 1 + 2 * 3)
    slam_dt = (s3 - s1) / (2 * (n_slam - 1))
    return {"slam_fps_odometry_plus_fusion": round(1.0 / slam_dt, 2),
            "slam_frame_ms": round(slam_dt * 1000.0, 2),
            "min_odometry_fitness": round(float(fits.min()), 3)}


def accuracy_section(b: Inputs, expect, worklist_size: int = WORKLIST,
                     stride: int = STRIDE) -> dict:
    """``bench.py:206-222``: the SLAM batch over the whole sweep against
    its ground truth (camera 0's frame): ATE and RPE."""
    dev = b.dev
    slam = make_device_slam_batch(b.intr, b.cfg, worklist_size=worklist_size, stride=stride)
    intens = torch.stack([rgb_to_intensity(c) for c in b.colors])
    _, traj, _ = slam(tsdf.create(b.cfg.tsdf, dev), torch.eye(4, dtype=torch.float32, device=dev),
                      intens, b.depths, b.colors, b.rays)
    for k in KERNELS:
        expect[k] += len(b.sweep) - 1
    est = traj.cpu().numpy().astype(np.float64)
    gt0 = np.linalg.inv(b.sweep[0])
    gt = np.stack([gt0 @ T for T in b.sweep[1:]])
    a, r = ate(est, gt), rpe(est, gt)
    return {"slam_ate_rmse_mm": round(a["rmse"] * 1000.0, 2),
            "slam_final_drift_mm": round(a["final_drift"] * 1000.0, 2),
            "slam_rpe_trans_mm": round(r["trans_rmse"] * 1000.0, 3),
            "slam_rpe_rot_deg": round(float(np.degrees(r["rot_rmse"])), 4)}


def sharded_section(b: Inputs, expect, n_slam: int = 16, worklist_size: int = WORKLIST,
                    stride: int = STRIDE) -> dict:
    """``bench.py:224-257``: ``make_sharded_slam_batch`` on a 1 x 1 mesh
    over the SLAM section's frames, by the same slope."""
    dev, tcfg = b.dev, b.cfg.tsdf
    smesh = sv.make_mesh(1, 1, [dev])
    sbatch = sv.make_sharded_slam_batch(smesh, b.intr, b.cfg, stride=stride,
                                        worklist_size=worklist_size)
    intens = torch.stack([rgb_to_intensity(c) for c in b.colors[:n_slam]])[None]
    eye = torch.eye(4, dtype=torch.float32, device=dev)[None]
    run = lambda v: sbatch(v, eye, intens, b.depths[None, :n_slam], b.colors[None, :n_slam],
                           b.rays)
    _, _, sfits = run(sv.create_sharded(tcfg, smesh))
    _sync(dev)

    def sharded_run(k):
        t0 = time.perf_counter()
        v, _, _ = run(sv.create_sharded(tcfg, smesh))
        for _ in range(k - 1):
            v, _, _ = run(v)
        _sync(dev)
        return time.perf_counter() - t0

    sh1 = min(sharded_run(1) for _ in range(2))
    sh3 = min(sharded_run(3) for _ in range(2))
    for k in KERNELS:
        expect[k] += (n_slam - 1) * (1 + 2 * 1 + 2 * 3)
    dt = (sh3 - sh1) / (2 * (n_slam - 1))
    return {"sharded_slam_fps": round(1.0 / dt, 2), "sharded_slam_frame_ms": round(dt * 1000.0, 2),
            "min_sharded_fitness": round(float(sfits.min()), 3)}


def pipeline_section(b: Inputs, expect, n_frames: int = 32, n_warm: int = 3,
                     worklist_size: int = WORKLIST, n_bufs: int = 4) -> dict:
    """``bench.py:259-326``: ``MonoOdometryTSDF`` over the first
    ``n_frames`` sweep frames quantized on the host and fed through
    ``prefetch_to_device`` (one sync at the end), then with the frames
    resident on the device; serial host-to-device and device-to-host
    copies of 2 MiB buffers. Leaves the frames in ``b.host_frames`` and
    ``b.dev_frames``."""
    dev = b.dev
    host = [_quantize(b.depths[i], b.colors[i]) for i in range(n_frames)]
    pipe = MonoOdometryTSDF(b.intr, b.cfg, device=dev, worklist_size=worklist_size)
    for d, c in host[:n_warm]:
        pipe.process_frame(d, c)
    _sync(dev)
    pipe.reset()
    t0 = time.perf_counter()
    for d, c in prefetch_to_device(iter(host), device=dev):
        pipe.process_frame(d, c)
    _sync(dev)
    pipeline_dt = (time.perf_counter() - t0) / n_frames

    mib = 2 << 20
    bufs = [np.random.default_rng(i).integers(0, 255, mib, dtype=np.uint8) for i in range(n_bufs)]
    torch.from_numpy(bufs[0]).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    up = [torch.from_numpy(a).to(dev) for a in bufs]
    _sync(dev)
    h2d_mbps = (len(bufs) * 2.0) / (time.perf_counter() - t0)
    dbuf = torch.zeros((mib,), dtype=torch.uint8, device=dev) + 1
    _sync(dev)
    dbuf.cpu().numpy()  # warm the transfer path
    dbufs = [torch.full((mib,), i, dtype=torch.uint8, device=dev) for i in range(1, n_bufs)]
    _sync(dev)
    t0 = time.perf_counter()
    for a in dbufs:
        a.cpu().numpy()
    d2h_mbps = (len(dbufs) * 2.0) / (time.perf_counter() - t0)
    del up, dbuf, dbufs

    dev_frames = [(torch.from_numpy(d).to(dev), torch.from_numpy(c).to(dev)) for d, c in host]
    _sync(dev)
    pipe.reset()
    t0 = time.perf_counter()
    for d, c in dev_frames:
        pipe.process_frame(d, c)
    _sync(dev)
    resident_dt = (time.perf_counter() - t0) / n_frames
    expect[tk.KERNEL] += n_warm + 2 * n_frames
    expect[odo.KERNEL] += n_warm - 1 + 2 * (n_frames - 1)
    b.host_frames, b.dev_frames = host, dev_frames
    return {"pipeline_fps": round(1.0 / pipeline_dt, 2),
            "pipeline_frame_ms": round(pipeline_dt * 1000.0, 2),
            "pipeline_fps_resident": round(1.0 / resident_dt, 2),
            "h2d_mbps": round(h2d_mbps, 1), "d2h_mbps": round(d2h_mbps, 1)}


def closeup_pose(i: int) -> np.ndarray:
    """``bench.py:341-351``: a close-up of the scene's red sphere."""
    eye = np.array([0.02 * i - 0.05, -0.35, 1.05 + 0.02 * i])
    target = np.array([0.0, 0.1, 1.2])
    z = target - eye
    z /= np.linalg.norm(z)
    up = np.array([0.0, -1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, np.cross(z, x), z, eye
    return T


def incremental_section(b: Inputs, expect, n_warm: int = 2, n_timed: int = 5,
                        n_preview: int = 6, worklist_size: int = WORKLIST,
                        stride: int = STRIDE) -> dict:
    """``bench.py:328-407``: close-up frames integrated into the fused
    volume one at a time, each followed by ``IncrementalExtractor.update``
    (the first ``n_warm`` warm its compact path; the median of the next
    ``n_timed``, their pull bytes and touched blocks); the ``n_preview``
    close-ups ``bench.py`` integrates while it times the preview wire,
    integrated without it; then a fresh extractor's full refresh after a
    throwaway one."""
    vol, tcfg, dev = _need(b.vol, "the fused volume"), b.cfg.tsdf, b.dev
    mcells, mtris, _ = fitted_budgets(vol, tcfg)
    batch = tk.make_fused_batch_fn(b.intr, tcfg, worklist_size, stride)
    n_close = n_warm + n_timed
    cdep, ccol, cpos = render_all(b.cam, [closeup_pose(i) for i in range(n_close)], dev)
    inc = IncrementalExtractor(tcfg, max_cells=mcells, max_tris=mtris)
    inc.update(vol)
    for i in range(n_warm):
        vol = batch(vol, cdep[i:i + 1], ccol[i:i + 1], cpos[i:i + 1], b.rays)
        inc.update(vol)
    times, touched, pulled = [], [], []
    for i in range(n_warm, n_close):
        vol = batch(vol, cdep[i:i + 1], ccol[i:i + 1], cpos[i:i + 1], b.rays)
        _sync(dev)
        t0 = time.perf_counter()
        inc.update(vol)
        times.append(time.perf_counter() - t0)
        touched.append(inc.last_touched)
        pulled.append(inc.last_pull_bytes)
    cdep, ccol, cpos = render_all(
        b.cam, [closeup_pose(i) for i in range(n_close, n_close + n_preview)], dev)
    vol = b.vol = batch(vol, cdep, ccol, cpos, b.rays)
    expect[tk.KERNEL] += n_close + n_preview
    del inc, cdep, ccol, cpos
    IncrementalExtractor(tcfg, max_cells=mcells, max_tris=mtris).update(vol)
    inc2 = IncrementalExtractor(tcfg, max_cells=mcells, max_tris=mtris)
    _sync(dev)
    t0 = time.perf_counter()
    inc2.update(vol)
    full_ms = (time.perf_counter() - t0) * 1000.0
    return {"extract_incremental_ms": round(float(np.median(times)) * 1000.0, 2),
            "incremental_pull_bytes_exact": int(np.median(pulled)),
            "incremental_touched_blocks": int(np.median(touched)),
            "extract_full_refresh_ms": round(full_ms, 2)}


def compact_section(b: Inputs, expect, reps: int = 3) -> dict:
    """``bench.py:409-424``: ``tsdf.streaming._compact`` of the fused
    volume with the identity permutation over its alive prefix, min of
    ``reps``."""
    vol, dev = _need(b.vol, "the fused volume"), b.dev
    nb_now = int(vol.n_blocks)
    perm = np.arange(vol.tsdf.shape[0], dtype=np.int32)
    _compact(vol, perm, nb_now)
    _sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _compact(vol, perm, nb_now)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return {"evict_compact_ms": round(min(times) * 1000.0, 2)}


def bench_rig() -> np.ndarray:
    """``bench.py:443-447``: camera 1 35 cm left of camera 0, toed in
    0.26 rad."""
    rig = np.eye(4)
    a = 0.26
    rig[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    rig[:3, 3] = [-0.35, 0.0, 0.05]
    return rig


# extrinsics (se3 log of camera 1's frame into camera 0's) that the two-camera
# auto-calibration accepted on this rig at quarter resolution while its only
# gate was the overlap, with their scenes: 0.420 m / 0.351 rad, 0.401 m /
# 0.289 rad and a slide of 0.087 m / 0.002 rad along the wall and floor off
# the truth. The free-space gate must reject each.
BENCH_RIG_WRONG_XI = {
    "off_0.42m": ("default", (0.06687, -0.00057, -0.00319, -0.00043, -0.09111, 0.00004)),
    "off_0.40m": ("cluttered", (0.04738, 0.00003, -0.00226, -0.00024, -0.02864, -0.00029)),
    "slide_0.087m": ("cluttered", (-0.26811, 0.00006, 0.01571, -0.0002, 0.25845, -0.00067)),
}


def dual_section(b: Inputs, expect, n_pairs: int = 24, n_moving: int = 24,
                 n_warm: int = 2) -> dict:
    """``bench.py:426-515``: ``DualCameraFusion`` at the bench rig's known
    extrinsics, the static pair (``n_warm`` pairs, then ``n_pairs`` timed,
    one sync) and the rig moving along the sweep (a run that must allocate
    fresh blocks throughout, then a timed run); B1 twice a pair."""
    dev, intr = b.dev, b.intr
    rig = bench_rig()
    raw = lambda z, c: tuple(upload(a, dev) for a in _quantize(z, c))
    dual = DualCameraFusion((intr, intr), b.cfg, device=dev, output_dir=b.out_dir)
    T_cam0 = b.sweep[0]
    T_cam1 = T_cam0 @ rig
    dual.extrinsics = [T_cam0, T_cam1]
    dual.calibrated = True
    pair = (raw(*b.cam.render(T_cam0)), raw(*b.cam.render(T_cam1)))
    _sync(dev)
    for _ in range(n_warm):
        dual.process_frames(pair)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_pairs):
        dual.process_frames(pair)
    _sync(dev)
    pair_fps = n_pairs / (time.perf_counter() - t0)
    del dual, pair

    mv_pairs = []
    for k in range(n_moving):
        T0k = b.sweep[k]
        T1k = T0k @ rig
        mv_pairs.append(((raw(*b.cam.render(T0k)), raw(*b.cam.render(T1k))), T0k, T1k))
    _sync(dev)

    def moving_run(growth_check=False):
        dmv = DualCameraFusion((intr, intr), b.cfg, device=dev, output_dir=b.out_dir)
        dmv.calibrated = True
        nb_half = 0
        t0 = time.perf_counter()
        for j, (pair_k, T0k, T1k) in enumerate(mv_pairs):
            dmv.extrinsics = [T0k, T1k]
            dmv.process_frames(pair_k)
            if growth_check and j == n_moving // 2:
                nb_half = int(dmv.volume.n_blocks)
        _sync(dev)
        dt = time.perf_counter() - t0
        if growth_check:
            n_end = int(dmv.volume.n_blocks)
            _check(0 < nb_half < n_end, "moving rig must allocate fresh blocks throughout "
                                        f"(n_blocks {nb_half} at pair {n_moving // 2}, {n_end} "
                                        "at the end)")
        return dt

    moving_run(growth_check=True)
    mv_dt = moving_run()
    expect[tk.KERNEL] += 2 * (n_warm + n_pairs + 2 * n_moving)
    return {"dual_fusion_pair_fps": round(pair_fps, 2),
            "dual_fusion_fps_per_camera": round(pair_fps, 2),
            "dual_fusion_pair_fps_moving": round(n_moving / mv_dt, 2)}


def recorder_section(b: Inputs, expect, n_warm: int = 12, n_rec: int = 30,
                     keyframe_interval: int = 10, reps: int = 3) -> dict:
    """``bench.py:517-563``: the recorder over ``n_rec`` resident sweep
    frames at a keyframe every ``keyframe_interval`` (after a warm recorder
    over ``n_warm``), then one keyframe step and one interval step,
    synchronized, min of ``reps`` each."""
    dev = b.dev
    frames = _need(b.dev_frames, "the resident frames of section pipeline")
    rcfg = dataclasses.replace(b.cfg, keyframe_interval=keyframe_interval)
    rec = Recorder(b.intr, rcfg, device=dev, output_dir=b.out_dir)
    rec.toggle_recording()
    for d, c in frames[:n_warm]:
        rec.process_frame(d, c)
    _sync(dev)
    rec2 = Recorder(b.intr, rcfg, device=dev, output_dir=b.out_dir)
    rec2.toggle_recording()
    t0 = time.perf_counter()
    for d, c in frames[:n_rec]:
        rec2.process_frame(d, c)
    _sync(dev)
    recorder_fps = n_rec / (time.perf_counter() - t0)
    cam = b.cfg.camera
    scal = (1.0 / cam.depth_scale, cam.depth_min, cam.depth_trunc)
    st = {"v": rec2.volume, "m": rec2._maps, "T": rec2._T, "W": rec2._W_prev_kf}
    kf_times, int_times = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        st["v"], T_, _, *m_ = rec2._kf_step(st["v"], st["T"], st["W"], *st["m"], *frames[0],
                                            rec2.rays, *scal)
        _sync(dev)
        kf_times.append(time.perf_counter() - t0)
        st["m"], st["W"], st["T"] = tuple(m_), st["T"], T_
        t0 = time.perf_counter()
        st["v"] = rec2._int_step(st["v"], st["T"], *frames[1], rec2.rays, *scal)
        _sync(dev)
        int_times.append(time.perf_counter() - t0)
    expect[tk.KERNEL] += n_warm + n_rec + 2 * reps
    return {"recorder_fps": round(recorder_fps, 2),
            "recorder_keyframe_ms": round(min(kf_times) * 1000.0, 2),
            "recorder_interval_ms": round(min(int_times) * 1000.0, 2)}


def corridor_scene() -> Scene:
    """``bench.py:587-593``: a checkered wall 0.55 m ahead and 33 spheres
    along +x."""
    return Scene(
        planes=(Plane((0.0, 0.0, 0.55), (0.0, 0.0, -1.0), (0.7, 0.65, 0.6), checker=0.1),),
        spheres=tuple(Sphere((0.3 * k, 0.1 * (-1) ** k, 0.5), 0.05,
                             (0.3 + 0.5 * (k % 2), 0.4, 0.8 - 0.5 * (k % 2))) for k in range(33)))


def streaming_section(b: Inputs, expect, n_quarter: int = 240, step_quarter: float = 0.04,
                      margin_quarter: float = 0.3, n_full: int = 120, step_full: float = 0.045,
                      margin_full: float = 0.4, pool: int = 1024, hash_slots: int = 8192,
                      plain_pool: int = 4096, plain_hash_slots: int = 16384,
                      depth_trunc: float = 0.7, check_interval: int = 8,
                      high_water: float = 0.85, worklist_size: int = WORKLIST) -> dict:
    """``bench.py:565-682``: the corridor scan, longer than a ``pool``-block
    pool holds, at a quarter of the resolution (``n_quarter`` frames every
    ``step_quarter`` m) streamed and into a ``plain_pool``-block pool that
    holds it all (the plain pool must not overflow), then at the full
    resolution (``n_full`` frames, streamed; it must not overflow), each
    run warm and then timed, one sync at the end; the tick ms per stage."""
    dev = b.dev
    scfg = dataclasses.replace(
        b.cfg, tsdf=dataclasses.replace(b.cfg.tsdf, block_capacity=pool, hash_capacity=hash_slots),
        camera=dataclasses.replace(b.cfg.camera, depth_trunc=depth_trunc))
    scene = corridor_scene()

    def frames(intr, n, step):
        cam = SyntheticCamera(scene=scene, intrinsics=intr, device=dev)
        out = []
        for i in range(n):
            T = np.eye(4)
            T[0, 3] = step * i
            out.append(tuple(upload(a, dev) for a in _quantize(*cam.render(T))))
        _sync(dev)
        return out

    def corridor_run(intr, cfg_run, fr, streaming):
        p = MonoOdometryTSDF(intr, cfg_run, device=dev, worklist_size=worklist_size,
                             streaming=streaming)
        t0 = time.perf_counter()
        for d, c in fr:
            p.process_frame(d, c)
        _sync(dev)
        return p, time.perf_counter() - t0

    manager = lambda margin: StreamingTSDF.for_pipeline(scfg, high_water=high_water,
                                                        check_interval=check_interval,
                                                        margin=margin, device=dev)
    intr_q = b.intr.scaled(0.25)
    fr_q = frames(intr_q, n_quarter, step_quarter)
    corridor_run(intr_q, scfg, fr_q, manager(margin_quarter))
    sp, s_dt = corridor_run(intr_q, scfg, fr_q, manager(margin_quarter))
    n_ticks = max(sp.streaming.n_ticks, 1)
    tick_ms = {k: round(v / n_ticks, 2)
               for k, v in sorted(sp.streaming.tick_ms.items(), key=lambda kv: -kv[1])}
    evictions, overflow = int(sp.streaming.n_evictions), bool(sp.volume.overflow)
    del sp
    pcfg_big = dataclasses.replace(scfg, tsdf=dataclasses.replace(
        scfg.tsdf, block_capacity=plain_pool, hash_capacity=plain_hash_slots))
    corridor_run(intr_q, pcfg_big, fr_q, None)
    pp, p_dt = corridor_run(intr_q, pcfg_big, fr_q, None)
    _check(not bool(pp.volume.overflow), "plain comparator pool must hold the whole corridor")
    del pp, fr_q
    gc.collect()

    fr_f = frames(b.intr, n_full, step_full)
    corridor_run(b.intr, scfg, fr_f, manager(margin_full))
    sfp, sf_dt = corridor_run(b.intr, scfg, fr_f, manager(margin_full))
    _check(not bool(sfp.volume.overflow), "full-res streaming corridor must not overflow")
    full_evictions = int(sfp.streaming.n_evictions)
    del sfp, fr_f
    gc.collect()
    expect[tk.KERNEL] += 4 * n_quarter + 2 * n_full
    expect[odo.KERNEL] += 4 * (n_quarter - 1) + 2 * (n_full - 1)
    s_fps, p_fps = n_quarter / s_dt, n_quarter / p_dt
    return {"streaming_fps": round(s_fps, 2), "streaming_n_evictions": evictions,
            "streaming_overflow": overflow, "corridor_plain_fps": round(p_fps, 2),
            "streaming_vs_plain": round(s_fps / p_fps, 3), "streaming_tick_ms": tick_ms,
            "streaming_fullres_fps": round(n_full / sf_dt, 2),
            "streaming_fullres_evictions": full_evictions}


def relocalize_section(b: Inputs, expect, pose: int = 8, attempts: int = 2) -> dict:
    """``bench.py:684-706``: ``Relocalizer.warmup`` against the fused
    volume, then ``attempts`` attempts for sweep pose ``pose`` from the
    stale hint of pose 0 (the min of their ms; the recovered position's
    error, -1 without a recovery). Drops the fused volume after, as
    ``bench.py`` does, and leaves the relocalizer in ``b.reloc``."""
    vol = _need(b.vol, "the fused volume")
    reloc = Relocalizer(b.intr, b.cfg, device=b.dev, rays=b.rays)
    warmup_s = reloc.warmup(vol)
    times, T_rec = [], None
    for _ in range(attempts):
        t0 = time.perf_counter()
        T_try = reloc.attempt(vol, b.depths[pose], b.colors[pose], T_hint=b.sweep[0])
        times.append(time.perf_counter() - t0)
        T_rec = T_try if T_try is not None else T_rec
    err_mm = (float(np.linalg.norm(np.asarray(T_rec)[:3, 3] - b.sweep[pose][:3, 3])) * 1000.0
              if T_rec is not None else -1.0)
    b.reloc, b.vol = reloc, None
    gc.collect()
    return {"reloc_warmup_s": round(warmup_s, 2),
            "reloc_recovery_ms": round(min(times) * 1000.0, 1), "reloc_err_mm": round(err_mm, 2)}


def frame_to_model_section(b: Inputs, expect, refine_interval: int = 5, passes: int = 2,
                           worklist_size: int = WORKLIST) -> dict:
    """``bench.py:708-738``: ``MonoOdometryTSDF(tracking="frame_to_model")``
    over the resident frames, a warm pass then the best of ``passes``;
    the refinements the last pass accepted."""
    dev = b.dev
    frames = _need(b.dev_frames, "the resident frames of section pipeline")
    pipe = MonoOdometryTSDF(b.intr, b.cfg, device=dev, worklist_size=worklist_size,
                            tracking="frame_to_model", model_refine_interval=refine_interval)
    for d, c in frames:
        pipe.process_frame(d, c)
    _sync(dev)
    times = []
    for _ in range(passes):
        pipe.reset()
        t0 = time.perf_counter()
        for d, c in frames:
            pipe.process_frame(d, c)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    expect[tk.KERNEL] += (1 + passes) * len(frames)
    expect[odo.KERNEL] += (1 + passes) * (len(frames) - 1)
    return {"f2m_fps": round(len(frames) / min(times), 2),
            "f2m_refines_ok": int(pipe.counts.get("model_icp_ok", 0))}


def offline_section(b: Inputs, expect, warm_frames: int = 16) -> dict:
    """``bench.py:740-786``: ``OfflineBundle`` logs the host frames, the
    reintegration batch is warmed on ``warm_frames`` copies of the first,
    then ``finalize(extract=False)``: its reintegration rate and stage
    times."""
    dev, tcfg = b.dev, b.cfg.tsdf
    host = _need(b.host_frames, "the host frames of section pipeline")
    ob = OfflineBundle(b.intr, b.cfg, device=dev, output_dir=tempfile.mkdtemp(dir=b.out_dir),
                       checkpoint_interval=0)
    for d, c in host:
        ob.process_frame(d, c)
    cam = b.cfg.camera
    wbf = make_raw_batch_fn(b.intr, tcfg)
    wd = torch.stack([upload(host[0][0], dev)] * warm_frames)
    wc = torch.stack([upload(host[0][1], dev)] * warm_frames)
    wT = torch.eye(4, dtype=torch.float32, device=dev).expand(warm_frames, 4, 4)
    wbf(tsdf.create(tcfg, dev), wd, wc, wT, b.rays, 1.0 / cam.depth_scale, cam.depth_min,
        cam.depth_trunc)
    _sync(dev)
    del wd, wc, wT
    ob.finalize(extract=False)
    st = ob.last_finalize_stats
    expect[tk.KERNEL] += warm_frames + len(host)
    return {"offline_reintegrate_fps": round(st["n_frames"] / max(st["reintegrate_s"], 1e-9), 2),
            "offline_optimize_s": round(st["optimize_s"], 2),
            "offline_finalize_s": round(st["loops_s"] + st["optimize_s"] + st["reintegrate_s"],
                                        2)}


def cloud_section(b: Inputs, expect, n_kf: int = 8, n_warm: int = 2) -> dict:
    """``bench.py:788-811``: ``CloudAccumulator`` with every frame a
    keyframe: a warm accumulator over ``n_warm`` host frames, then
    ``n_kf`` keyframes timed."""
    host = _need(b.host_frames, "the host frames of section pipeline")
    ca_cfg = dataclasses.replace(b.cfg, keyframe_interval=1)
    ca = CloudAccumulator(b.intr, ca_cfg, device=b.dev, output_dir=b.out_dir)
    for d, c in host[:n_warm]:
        ca.process_frame(d, c)
    ca2 = CloudAccumulator(b.intr, ca_cfg, device=b.dev, output_dir=b.out_dir)
    t0 = time.perf_counter()
    for d, c in host[:n_kf]:
        ca2.process_frame(d, c)
    _sync(b.dev)
    return {"cloud_accumulator_kf_fps": round(n_kf / (time.perf_counter() - t0), 2)}


_CACHED_WARMUP = """\
import json, sys, time
t_imp = time.perf_counter()
from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
from azurekinect3dreconstruction_tpu_torch.tracking.relocalize import Relocalizer
intr, tsdf_cfg, dev = json.loads(sys.argv[1])
r = Relocalizer(Intrinsics(*intr), PipelineConfig(tsdf=TSDFConfig(**tsdf_cfg)), device=dev)
w = r.warmup()
print(json.dumps({"import_s": time.perf_counter() - t_imp - w, "warmup_s": w,
                  "build_s": build.build_seconds}))
"""


def cached_warmup_section(b: Inputs, expect, timeout: float = 900.0) -> dict:
    """``bench.py:813-850``: the warmup a second process pays. This
    process warms its relocalizer on the scratch volume once (untimed; B1
    once), so the kernel library is built; a fresh Python process then
    imports the port and runs ``Relocalizer(...).warmup()``, loading the
    library from ``build/`` (on a card it must not rebuild it)."""
    reloc = b.reloc or Relocalizer(b.intr, b.cfg, device=b.dev, rays=b.rays)
    reloc.warmup()
    expect[tk.KERNEL] += 1
    arg = json.dumps([dataclasses.astuple(b.intr), dataclasses.asdict(b.cfg.tsdf), str(b.dev)])
    sub = subprocess.run([sys.executable, "-c", _CACHED_WARMUP, arg], capture_output=True,
                         text=True, timeout=timeout, cwd=REPO)
    if sub.returncode != 0:
        raise RuntimeError(f"the warmup process exited {sub.returncode}: {sub.stderr[-2000:]}")
    res = json.loads(sub.stdout.strip().splitlines()[-1])
    _log(f"[bench] second process: import {res['import_s']:.2f} s, warmup {res['warmup_s']:.2f} s, "
         f"kernel build {res['build_s']:.2f} s")
    _check(b.dev.type != "cuda" or res["build_s"] == 0.0,
           f"the second process rebuilt the kernel library ({res['build_s']:.1f} s)")
    return {"reloc_warmup_cached_s": round(float(res["warmup_s"]), 2)}


# -- the run ------------------------------------------------------------------------------


def launch_counts() -> dict:
    return {k: build.launches[k] for k in KERNELS}


def run_sections(b: Inputs, sections=None):
    """Run ``sections`` (default :data:`SECTIONS`) in order: (the keys,
    ``{section: message}`` of the sections that raised). A section that
    raises leaves its keys ``None`` and the next one runs. Each section's
    function is looked up by name when it runs (``<name>_section`` in this
    module). Progress marks and each section's launches beside its
    expected count go to stderr."""
    t_start = time.perf_counter()
    values, errors = {}, {}
    this = sys.modules[__name__]
    for name, keys in this.SECTIONS if sections is None else sections:
        _log(f"[bench {time.perf_counter() - t_start:7.1f}s] {name}")
        expect = collections.Counter({k: 0 for k in KERNELS})
        before = launch_counts()
        try:
            out = getattr(this, f"{name}_section")(b, expect)
            if set(out) != set(keys):
                raise RuntimeError(f"returned keys {sorted(out)}, not {sorted(keys)}")
            values.update(out)
        except Exception as e:  # noqa: BLE001 -- one section's failure must not lose the line
            traceback.print_exc(file=sys.stderr)
            errors[name] = f"{type(e).__name__}: {e}"
            values.update(dict.fromkeys(keys))
        after = launch_counts()
        _log("[bench launches] " + json.dumps({
            "section": name, "launches": {k: after[k] - before[k] for k in KERNELS},
            "expected": dict(expect), "ok": name not in errors}))
    _log(f"[bench {time.perf_counter() - t_start:7.1f}s] done")
    return values, errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels; raises without a card) or cpu "
                         "(their plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = gpu_line() if dev.type == "cuda" else "cpu"
    _log(f"[bench] device {device}; torch {torch.__version__}")
    with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(sys.stderr):
        b = make_inputs(dev, out)
        values, errors = run_sections(b)
        del b
    _log(f"[bench] {', '.join(PREVIEW_KEYS)}: null; they time the incremental extractor's "
         "wire='preview' encoding, which the port does not have")
    line = {k: values.get(k) for k in KEYS}
    line["device"] = device
    line["errors"] = errors
    print(json.dumps(line), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
