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
   times the phases of one frame-to-model frame, its refinement's CUDA
   graph (built as the step builds it) equal to the same chain op by op to
   the bit;
6. drives two-camera fusion, ``DualCameraFusion(..., device="cuda")``:
   auto-calibrates the rig of ``tests/test_pipelines.py`` (within 2 cm /
   0.03 rad of the truth) and times its stages; auto-calibrates the bench's
   rig in the default and the cluttered scene from 2 RANSAC seeds each at
   640x576, and from one seed at relative depth noise 0.01, and the test
   rig there, every one accepted within 2 cm / 0.03 rad, with its
   free-space shares and stage times, and rejects a calibration whose
   refinements are scripted to a wrong pose, in full and on the R key;
   fuses the bench's rig (camera 1 35 cm left, toed in 0.26 rad) with its
   extrinsics set by hand, the static pair 24 times and the moving rig over the first 24
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
   ``tests/test_pipelines.py`` must be rebased through the fallback ladder,
   and the ladder must land on it again from each of 4 fresh seeds;
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
   0.3), each timed (``--streaming`` warms each first; here the phases
   before have warmed the card) with the counters zeroed just before and
   read just after, and the same frames into a plain 4,096-block pool:
   no overflow, evictions, B1 exactly once a frame and B2 once a tracked
   frame, the trajectory and the sorted ``extract_mesh`` soup equal to the
   plain pass's to the bit, the point cloud's rows equal; frames/s of both,
   tick ms by stage, the host store's bytes; then the revisit, each pass
   against a plain pool to the bit and held to reload only blocks it
   evicted, no key live and stored, every stored block beyond the reload
   ring at the last tick, the host store losing each batch's bytes with
   its last row: the 640x576 run out and back (119 frames back) through the
   live loop; the quarter-resolution run out and back at the true poses
   through the manager, and its first 60 frames out and back through the
   live loop in a 768-block pool; the thrash at the true poses (3 swings
   across the reload / evict band, a block through 3 evict -> reload
   cycles); a loss on the 640x576 way back (6 dark frames, declared once,
   nothing fused while latched, recovered by the hint rung within 6 cm /
   0.12 rad), and again with the relocalizer's first attempt 2 frames
   after the resumed pose (ROADMAP C15: at most one recovery, within the
   bounds, nothing fused before it); frame-to-model on the short quarter
   revisit (ATE <= 2 cm, streamed and plain, their trajectories and sorted
   soups equal to the bit); a reload into a full pool (deferred, then
   restored to the bit) and a batch reloaded behind a busy stream; each
   pass's frames/s, tick ms by stage, ``_scatter_reload``'s ms by CUDA
   events, one whole batch's copy, deferred reloads and the trajectory
   against the truth; one open fault is run and printed without failing
   the run (ROADMAP C16: the whole quarter-resolution run out and back
   through the live loop, its deferrals and soup); then
   ``python -m azurekinect3dreconstruction_tpu_torch.cli.live_mono --source
   synthetic --frames 24 --streaming`` in a subprocess must save a mesh, a
   cloud and a trajectory;
14. drives the sharded volume (``parallel.sharded_volume``): the JAX
   bench's cell, ``make_sharded_slam_batch`` on a 1 x 1 mesh over the 16
   mono frames (the trajectory equal to the mono loop's, B1 and B2 15
   each, ``sharded_slam_fps`` by ``bench.py``'s method); a 2 x 2 grid on
   ``[cuda:0] * 4`` with two mounts tracking 16 frames each (B2 30, B1 60,
   poses against ``compute_odometry_fast`` chains, disjoint shards, the
   combined mesh against a single volume's, 2 steps against a CPU grid by
   block key); ``DualCameraFusion(sharded=True, devices=[cuda:0] * 4)``
   over 8 bench-rig pairs beside the unsharded pipeline (B1 4 a pair,
   ms/pair, the meshes, the save read back), each with the counters zeroed
   just before and read just after; then ``cli.dual_fusion --sharded`` in a
   subprocess must save a mesh and a cloud;
15. drives the device-resident step and batches and the frame feeder by
   the JAX bench's methods (``device_step_phase``): ``make_fused_batch_fn``
   over the 64-pose sweep (``bench.py:67-121``: a 32-frame warmup on its
   own trajectory, the sweep cold in two 32-frame batches with
   ``n_blocks`` growing between them, B1 exactly 64 a pass, the volume
   equal by key to 64 ``integrate_step`` calls to the bit,
   ``fused_cold_fps`` from the min of 3 cold passes, ``fused_steady_fps``
   from the warm repass slope); ``make_device_slam_batch``
   (``bench.py:165-221``: the 16-frame batch, B2 and B1 15 each, min fit
   > 0.3, ``slam_batch_fps`` by the (3 - 1) / 30 slope; on the mono loop's
   decoded frames its poses equal to the mono loop's and to a 1 x 1
   ``make_sharded_slam_batch``'s to the bit; ``slam_ate`` / ``slam_rpe``
   over the sweep, ATE <= 2 cm); ``MonoOdometryTSDF`` over 32 quantized
   sweep frames through ``io.streams.prefetch_to_device`` with one sync
   (``bench.py:259-290``: ``pipeline_fps``, the trajectory equal to the
   unfed loop's to the bit, B1 32 and B2 31, ``h2d_mbps``, the fed loop's
   device idle share and the share of its copy time under a kernel from
   ``torch.profiler``; with torch's sync-debug mode at "warn", no
   synchronizing call after the fed loop's first frame, the feeder's own
   included, and its staging-ring reuse waits, which are event waits,
   counted apart), each with the counters zeroed
   just before and read just after;
16. drives the live session (``serve_phase``): ``cli.live_mono``'s loop
   (``LiveSession``) over the 32 quantized sweep frames, headless and then
   served by a ``BrowserLiveViewer`` on 127.0.0.1 with a thread polling
   ``/meta.json`` and fetching ``/geometry.bin`` as the page does, ``M`` at
   frame 11 and ``S`` at frame 21 sent over HTTP before the loop has
   synchronized with the frame's work (none of its calls synchronized; the
   log says whether the card's stream still had work pending), the counters
   zeroed just before and read just after: B1 32, B2 31, the trajectory
   equal to the headless loop's to the bit, each key acting at that frame's
   tick, the served mesh (frame 30) and cloud (frame 10)
   equal to the volume's ``extract_mesh`` / ``extract_point_cloud`` and
   their ``geometry.bin`` to their pack, the status line, the save (mesh,
   cloud, trajectory, a PNG preview) read back, the native PLY writers'
   bytes against the Python writers'; then ms/frame headless and served in
   both display modes in turns (median of 2; the page thread polls and
   fetches through every served turn and is stopped for the headless ones),
   the vis frames' stage ms and the synchronizing calls by frame;
17. drives the checkerboard route for a rig (``rig_calib_phase``):
   ``cli.calibrate_rig --source synthetic --views 8`` on the host, within
   4 cm / 3 deg of the truth, then ``cli.dual_fusion --rig-calib`` over 8
   pairs with the counters zeroed just before and read just after: the
   calibration loaded, no auto-calibration attempt, B1 16, no overflow;
18. drives the live camera's path (``aligned_phase``): the color-aligned
   frames that ``--source k4a`` and ``mkv:`` feed, made from the bench
   sweep (640x576 depth through ``transformed_depth`` with the nominal
   32 mm baseline into the 1280x720 color camera, u16 mm; color rendered
   at 1280x720 from the color camera's pose; the color intrinsics):
   ``transformed_depth`` on the card equal to the CPU's to the bit; the
   unique block keys a frame against allocate's 2,048 dedup budget and the
   largest ``n_active`` at the true poses beside the worklist a caller of
   the JAX class would pass (the first of the JAX package's
   ``WORKLIST_SIZES`` that holds it) and the port's default, the whole
   pool; B1 on one frame equal to its plain version to the bit and B2 on
   one pair within its tolerances and equal to itself on a second launch,
   with the instance B2 took, each kernel's device us, wrapper and plain
   ms and bound; frame to frame over 64 poses and frame to model over 32
   (``f2m_phase``) at the default worklist, the counters zeroed just
   before and read just after each: no gate rejection, no overflow, ATE
   <= 20 mm against the color camera's truth (frame to model also <= frame
   to frame + 0.5 mm), B1 once a frame, B2 once a pair, ms/frame beside
   33.3 ms; the mesh with no overflow; then ``cli.live_mono --source
   replay:DIR --voxel 0.005`` on a log of the 64 frames whose calibration
   gives depth and color the color intrinsics: exit 0, every frame
   tracked, the mesh written, ATE <= 20 mm, and no overflow although the
   largest ``n_active`` exceeds the JAX class's 2,048 (ROADMAP C18,
   repaired: the default worklist is the whole pool; printed as ``C18
   (repaired): ...``);
19. drives the live camera's other paths on its color-aligned frames
   (``aligned_paths``; ``AlignedCamera`` renders a unit's depth camera,
   ``transformed_depth`` into its color camera): the two-camera rig at
   1280x720 (``aligned_dual_phase``; camera 1's color intrinsics 6 px / -4
   px off camera 0's in fx / cx): ``DualCameraFusion.calibrate`` on the
   bench rig in both scenes and the test rig, from RANSAC seeds 0-3 at
   relative depth noise 0 and 0.01, each within 2 cm / 0.03 rad with its
   scores and stage ms; then ``dual_fusion_checks`` at the bench rig with
   5 mm voxels: 24 static and 24 moving pairs, B1 twice a pair, ms/pair
   beside 33.3 ms, the pair's phase ms, 2 pairs against a CPU pipeline by
   block key, the save, and B1 on camera 1's frame against its plain
   version; the recorder at 1280x720 (``recorder_phase`` over 32 aligned
   frames, the keyframe jump and its ladder rendered aligned); relocalization
   at 1280x720 (``reloc_phase`` on the aligned sweep at the default
   worklist); and one frame-to-frame pass at 1920x1080 (``hd_phase``, the
   1080p intrinsics, 16 frames: B1 and B2 against their plain versions, B2's
   level 0 on the large-frame route, B1 16 / B2 15, ATE <= 20 mm, no
   overflow, ms/frame beside 33.3 ms), and B2 on one color-aligned
   3840x2160 pair (``uhd_check``, the k4a's RES_2160P: levels 0 and 1 on the
   large-frame route) against its plain version with its device time and
   bound;
20. runs the port's ``bench.py`` (``bench_phase``): ``python -m
   azurekinect3dreconstruction_tpu_torch.cli.bench`` in a subprocess, at
   ``bench.py``'s sizes and by its methods, logging its JSON line and its
   stderr marks: exit code 0, every key of ``bench.py``'s line plus an empty
   ``"errors"``, the pool growing, no overflow, evictions in both corridors,
   ATE <= 20 mm, both least fitnesses > 0.3, the relocalized position
   within 50 mm, refinements accepted, and each of its 16 sections' kernel
   launches equal to the count the section expects.

After step 4 it times ``tsdf.streaming._compact`` over the main path's
volume (the identity permutation) beside its bound. Between steps 1 and 2
it holds B1 at R = 24 (a block resolution without an instance of its own)
against its plain version, B2 over a 5-level pyramid ([20, 10, 5, 5, 5],
and [0, 0, 0, 0, 5], where only the coarsest level moves the pose) against
its plain version at 640x576, B2's large-frame route forced on every level
against its shared route to the bit at 640x576 (and at 1280x720 in step
18), on 3 and 5 levels (``b2_route_check``), and runs one 1024x1024 (WFOV
unbinned) frame pair through ``compute_odometry_fast``: B2 (level 0 on the
large-frame route) against the plain version on the card, with its device
time and bound, and the same 5-level schedules there. Every B2 check
prints the route each level took.

Prints the card's name and power limit, the build time, the launch counts,
per-frame fitness, ATE/RPE, ms/frame, mesh, frame-to-model and two-camera
results and each later phase's, one JSON line of per-kernel results (with
each path's launches), and, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, on
any failure or when no CUDA device is available. Needs no jax.

    python3 chip_smoke.py --odometry

times only the odometry of the package beside the script: B2's device time
and launches per frame pair and the odometry phase (``compute_odometry_fast``
on the first frame pair), and the mono loop's ms/frame over the 16 frames;
then B2 on one frame pair at 640x576, at the color-aligned 1280x720,
1920x1080, 3840x2160 and 4096x3072, and at 1024x1024 WFOV: the route of
each level, B2's device us per launch (the median of ``ODO_ROUNDS``
profiler rounds), ``compute_odometry_fast``'s ms a call (synchronized,
median of ``ODO_REPS``), the pose's 12 floats, fitness and rmse as float32
hex, and level 0 alone on the route its plan gives it, forced onto the
large-frame route and forced there with nothing resident, each with ps
per valid pixel-iteration. The per-pair part needs the per-level plan
(``odometry_kernels.level_routes``). It prints the card's name and power
limit, a line a pair, then one JSON line. To compare a change with its
parent on one card, copy this script into an unpacked parent commit and
run both in one call: parent, change, change, parent; equal hex
means the same pose to the bit.

    python3 chip_smoke.py --integrate

does the same for B1 (TSDF integrate): its device time per launch on the
stated input (the third sweep frame into a 2-frame volume through
``integrate_worklist(..., worklist_size=2048)``), on the first frame's
whole-pool worklist (``integrate_frame``), and over the 16-frame mono loop
at the pipeline's default worklist, with the loop's ms/frame, the bound
and its bytes (null for a version without ``updated_voxels``).

    python3 chip_smoke.py --f2m

runs only frame-to-model tracking (``f2m_main``): step 5's frame-to-model
pass with its refinement's phase ms, then ``cli.bench``'s ``pipeline``
section and three times its ``frame_to_model`` section (``f2m_fps``); the
same in a parent checkout.

    python3 chip_smoke.py --calibration [--device cpu] [--scale 0.25]
        [--noise 0 0.01] [--seeds 0 1]

runs only the two-camera auto-calibration (``calibration_main``), on the
card unless ``--device cpu``: one JSON line a calibration of the test rig
and of the bench rig, then the free-space shares at the bench rig's truth
and at the poses an overlap-only gate accepted. Copied into a parent
checkout it measures the parent, as ``--odometry`` does.

    python3 chip_smoke.py --streaming [--device cpu] [--scale 0.25]

runs only host streaming's checks (``streaming_main``: step 13 without
the CLI subprocess), on the card unless ``--device cpu``, at both runs or
only the one at ``--scale``; the same in a parent checkout.

    python3 chip_smoke.py --aligned [--jump-draws N]

runs only steps 18 and 19 (``aligned_main``) on the card, the aligned
recorder's ladder from ``N`` fresh seeds (default ``JUMP_DRAWS``); one
JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import struct
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
# the bench rig's auto-calibration: RANSAC generator seeds in each scene at
# 640x576 (the point-to-plane candidate lands on the truth); then, from seed
# 0, relative depth noise on the bench rig, and the test rig at the largest;
# the scripted reject at quarter resolution, where the scripted pose clears
# the overlap gate. (The live camera's paths calibrate the same rigs on
# 1280x720 aligned frames from 4 seeds at 2 noises, ALIGNED_CALIB_*, where
# the colored fallback runs too; until then these ran 4 seeds at 640x576
# and at quarter resolution and 2 seeds at 2 noises.)
BENCH_CALIB_SEEDS = (0, 1)
BENCH_CALIB_SCALES = (1.0,)
BENCH_CALIB_NOISES = (0.01,)
BENCH_CALIB_NOISE_SEEDS = (0,)
BENCH_CALIB_REJECT_SCALE = 0.25
N_REC_FRAMES = 32
# tests/test_pipelines.py's keyframe jump and its bounds there (at its registration budgets)
JUMP_T_LIMIT_M = 0.06
JUMP_R_LIMIT_RAD = 0.08
# the fallback ladder again on the jump's pair, from this many fresh generator seeds (on
# the card every draw differs anyway: the downsample's and FPFH's sums are atomics)
JUMP_DRAWS = 8
# a ladder refinement this close to the jump's truth is in its basin (the draws land within 2 mm)
LADDER_TRUE_M, LADDER_TRUE_RAD = 0.005, 0.005
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
# the revisit: a run's frames out, then back over them in reverse to the first; 6 dark
# frames about 40 % of the way back in the loss run; the thrash at the quarter-resolution
# run's rings: out THRASH_OUT frames, then THRASH_SWINGS times back THRASH_BACK frames and
# out again
REVISIT_LOOP_SCALE = REVISIT_LOSS_SCALE = 1.0
REVISIT_THRASH_SCALE = REVISIT_F2M_SCALE = 0.25
# at quarter resolution the live loop's way back drifts off the way out (ROADMAP C16) and
# maps a second corridor, more than any pool under the plain one holds: there the whole run
# goes back at the true poses through the manager, and the live loop (frame to frame, and
# frame to model) revisits its first REVISIT_SHORT_OUT frames in a pool of
# REVISIT_SHORT_BLOCKS that evicts from REVISIT_SHORT_HIGH_WATER; the whole run through the
# live loop is only reported
REVISIT_SHORT_OUT, REVISIT_SHORT_BLOCKS, REVISIT_SHORT_HIGH_WATER = 60, 768, 0.75
N_REVISIT_DARK = 6
REVISIT_DARK_AT = 0.4
THRASH_OUT, THRASH_BACK, THRASH_SWINGS = 110, 50, 3
N_CLI_FRAMES = 24
# the sharded volume: the dual pipeline's pairs; the 1 x 1 batch's trajectory against the
# mono loop's (the same arithmetic: to the bit expected); the 2 x 2 grid's poses against
# compute_odometry_fast chains; tests/test_sharded_volume.py's share of rounded centroids
N_SHARDED_DUAL_PAIRS = 8
SHARDED_TRAJ_TOL = 1e-5
SHARDED_POSE_TOL = 1e-4
# (the unsharded dual step allocates and integrates camera 0 before camera 1 allocates, so
# where both cameras see a voxel of a block camera 1 allocated, the two pipelines mix their
# observations one apart: on the card at 640x576 the sharded dual mesh shares 0.99999 of the
# unsharded one's centroids, but only 0.992 in a CPU rehearsal at quarter resolution, which
# thus fails that check as well as the launch checks; the sharded order is held to the bit
# against a single volume fed in that order)
SHARDED_CENTROID_MIN = 0.999
# the device step and batches (bench.py's cells): its 64-pose sweep, the 16-frame SLAM
# batch, the 32 frames of the fed pipeline
N_SWEEP = 64
N_SLAM_BATCH = 16
N_FED = 32
# the live session served to a browser: the key sent over HTTP at each frame (frames
# that are not vis frames, so the loop has not synchronized with the frame's work when
# the key arrives), the turns of its ms/frame against headless
SERVE_KEY_FRAMES = {"M": 11, "S": 21}
SERVE_TURNS = 2
# the checkerboard rig calibration: tests/test_io_calib.py's bounds on its
# extrinsic; the pairs cli.dual_fusion --rig-calib then fuses
RIG_T_LIMIT_M = 0.04
RIG_R_LIMIT_DEG = 3.0
N_RIG_CALIB_PAIRS = 8
# the kernels at configurations beyond the main path's: B1 at a block resolution without an
# instance of its own, B2 over a 5-level pyramid: the main path's schedule with two more
# levels, and one in which only the coarsest level, the first past 4, moves the pose (the
# finer levels converge to one optimum whatever the coarse ones did)
B1_ODD_R = 24
# B1's largest shift-and-mask instance (32^3 voxels a block), held against its plain version
# beside B1_ODD_R
B1_WIDE_R = 32
B2_FIVE_LEVEL_SCHEDULES = ((20, 10, 5, 5, 5), (0, 0, 0, 0, 5))
# the port's bench.py (cli.bench): its time limit, and the bounds its line is held to
# (PERF.md section 2; rung 0's 5 cm for the recovered position)
BENCH_TIMEOUT_S = 900
BENCH_MIN_FITNESS = 0.3
BENCH_RELOC_ERR_LIMIT_MM = 50.0
# the live camera's color-aligned 1280x720 frames (aligned_phase): frame to frame over the
# bench sweep's 64 poses (and the entry point over them), frame to model over its first 32,
# into the bench's 5 mm pool; the JAX package's worklist ladder (ops/pallas/tsdf_kernels.py:
# 52), from which a caller takes the first size that holds a frame's live blocks; the live
# loop's limit (PERF.md section 2)
N_ALIGNED_F2F = 64
N_ALIGNED_F2M = 32
ALIGNED_BLOCKS = 16384
WORKLIST_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
JAX_WORKLIST_DEFAULT = 2048  # the JAX package's MonoOdometryTSDF (and the port's before C18)
FRAME_LIMIT_MS = 33.3
# the live camera's other paths on its color-aligned frames: the two-camera rig, camera 1's
# color intrinsics off camera 0's by a few pixels of 1280x720 (two factory units differ),
# calibrated from these RANSAC seeds at these relative depth noises and fused over the
# sweep; the 1080p pass (k4arecorder's default color resolution: 1.5 x the 720p intrinsics)
ALIGNED_CAM1_DFX, ALIGNED_CAM1_DCX = 6.0, -4.0
ALIGNED_CALIB_SEEDS = (0, 1, 2, 3)
ALIGNED_CALIB_NOISES = (0.0, 0.01)
N_ALIGNED_DUAL_PAIRS = 24
N_ALIGNED_DUAL_CPU_PAIRS = 2
HD_SCALE = 1.5
N_HD_FRAMES = 16
# the k4a's RES_2160P color mode (3840x2160: 3 x the 720p intrinsics), whose level 0 exceeds
# what the L2 holds beside its target planes; --odometry's device us per launch, the median of
# ODO_ROUNDS torch.profiler rounds of ODO_ROUND_CALLS calls each
UHD_SCALE = 3.0
ODO_ROUNDS = 5
ODO_ROUND_CALLS = 10


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
    """Device time per launch of the CUDA kernels whose name holds
    ``kernel``, from ``torch.profiler`` over ``reps`` calls after one
    warm-up: the time it recorded over the launches it saw, which may be
    fewer than were made; and those launches per call. (None, 0) when the
    profiler sees no device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    total, count = _profiled(lambda: [fn() for _ in range(reps)], kernel)
    return (total / count if total > 0 and count else None), count / reps


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
    per launch of its odometry kernel and its launches per call
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
    frame_ms = []
    t0 = time.perf_counter()
    for d, c in raw:
        pipe.process_frame(d, c)
        if each:
            _sync(pipe.device)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
    _sync(pipe.device)
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


def f2m_phase(intr, cfg, raw, gt, dev, gpu: str, worklist_size: int = 2048):
    """Frame-to-model tracking over ``raw`` beside frame-to-frame, checked
    against the ground truth ``gt``, then a phase breakdown of one frame:
    the refinement's CUDA graph, built as ``make_raw_f2m_step`` builds it,
    against the same chain op by op (held to it to the bit). Returns
    (failures, launch counts of the frame-to-model pass, phase ms, ms/frame
    with one sync)."""
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
    from azurekinect3dreconstruction_tpu_torch.tracking import icp
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import (
        GraphedICP,
        TargetMaps,
        icp_projective,
    )
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate, rpe

    n = len(raw)
    gt_np = [g.cpu().numpy().astype(np.float64) for g in gt]
    kw = dict(device=dev, worklist_size=worklist_size)
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
    a_m, r_m = ate(pm.trajectory[1:], gt_np), rpe(pm.trajectory[1:], gt_np)
    ev = pm.counts
    rejected = pm.odometry_failures
    overflow = bool(pm.volume.overflow)
    _log(f"frame_to_model launches: {json.dumps(counts)}  [{gpu}]")
    _log(f"frame_to_model over {n} frames: ATE rmse {a_m['rmse'] * 1e3:.3f} mm (max "
         f"{a_m['max'] * 1e3:.3f} mm, final drift {a_m['final_drift'] * 1e3:.3f} mm; RPE "
         f"{r_m['trans_rmse'] * 1e3:.3f} mm / {np.degrees(r_m['rot_rmse']):.4f} deg); "
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
    loop_ms = (time.perf_counter() - t0) * 1e3 / n
    _log(f"frame_to_model ms/frame (host clock, one sync after {n} frames): {loop_ms:.3f}  "
         f"[{gpu}]")

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
    refine = GraphedICP(intr, 10, dist_thr)  # as make_raw_f2m_step builds it
    # the same chain op by op (a version of the port without the held
    # directions runs the ICP alone, as its graph does)
    held = getattr(icp, "keep_held_directions", None)

    def refine_eager(maps, init):
        r = icp_projective(mp, mm, maps, intr, init=init, max_iters=10, dist_thr=dist_thr)
        if held is None:
            return r
        return r._replace(T=held(r.T, init, mp, mm, maps, intr, dist_thr, icp.F2M_HELD_RATIO))

    maps, init = TargetMaps.from_depth(d, pm.rays), se3.inverse(T_odo)
    got = refine(mp, mm, maps, init)  # the capture, outside the timing
    replay = refine(mp, mm, maps, init)
    want = refine_eager(maps, init)
    same = [bool(torch.equal(a, b)) for r in (got, replay) for a, b in zip(r, want)]
    _log(f"frame_to_model refinement: the CUDA graph equal to its chain op by op to the bit, "
         f"at the capture and a replay: {all(same)} ({int(want.inliers)} inliers)  [{gpu}]")
    if not all(same):
        failures.append("the frame-to-model refinement's CUDA graph differs from its chain op "
                        "by op")
    phases = {
        "decode": lambda: decode_raw_frame(up(raw[-1][0]), up(raw[-1][1]), *scal),
        "odometry": lambda: odo.compute_odometry_fast(prev[2], prev[0], inten, d, intr,
                                                      cfg.odometry),
        "gate": lambda: apply_odometry_gate(T_prev, res, pm.MIN_FITNESS),
        "icp_refine": lambda: refine(mp, mm, TargetMaps.from_depth(d, pm.rays),
                                     se3.inverse(T_odo)),
        "icp_refine_eager": lambda: refine_eager(TargetMaps.from_depth(d, pm.rays),
                                                 se3.inverse(T_odo)),
        "fuse": lambda: tk.integrate_step(vol, d, c, T_odo, pm.rays, intr, cfg.tsdf,
                                          worklist_size),
        "model_refresh": lambda: mc.extract_sampled_surface_model(
            pm.volume, cfg.tsdf, pm.model_points, pm._T, pm._model_reach(),
            sample_blocks=pm.model_sample_blocks),
    }
    times = {k: round(_median_ms(fn, dev), 4) for k, fn in phases.items()}
    _log(f"frame_to_model phase ms (synchronized after each, median of 5; icp_refine = the "
         f"CUDA-graph replay the step runs, icp_refine_eager = the same chain launched op by op; "
         f"fuse = allocate + worklist + B1): {json.dumps(times)}  [{gpu}]")
    return failures, counts, times, loop_ms


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


def calibration_runs(intr, cfg, dev, out_dir: str, rig, scenes, seeds, scale: float = 1.0,
                     noise: float = 0.0) -> list:
    """Auto-calibrations of a rig, camera 0 at the origin and camera 1 at
    ``rig``, through ``DualCameraFusion.process_frames`` on its first pair:
    in each ``io.synthetic.Scene`` named in ``scenes``, at ``scale`` of
    ``intr``, from each RANSAC generator seed in ``seeds``, with relative
    depth noise ``noise`` drawn from a generator seeded alike. Returns one
    record a calibration: accepted or not, the error against ``rig``
    (None when rejected), the scores (``calib_scores``), whether the
    colored fallback ran, the stage ms and the first pair's host ms
    (calibration + fuse). Uses only calls every version of the port has;
    a version without ``calib_scores`` gives none."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import Scene, SyntheticCamera
    from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import DualCameraFusion

    at = intr if scale == 1.0 else intr.scaled(scale)
    records = []
    for name in scenes:
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(seed) if noise else None
            cam = SyntheticCamera(scene=getattr(Scene, name)(), intrinsics=at,
                                  depth_noise=noise, generator=gen, device=dev)
            pair = cam.capture(np.eye(4)), cam.capture(rig)
            p = DualCameraFusion((at, at), cfg, device=dev, output_dir=out_dir)
            p.generator = torch.Generator(device=dev).manual_seed(seed)
            t0 = time.perf_counter()
            p.process_frames(pair)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            err = None
            if p.calibrated:
                d = se3.se3_log(torch.as_tensor(np.linalg.inv(rig) @ p.extrinsics[1])).numpy()
                err = [float(np.linalg.norm(d[:3])), float(np.linalg.norm(d[3:]))]
            records.append({
                "size": f"{at.width}x{at.height}", "scene": name, "noise": noise, "seed": seed,
                "calibrated": p.calibrated, "err_m_rad": err,
                "scores": {k: round(float(v), 6) for k, v in getattr(p, "calib_scores",
                                                                     {}).items()},
                "colored_fallback": "colored_refine" in p.calib_stage_ms,
                "stage_ms": {k: round(v, 3) for k, v in p.calib_stage_ms.items()},
                "first_pair_ms": round(ms, 3)})
            del p
    return records


def bench_calibration(intr, cfg, dev, gpu: str, out_dir: str) -> list:
    """Auto-calibration of the bench rig (``cli.bench.bench_rig``: camera 1
    35 cm left of camera 0, toed in 0.26 rad) by ``calibration_runs`` in
    ``Scene.default()`` and ``Scene.cluttered()``: from each seed of
    ``BENCH_CALIB_SEEDS`` at each of ``BENCH_CALIB_SCALES`` of ``intr``, and
    from each of ``BENCH_CALIB_NOISE_SEEDS`` at each depth noise of
    ``BENCH_CALIB_NOISES``; then the test rig at the largest noise. Each must be accepted within 2 cm / 0.03 rad
    and is logged with its scores and stage ms. Then, at
    ``BENCH_CALIB_REJECT_SCALE``, every ICP refinement scripted to the pose
    ``cli.bench.BENCH_RIG_WRONG_XI["off_0.42m"]``: the first pair's
    calibration and the R key's refinement must both be rejected, the
    extrinsic left as it was. Returns failures."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.cli.bench import BENCH_RIG_WRONG_XI, bench_rig
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import Scene, SyntheticCamera
    from azurekinect3dreconstruction_tpu_torch.pipelines import dual_fusion as df
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import ICPResult

    failures = []
    rig = bench_rig()
    test_rig = se3.se3_exp(torch.tensor(CALIB_RIG_XI, dtype=torch.float64)).numpy()
    scenes = ("default", "cluttered")
    runs = [("bench rig", rig, scenes, BENCH_CALIB_SEEDS, s, 0.0) for s in BENCH_CALIB_SCALES]
    runs += [("bench rig", rig, scenes, BENCH_CALIB_NOISE_SEEDS, 1.0, n)
             for n in BENCH_CALIB_NOISES]
    runs += [("test rig", test_rig, ("default",), BENCH_CALIB_NOISE_SEEDS, 1.0,
              BENCH_CALIB_NOISES[-1])]
    for name, T, names, seeds, scale, noise in runs:
        for r in calibration_runs(intr, cfg, dev, out_dir, T, names, seeds, scale, noise):
            stages = r["stage_ms"]
            et, er = r["err_m_rad"] or (float("inf"),) * 2
            _log(f"dual calibration ({name}, {r['size']}, {r['scene']} scene, depth noise "
                 f"{noise}, seed {r['seed']}): calibrated {r['calibrated']}, extrinsic error "
                 f"{et * 1e3:.4f} mm / {er * 1e3:.4f} mrad; scores {json.dumps(r['scores'])}; "
                 f"colored fallback {r['colored_fallback']}; first pair "
                 f"{r['first_pair_ms']:.3f} ms (host clock, calibration + fuse); stage ms "
                 f"(synchronized after each): {json.dumps(stages)} (sum "
                 f"{sum(stages.values()):.3f})  [{gpu}]")
            if not (r["calibrated"] and et <= CALIB_T_LIMIT_M and er <= CALIB_R_LIMIT_RAD):
                failures.append(f"{name} calibration ({r['size']}, {r['scene']}, noise "
                                f"{noise}, seed {r['seed']}): calibrated {r['calibrated']}, "
                                f"{et:.4f} m / {er:.4f} rad")

    scale = BENCH_CALIB_REJECT_SCALE
    at = intr.scaled(scale)
    wrong = se3.se3_exp(torch.tensor(BENCH_RIG_WRONG_XI["off_0.42m"][1], dtype=torch.float64))
    d = se3.se3_log(torch.as_tensor(np.linalg.inv(rig) @ wrong.numpy())).numpy()
    wt, wr = float(np.linalg.norm(d[:3])), float(np.linalg.norm(d[3:]))
    scripted = lambda *a, **k: ICPResult(
        T=wrong.to(device=dev, dtype=torch.float32), fitness=torch.ones((), device=dev),
        inlier_rmse=torch.zeros((), device=dev),
        inliers=torch.ones((), dtype=torch.int32, device=dev))
    cam = SyntheticCamera(scene=Scene.default(), intrinsics=at, device=dev)
    saved = df.icp_point_to_plane, df.colored_icp
    df.icp_point_to_plane = df.colored_icp = scripted
    try:
        p = df.DualCameraFusion((at, at), cfg, device=dev, output_dir=out_dir)
        p.process_frames((cam.capture(np.eye(4)), cam.capture(rig)))
        full = (p.calibrated, p.extrinsics[1] is None, dict(p.calib_scores))
        p.extrinsics[1], p.calibrated = rig.copy(), True
        kept = not p.recalibrate() and np.array_equal(p.extrinsics[1], rig)
        counts = dict(p.counts)
    finally:
        df.icp_point_to_plane, df.colored_icp = saved
    _log(f"dual calibration scripted to the bench rig {wt:.3f} m / {wr:.3f} rad off "
         f"({scale} resolution): first pair calibrated {full[0]}, extrinsic left unset "
         f"{full[1]}, scores {json.dumps({k: round(float(v), 6) for k, v in full[2].items()})}"
         f"; R key rejected with the extrinsic kept {kept}; counts {json.dumps(counts)}  "
         f"[{gpu}]")
    if full[0] or not full[1] or not kept or counts != {"calib_reject": 2}:
        failures.append("the scripted wrong calibration was not rejected")
    return failures


def dual_phase(intr, cfg, dev, gpu: str, n_pairs: int = N_DUAL_PAIRS,
               cpu_pairs: int = N_DUAL_CPU_PAIRS):
    """Two-camera fusion, ``DualCameraFusion(..., device=dev)``: auto-
    calibration of the test rig with its stage times, then of the bench rig
    (``bench_calibration``); then ``dual_fusion_checks`` at the bench rig.
    Returns (failures, B1 launches of the moving-rig pass)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.cli.bench import bench_rig
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import DualCameraFusion

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

    failures += bench_calibration(intr, cfg, dev, gpu, tmp.name)

    fuse_failures, counts, _ = dual_fusion_checks((cam, cam), (intr, intr), cfg, bench_rig(),
                                                   dev, gpu, tmp.name, n_pairs, cpu_pairs)
    failures += fuse_failures
    tmp.cleanup()
    return failures, counts[tk.KERNEL]


def dual_fusion_checks(cams, intrs, cfg, rig, dev, gpu: str, out_dir: str, n_pairs: int,
                       cpu_pairs: int, what: str = "640x576"):
    """Two-camera fusion at ``rig`` (camera 1's pose in camera 0's frame)
    with the extrinsics set by hand, each camera ``cams[i]`` (its
    ``capture(T)`` the raw frames at pose ``T``) with its own intrinsics
    ``intrs[i]``: (a) the static pair and the moving rig over the sweep,
    synchronized per pair and with one sync at the end, beside the 33.3 ms
    limit, B1 twice a pair and B2 never; the phases of one moving pair; (b) the first
    ``cpu_pairs`` moving pairs on the card against a CPU pipeline, by block
    key; (c) the save, read back; (d) on a card, B1 on camera 1's third
    moving frame against its plain version (``b1_frame_check``, the whole
    pool's worklist). Returns (failures, launch counts of the moving-rig
    pass, B1's figures from (d) or None)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu_torch.core.device import upload
    from azurekinect3dreconstruction_tpu_torch.core.types import decode_raw_frame
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import DualCameraFusion
    from azurekinect3dreconstruction_tpu_torch.viz.savers import read_obj, read_ply

    failures = []
    ms_since = lambda t0: (time.perf_counter() - t0) * 1e3

    def pipeline(device=dev):
        p = DualCameraFusion(tuple(intrs), cfg, device=device, output_dir=out_dir)
        p.calibrated = True
        return p

    poses = orbit_trajectory(64, radius=0.35, angle_span=1.3)[:n_pairs]
    static = (cams[0].capture(poses[0]), cams[1].capture(poses[0] @ rig))
    moving = [((cams[0].capture(T), cams[1].capture(T @ rig)), T, T @ rig) for T in poses]
    ps = pipeline()
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

    pm = pipeline()
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
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    pm2 = pipeline()
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
    _log(f"dual launches on the moving-rig pass at {what}: {json.dumps(counts)} over {n_pairs} "
         f"pairs  [{gpu}]")
    _log(f"dual ms/pair at {what} (host clock; raw pairs uploaded from host memory; limit "
         f"{FRAME_LIMIT_MS} ms): static pair synchronized per pair median {med(per_pair):.3f} "
         f"(min {min(per_pair):.3f}, max {max(per_pair):.3f}), one sync after {n_pairs} "
         f"{static_one:.3f}; moving rig synchronized per pair median {med(mv):.3f} (min "
         f"{min(mv):.3f}, max {max(mv):.3f}), one sync after {n_pairs} {moving_one:.3f}; "
         f"n_blocks {json.dumps(n_blocks)} of {cfg.tsdf.block_capacity}, overflow {overflow}  "
         f"[{gpu}]")
    # phases of one moving pair, on a copy of the moving rig's volume
    cc = cfg.camera
    scal = (1.0 / cc.depth_scale, cc.depth_min, cc.depth_trunc)
    (pr, A, B) = moving[-1]
    raw = [(upload(d, dev), upload(c, dev)) for d, c in pr]
    dec = [decode_raw_frame(d, c, *scal) for d, c in raw]
    vol = pm.volume._replace(**{k: t.clone() for k, t in pm.volume._asdict().items()})
    TA, TB = (torch.as_tensor(T, dtype=torch.float32, device=dev) for T in (A, B))
    phases = {
        "upload (2 raw frames)": lambda: [(upload(d, dev), upload(c, dev)) for d, c in pr],
        "decode x2": lambda: [decode_raw_frame(d, c, *scal) for d, c in raw],
        "fuse camera 0": lambda: tk.integrate_step(vol, *dec[0][:2], TA, pm.rays[0], intrs[0],
                                                   cfg.tsdf),
        "fuse camera 1": lambda: tk.integrate_step(vol, *dec[1][:2], TB, pm.rays[1], intrs[1],
                                                   cfg.tsdf),
        "step": lambda: pm._step(vol, *raw[0], *raw[1], *pm.rays, TA, TB, *scal,
                                 torch.ones((), device=dev)),
    }
    times = {k: round(_median_ms(fn, dev), 4) for k, fn in phases.items()}
    del vol
    _log(f"dual pair phase ms at {what} (synchronized after each, median of 5; fuse = allocate "
         f"+ worklist + B1, step = decode x2 + fuse x2 as process_frames enqueues it): "
         f"{json.dumps(times)}  [{gpu}]")
    half, full = n_blocks.get(n_pairs // 2, 0), n_blocks.get(n_pairs, 0)
    if not 0 < half < full:
        failures.append(f"the moving rig at {what} did not allocate throughout ({half} -> "
                        f"{full})")
    if overflow:
        failures.append(f"volume overflow in dual fusion at {what}")
    if counts != {tk.KERNEL: 2 * n_pairs, odo.KERNEL: 0}:
        failures.append(f"dual launches {counts} over {n_pairs} pairs at {what}, not B1 twice a "
                        "pair and B2 never")

    # -- the card against the CPU (plain B1) on the first moving pairs ------------
    pg, pcpu = pipeline(), pipeline(torch.device("cpu"))
    t0 = time.perf_counter()
    for pr, A, B in moving[:cpu_pairs]:
        for p in (pg, pcpu):
            p.extrinsics = [A, B]
            p.process_frames(pr)
    same_keys, frac, err_t, err_c = _volumes_by_key(pg.volume, pcpu.volume)
    _log(f"dual card vs CPU at {what} over {cpu_pairs} moving pairs: same block keys "
         f"{same_keys} ({int(pg.volume.n_blocks)} blocks), weights equal on {frac:.6%}, max "
         f"|dtsdf| {err_t:.3g}, max |dcolor| {err_c:.3g} where they agree "
         f"({ms_since(t0) / 1e3:.1f} s)")
    if not (same_keys and frac >= B1_WEIGHT_EQUAL_MIN and err_t <= B1_VALUE_TOL
            and err_c <= B1_VALUE_TOL):
        failures.append(f"dual fusion at {what} on the card differs from the CPU pipeline")
    del pg, pcpu

    # -- the save (into the pipelines' output directory) ---------------------------
    t0 = time.perf_counter()
    paths = pm.save_current_state()
    save_ms = ms_since(t0)
    cv, cc, _ = read_ply(paths["pointcloud"]) if "pointcloud" in paths else (None,) * 3
    mv_, _, mf = read_obj(paths["mesh"])
    ok_cloud = cv is not None and len(cv) > 10000 and np.isfinite(cv).all() and cc is not None
    ok_mesh = mf is not None and len(mf) > 10000 and np.isfinite(mv_).all() and mf.max() < len(mv_)
    _log(f"dual save at {what}: merged cloud {0 if cv is None else len(cv)} points, mesh "
         f"{len(mv_)} vertices / {0 if mf is None else len(mf)} triangles read back; "
         f"save_current_state {save_ms:.1f} ms (host)  [{gpu}]")
    if not (ok_cloud and ok_mesh):
        failures.append(f"the dual save at {what} did not read back non-empty and finite")
    del pm

    # -- B1 on camera 1's frame against its plain version ---------------------------
    b1 = None
    if dev.type == "cuda":
        dec1 = [_decode(pr[1], cfg, dev) for pr, _, _ in moving[:3]]
        gt1 = [torch.as_tensor(B, dtype=torch.float32, device=dev) for _, _, B in moving[:3]]
        b1 = b1_frame_check(dec1, gt1, intrs[1], pixel_rays(intrs[1], dev), cfg.tsdf,
                            cfg.tsdf.block_capacity, gpu, f"{what}, camera 1 of the rig")
        if not b1["bitwise"]:
            failures.append(f"B1 at {what} (camera 1 of the rig) differs from its plain version")
    return failures, counts, b1


def b1_frame_check(dec, gt, intr, rays, tcfg, rows: int, gpu: str, what: str) -> dict:
    """B1 on the third of ``dec``'s frames into a volume of the first two
    (at the poses ``gt``): one launch at M = ``rows`` against
    ``integrate_worklist_plain`` on copies of the same pools, then its
    wrapper and plain ms (CUDA events), device us per launch
    (``torch.profiler``) and bound from the voxels the update rule updates.
    Logs them and returns them for the kernels line; the caller judges."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

    vol = tsdf.create(tcfg, rays.device)
    for i in range(2):
        vol = tsdf.integrate_frame(vol, dec[i][0], dec[i][1], rays, gt[i], intr, tcfg)
    d2, c2, _ = dec[2]
    vol = tsdf.allocate(vol, d2, rays, gt[2], tcfg)
    wl, n_active = tk.build_worklist(vol.block_coords, vol.n_blocks, gt[2], intr, tcfg)
    wl = wl[:rows].contiguous()
    pools = ("tsdf", "weight", "color")
    vk = vol._replace(**{k: getattr(vol, k).clone() for k in pools})
    vp = vol._replace(**{k: getattr(vol, k).clone() for k in pools})
    del vol
    tk.integrate_worklist_cuda(vk, wl, d2, c2, gt[2], intr, tcfg, n_active)
    tk.integrate_worklist_plain(vp, wl, d2, c2, gt[2], intr, tcfg)
    torch.cuda.synchronize()
    n_live = min(int(n_active), wl.shape[0])
    live = wl[:n_live, 0].long()
    wk, wp = vk.weight[live], vp.weight[live]
    agree = wk == wp
    frac = float(agree.float().mean())
    err_t = float((vk.tsdf[live] - vp.tsdf[live]).abs()[agree].max())
    err_c = float((vk.color[live] - vp.color[live]).abs()[agree[:, None].expand(-1, 3, -1)].max())
    bitwise = all(torch.equal(getattr(vk, k), getattr(vp, k)) for k in pools)
    n_updated = int(tk.updated_voxels(wl[:n_live], d2, gt[2], intr, tcfg))
    grid = tk.launch_grid(tcfg.block_resolution)
    call = lambda: tk.integrate_worklist_cuda(vk, wl, d2, c2, gt[2], intr, tcfg, n_active)
    ms_k = _time_ms(call, 50)
    ms_p = _time_ms(lambda: tk.integrate_worklist_plain(vp, wl, d2, c2, gt[2], intr, tcfg), 5)
    us_k, per_call = _device_us(call, 20, "tsdf_integrate_kernel")
    n_bytes = b1_bound_bytes(n_updated, n_live, d2, c2)
    bound, by = _bound(n_bytes, 0.0)
    _log(f"B1 tsdf_integrate at {what}: {n_live} live worklist rows of M={rows}, "
         f"{n_updated / max(wk.numel(), 1):.3%} of their voxels updated (update rule); weights "
         f"equal on {frac:.6%}, max |dtsdf| {err_t:.3g}, max |dcolor| {err_c:.3g} where they "
         f"agree; pools equal to the bit: {bitwise}; persistent grid {grid} CTAs  [{gpu}]")
    _log(f"B1 time at {what}, M={rows} ({n_live} live): wrapper {ms_k:.4f} ms (CUDA events), "
         f"device {_fmt_us(us_k)} per launch ({per_call:g} kernel/call, torch.profiler), plain "
         f"{ms_p:.4f} ms; bound {bound * 1e3:.3f} us ({by}: {n_updated} voxels updated, "
         f"{n_bytes / 1e6:.2f} MB)  [{gpu}]")
    return dict(max_abs_err=max(err_t, err_c), ms=ms_k, plain_ms=ms_p, bound_ms=bound,
                bound_by=by, library_ms=None, device_us=us_k, weight_equal_fraction=frac,
                bitwise=bitwise, grid=grid, live_rows=n_live, updated_voxels=n_updated)


def b2_pair_check(dec, intr, ocfg, gpu: str, what: str):
    """B2 on the first two of ``dec``'s frames: the kernel against
    ``pyramid_plain`` within ``B2_POSE_TOL`` / ``B2_FITNESS_TOL`` and a
    second launch equal to the bit; the route each level takes
    (``b2_routes``: shared memory unless the level outgrows ``launch_grid``'s
    grid x band); wrapper and plain ms on one prebuilt pyramid, the whole call's
    device us and ms, and the bound from this pair's own iterations.
    Returns (failures, figures for the kernels line)."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo

    (d0, _, i0), (d1, _, i1) = dec[0], dec[1]
    dev = d0.device
    args = (i0, d0, i1, d1, intr, ocfg)
    rk = odo.odometry_pyramid(odo.pyramid_cuda, *args)
    rp = odo.odometry_pyramid(odo.pyramid_plain, *args)
    rk2 = odo.odometry_pyramid(odo.pyramid_cuda, *args)
    torch.cuda.synchronize()
    err_T = float((rk.T_target_source - rp.T_target_source).abs().max())
    err_f = abs(float(rk.fitness) - float(rp.fitness))
    same = bool(torch.equal(rk.T_target_source, rk2.T_target_source))
    levels = len(ocfg.pyramid_iters)
    pyr_s, pyr_t = build_pyramid(i0, d0, levels), build_pyramid(i1, d1, levels)
    grid, band = odo.launch_grid()
    dims = odo.pack_levels(pyr_s, pyr_t, intr, ocfg, dev)[1]
    routes = b2_routes(odo, dims, grid, band)
    level_px = [dims[3 * lvl] * dims[3 * lvl + 1] for lvl in range(levels)]
    _log(f"B2 odometry_pyramid at {what}: max |dpose| {err_T:.3g}, |dfitness| {err_f:.3g} "
         f"(fitness kernel {float(rk.fitness):.6f}, plain {float(rp.fitness):.6f}); a second "
         f"launch equal to the bit: {same}; levels {level_px} pixels; grid {grid} CTAs x band "
         f"{band} pixels = {grid * band}, headroom {grid * band - level_px[0]} pixels over the "
         f"finest level; routes by level {routes}  [{gpu}]")
    failures = []
    if not (err_T <= B2_POSE_TOL and err_f <= B2_FITNESS_TOL and same):
        failures.append(f"B2 at {what} disagrees with its plain version or with itself")
    terms = (0.0 if ocfg.term == "depth" else 1.0, 0.0 if ocfg.term == "color" else 1.0)
    state0 = torch.zeros(odo.STATE, device=dev)
    state0[:12] = torch.eye(4, device=dev)[:3].reshape(-1)
    runner = lambda run: (lambda: run(state0.clone(), pyr_s, pyr_t, intr, ocfg, *terms))
    ms_k = _time_ms(runner(odo.pyramid_cuda), 20)
    ms_p = _time_ms(runner(odo.pyramid_plain), 3)
    us_k, per_call, ms_call = odometry_timing(odo, args, dev)
    pixels, n_src, n_valid = b2_work(pyr_s, pyr_t, intr, ocfg, terms)
    flops = pixels * B2_FLOPS_PROLOGUE + n_src * B2_FLOPS_WARP + n_valid * B2_FLOPS_VALID
    n_bytes = 4 * 4 * pixels + 64  # I_s, D_s, I_t, D_t of every level, read once
    bound, by = _bound(n_bytes, flops)
    _log(f"B2 at {what} per frame pair ({sum(ocfg.pyramid_iters)} GN iterations, one launch): "
         f"wrapper {ms_k:.4f} ms (CUDA events), device {_fmt_us(us_k)} per launch "
         f"({per_call:g} kernel/call, torch.profiler), plain {ms_p:.4f} ms; "
         f"compute_odometry_fast (pyramids + launch, synchronized, median of {ODO_REPS}) "
         f"{ms_call:.4f} ms; bound {bound * 1e3:.3f} us ({by}: {pixels:.0f} level pixels, "
         f"{n_src:.0f} / {n_valid:.0f} source-valid / valid pixel-iterations, "
         f"{flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB)  [{gpu}]")
    return failures, dict(max_abs_err=max(err_T, err_f), ms=ms_k, plain_ms=ms_p,
                          bound_ms=bound, bound_by=by, library_ms=None, device_us=us_k,
                          second_launch_equal=same, odometry_call_ms=ms_call,
                          max_level_pixels=grid * band, headroom_pixels=grid * band - level_px[0],
                          routes=routes)


def b1_odd_r_check(dec, gt, intr, rays, dev, gpu: str, R: int = B1_ODD_R):
    """B1 at block resolution ``R``: ``B1_ODD_R`` (a block resolution the
    JAX package takes that has no instance of its own: the kernel divides
    by R at run time) or ``B1_WIDE_R`` (the largest shift-and-mask
    instance): the third main-path frame into a 2-frame volume of 5 mm
    voxels in R^3 blocks, one launch at M = 2048 against
    ``integrate_worklist_plain``, with B1's tolerances. Returns (failures,
    keys for B1's entry of the kernels line, which holds ``B1_ODD_R``'s)."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

    cfg = TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=R,
                     block_capacity=4096 if R <= 24 else 2048, hash_capacity=16384)
    vol = tsdf.create(cfg, dev)
    for i in range(2):
        vol = tsdf.integrate_frame(vol, dec[i][0], dec[i][1], rays, gt[i], intr, cfg)
    d2, c2, _ = dec[2]
    vol = tsdf.allocate(vol, d2, rays, gt[2], cfg)
    wl, n_active = tk.build_worklist(vol.block_coords, vol.n_blocks, gt[2], intr, cfg)
    wl = wl[:2048].contiguous()
    vk = vol._replace(**{k: getattr(vol, k).clone() for k in ("tsdf", "weight", "color")})
    vp = vol._replace(**{k: getattr(vol, k).clone() for k in ("tsdf", "weight", "color")})
    before = build.launches[tk.KERNEL]
    tk.integrate_worklist_cuda(vk, wl, d2, c2, gt[2], intr, cfg, n_active)
    launches = build.launches[tk.KERNEL] - before
    tk.integrate_worklist_plain(vp, wl, d2, c2, gt[2], intr, cfg)
    torch.cuda.synchronize()
    live = wl[: min(int(n_active), wl.shape[0]), 0].long()
    agree = vk.weight[live] == vp.weight[live]
    frac = float(agree.float().mean())
    err_t = float((vk.tsdf[live] - vp.tsdf[live]).abs()[agree].max())
    err_c = float((vk.color[live] - vp.color[live]).abs()[agree[:, None].expand(-1, 3, -1)].max())
    bitwise = all(torch.equal(getattr(vk, k), getattr(vp, k)) for k in ("tsdf", "weight", "color"))
    moved = int((vk.weight != vol.weight).sum())
    ms_k = _time_ms(lambda: tk.integrate_worklist_cuda(vk, wl, d2, c2, gt[2], intr, cfg,
                                                       n_active), 20)
    kind = "run-time R" if R & (R - 1) else "shift-and-mask"
    _log(f"B1 at R={R} ({kind} instance, {tk.launch_grid(R)} CTAs): "
         f"{int(n_active)} live rows, {moved} weights moved; weights equal on {frac:.6%}, max "
         f"|dtsdf| {err_t:.3g}, max |dcolor| {err_c:.3g} where they agree; pools equal to the "
         f"bit: {bitwise}; {launches} launch; wrapper {ms_k:.4f} ms (CUDA events, 20 calls)  "
         f"[{gpu}]")
    failures = []
    if not (launches == 1 and frac >= B1_WEIGHT_EQUAL_MIN and err_t <= B1_VALUE_TOL
            and err_c <= B1_VALUE_TOL and moved > 100_000 and not bool(vol.overflow)):
        failures.append(f"B1 at R={R} disagrees with its plain version (or its pool overflowed: "
                        f"{bool(vol.overflow)})")
    return failures, dict(r24_max_abs_err=max(err_t, err_c), r24_weight_equal_fraction=frac,
                          r24_bitwise=bitwise, r24_ms=ms_k, launches_r24=launches)


def b2_five_level_check(args, ocfg, gpu: str, what: str):
    """B2 over a 5-level pyramid at each of ``B2_FIVE_LEVEL_SCHEDULES`` on
    one frame pair (``args`` as ``compute_odometry_fast`` takes them, the
    configuration last, which this check replaces): the kernel against
    ``pyramid_plain`` to B2's tolerances and a second launch equal to the
    bit; the coarsest-only schedule must move the pose by more than 10x
    the pose tolerance. Returns (failures, launches, the larger error)."""
    import dataclasses

    import torch

    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo

    H, W = args[1].shape
    failures, launches, worst = [], 0, 0.0
    for iters in B2_FIVE_LEVEL_SCHEDULES:
        cfg5 = dataclasses.replace(ocfg, pyramid_iters=iters)
        before = build.launches[odo.KERNEL]
        rk = odo.odometry_pyramid(odo.pyramid_cuda, *args[:5], cfg5)
        rk2 = odo.odometry_pyramid(odo.pyramid_cuda, *args[:5], cfg5)
        n = build.launches[odo.KERNEL] - before
        rp = odo.odometry_pyramid(odo.pyramid_plain, *args[:5], cfg5)
        torch.cuda.synchronize()
        err_T = float((rk.T_target_source - rp.T_target_source).abs().max())
        err_f = abs(float(rk.fitness) - float(rp.fitness))
        moved = float((rp.T_target_source - torch.eye(4, device=rp.T_target_source.device))
                      .abs().max())
        same = bool(torch.equal(rk.T_target_source, rk2.T_target_source))
        _log(f"B2 over 5 levels {list(iters)} at {W}x{H} ({what}; coarsest level "
             f"{W >> 4}x{H >> 4}): max |dpose| {err_T:.3g}, |dfitness| {err_f:.3g} (fitness "
             f"kernel {float(rk.fitness):.6f}, plain {float(rp.fitness):.6f}); the pose moved "
             f"{moved:.4g} from identity; a second launch equal to the bit: {same}; {n} "
             f"launches  [{gpu}]")
        full = iters == B2_FIVE_LEVEL_SCHEDULES[0]
        if not (n == 2 and err_T <= B2_POSE_TOL and err_f <= B2_FITNESS_TOL and same
                and (float(rk.fitness) > 0.5 if full else moved > 10 * B2_POSE_TOL)):
            failures.append(f"B2 over 5 levels {list(iters)} at {W}x{H} disagrees with its "
                            "plain version or with itself, or did not move the pose")
        launches += n
        worst = max(worst, err_T, err_f)
    return failures, launches, worst


def b2_route_check(args, ocfg, gpu: str) -> list:
    """The large-frame route forced through the plan (``b2_forced_large``)
    on every level of one frame pair's pyramid that fits shared memory
    (``args`` as ``compute_odometry_fast`` takes them, the configuration
    last), at the main path's 3 levels and the first of
    ``B2_FIVE_LEVEL_SCHEDULES``' 5, with every band pixel's gradients
    resident, with half of level 0's and with none (the rest recomputed in
    every iteration): the same pose, fitness and rmse to the bit as the
    shared route. Returns failures."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo

    i0, d0, i1, d1, intr = args[:5]
    size = f"{intr.width}x{intr.height}"
    grid, band = odo.launch_grid()
    half = -(-intr.width * intr.height // grid) // 2
    failures = []
    for iters in (ocfg.pyramid_iters, B2_FIVE_LEVEL_SCHEDULES[0]):
        cfg = dataclasses.replace(ocfg, pyramid_iters=iters)
        levels = len(iters)
        dims = odo.pack_levels(build_pyramid(i0, d0, levels), build_pyramid(i1, d1, levels),
                               intr, cfg, d0.device)[1]
        plan = b2_routes(odo, dims, grid, band)
        shared = odo.odometry_pyramid(odo.pyramid_cuda, *args[:5], cfg)
        equal = {}
        for resident in (None, half, 0):
            with b2_forced_large(odo, resident):
                large = odo.odometry_pyramid(odo.pyramid_cuda, *args[:5], cfg)
                forced = b2_routes(odo, dims, grid, band)[0]
            equal[forced] = bool(torch.equal(large.T_target_source, shared.T_target_source)
                                 and torch.equal(large.fitness, shared.fitness)
                                 and torch.equal(large.rmse, shared.rmse))
        torch.cuda.synchronize()
        _log(f"B2 at {size}, {levels} levels {list(iters)}: the plan's routes {plan}; every "
             f"level forced onto the large route, pose, fitness and rmse equal to the shared "
             f"route's to the bit, by level 0's route: {json.dumps(equal)}  [{gpu}]")
        if plan != ["shared"] * levels or not all(equal.values()):
            failures.append(f"B2's large route at {size} over {levels} levels differs from the "
                            "shared route, or the plan did not take the shared route")
    return failures


def wfov_check(cfg, dev, gpu: str):
    """One 1024x1024 (WFOV unbinned) frame pair of the sweep through
    ``compute_odometry_fast`` against the plain version on the card: pose
    and fitness to B2's tolerances, a second launch equal to the bit, level
    0 on the large-frame route and the coarser levels on the shared one;
    B2's device time beside its bound. Returns (failures, keys for B2's entry of the kernels line)."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo

    ocfg = cfg.odometry
    i0, d0, i1, d1, intr = _wfov_pair(cfg, dev)
    args = (i0, d0, i1, d1, intr, ocfg)
    levels = len(ocfg.pyramid_iters)
    pyr_s, pyr_t = build_pyramid(i0, d0, levels), build_pyramid(i1, d1, levels)
    grid, band = odo.launch_grid()
    _, dims, _ = odo.pack_levels(pyr_s, pyr_t, intr, ocfg, dev)
    routes = b2_routes(odo, dims, grid, band)
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
    _log(f"B2 at 1024x1024 (WFOV unbinned): routes by level {routes} (the grid's shared "
         f"memory holds {grid * band} pixels of a level); max |dpose| {err_T:.3g}, |dfitness| "
         f"{err_f:.3g} (fitness kernel "
         f"{float(rk.fitness):.6f}, plain {float(rp.fitness):.6f}); a second launch equal to the "
         f"bit: {same}")
    _log(f"B2 at 1024x1024 per frame pair: wrapper {ms_k:.4f} ms (CUDA events), device "
         f"{_fmt_us(us_k)} per launch ({per_call:g} kernel/call, torch.profiler), plain "
         f"{ms_p:.4f} ms; compute_odometry_fast {ms_call:.4f} ms (synchronized, median of "
         f"{ODO_REPS}); bound {bound * 1e3:.3f} us ({by}: {pixels:.0f} level pixels, "
         f"{n_src:.0f} / {n_valid:.0f} source-valid / valid pixel-iterations, "
         f"{flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB)  [{gpu}]")
    failures, five_launches, five_err = b2_five_level_check(args, ocfg, gpu,
                                                             "WFOV, level 0 on the large route")
    if not (routes[0].startswith("large") and routes[1:] == ["shared"] * (levels - 1)):
        failures.append(f"the 1024x1024 pyramid's routes are {routes}, not level 0 on the "
                        "large route and the others shared")
    if not (err_T <= B2_POSE_TOL and err_f <= B2_FITNESS_TOL and same and float(rk.fitness) > 0.5):
        failures.append("B2 at 1024x1024 disagrees with its plain version or with itself")
    return failures, dict(wfov_max_abs_err=max(err_T, err_f), wfov_ms=ms_k, wfov_plain_ms=ms_p,
                          wfov_device_us=us_k, wfov_bound_ms=bound, wfov_bound_by=by,
                          wfov_five_level_max_abs_err=five_err, wfov_routes=routes,
                          launches_wfov_five_level=five_launches)


def recorder_phase(intr, cfg, cam, raw, gt, dev, gpu: str, jump_draws: int = JUMP_DRAWS):
    """The recorder, ``Recorder(..., device=dev)``, over ``raw`` at ``cfg``
    (a keyframe every ``cfg.keyframe_interval`` frames), the launch counters
    zeroed just before and read just after: B1 once a recorded frame, B2
    never, every keyframe accepted by colored ICP, no overflow, the
    keyframes' ATE against ``gt``; the save read back; the ms of one
    keyframe step, its colored ICP and one interval step. Then the keyframe
    jump of tests/test_pipelines.py (a keyframe every frame) must be caught
    by the deferred check and rebased through the fallback ladder, and the
    ladder run again on that pair from ``jump_draws`` fresh generator seeds
    must land within the same bounds on each. Each draw's refinements are
    logged with their fitness, share in front and gate verdict (the
    recorder's ``ladder``), beside the share at the true pose: a refinement
    within ``LADDER_TRUE_M`` / ``LADDER_TRUE_RAD`` of the truth must not be
    turned down by free space. Returns (failures, launch counts)."""
    import dataclasses

    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.config import RegistrationConfig
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.core.device import upload
    from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame, decode_raw_frame
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory
    from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.recorder import Recorder
    from azurekinect3dreconstruction_tpu_torch.tracking.icp import (
        FREE_SPACE_MAX_SHARE,
        TargetMaps,
        free_space_band,
        free_space_shares,
        icp_projective,
    )
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
    times = {k: round(_median_ms(fn, dev, 3), 4) for k, fn in phases.items()}
    _log(f"recorder step ms (synchronized after each, median of 3; {reg.colored_icp_max_iters} "
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
    pair = rj._pending[-1][2:4] if deferred else None  # raw (previous, this) keyframe
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
    # every draw of the ladder must land on the jump: T (this camera -> previous keyframe)
    T_true = np.linalg.inv(jump[2]) @ jump[3]

    def off(T):
        e = se3.se3_log(torch.as_tensor(np.linalg.inv(T_true) @ T)).numpy()
        return float(np.linalg.norm(e[:3])), float(np.linalg.norm(e[3:]))

    if pair:  # the gate's share at the true pose, as _register_fallback reads it
        cc = cfg.camera
        prev, curr = (RGBDFrame.from_raw(*r, cc.depth_scale, cc.depth_trunc, cc.depth_min)
                      for r in pair)
        band = free_space_band(prev.depth, curr.depth)
        Tt = torch.as_tensor(T_true, dtype=torch.float32, device=dev)
        truth_share = max(
            float(free_space_shares(prev.depth, intr, curr.depth, rj.rays, Tt, band)[0]),
            float(free_space_shares(curr.depth, intr, prev.depth, rj.rays,
                                    torch.linalg.inv(Tt), band)[0]))
        _log(f"recorder jump pair: share in front at the true pose {truth_share * 100:.3f} % "
             f"(gate {FREE_SPACE_MAX_SHARE * 100:g} %, band's relative part "
             f"{float(band):.4f})  [{gpu}]")
    draws, refs = [], []
    for seed in range(1, jump_draws + 1 if pair else 1):
        rj.generator.manual_seed(seed)
        retries = rj.telemetry.counters.get("fallback_retry", 0)
        t0 = time.perf_counter()
        T_cp = rj._register_fallback(*pair)
        ms = ms_since(t0)
        rounds = 1 + rj.telemetry.counters.get("fallback_retry", 0) - retries
        et_d, er_d = off(T_cp) if T_cp is not None else (float("inf"), float("inf"))
        draws.append((et_d, er_d, rounds, ms))
        mine = [(seed,) + off(T) + (fit, front, ok) for T, fit, front, ok in rj.ladder]
        refs += mine
        shown = [(round(r[1] * 1e3, 1), round(r[2] * 1e3, 1), round(r[3], 4),
                  round(r[4] * 100, 3), r[5]) for r in mine]
        _log(f"recorder jump ladder, seed {seed}: accepted {et_d * 1e3:.3f} mm / "
             f"{er_d * 1e3:.3f} mrad off in {rounds} round(s); refinements (mm off, mrad off, "
             f"fitness, % in front, passed): {shown}  [{gpu}]")
    bad = [d for d in draws if not (d[0] < JUMP_T_LIMIT_M and d[1] < JUMP_R_LIMIT_RAD)]
    true_basin = [r for r in refs if r[1] <= LADDER_TRUE_M and r[2] <= LADDER_TRUE_RAD]
    wrong = [r for r in refs if not (r[1] < JUMP_T_LIMIT_M and r[2] < JUMP_R_LIMIT_RAD)]
    fit_ok = [r for r in wrong if r[3] >= cfg.registration.min_fitness_icp]
    turned = [r for r in true_basin if r[4] > FREE_SPACE_MAX_SHARE]
    span = lambda rs: (f"{min((r[4] for r in rs), default=0) * 100:.3f}-"
                       f"{max((r[4] for r in rs), default=0) * 100:.3f}")
    _log(f"recorder jump ladder over {len(draws)} fresh seeds: {len(draws) - len(bad)} within "
         f"the bounds; worst {max((d[0] for d in draws), default=0) * 1e3:.3f} mm / "
         f"{max((d[1] for d in draws), default=0) * 1e3:.3f} mrad; rounds "
         f"{[d[2] for d in draws]}; ladder ms {[round(d[3], 1) for d in draws]} (host clock); "
         f"{len(refs)} refinements: {len(true_basin)} in the true basin (within "
         f"{LADDER_TRUE_M * 1e3:g} mm / {LADDER_TRUE_RAD * 1e3:g} mrad), % in front there "
         f"{span(true_basin)}, {len(turned)} turned down by free space; {len(wrong)} outside "
         f"the jump's bounds, {len(fit_ok)} of them over the fitness gate, % in front there "
         f"{span(fit_ok)}, {sum(r[5] for r in wrong)} passed the gate  [{gpu}]")
    if len(draws) != jump_draws or bad:
        failures.append(f"the recorder's fallback ladder missed the jump on {len(bad)} of "
                        f"{len(draws)} fresh seeds: {bad}")
    if turned:
        failures.append(f"the recorder's free-space gate turned down {len(turned)} refinement(s) "
                        f"in the jump's true basin: {turned}")
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
    ``raw_healthy`` with and without ``relocalize``; every pipeline at the
    default worklist, as ``cli.live_mono`` builds it. Returns (failures,
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
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import model_reach
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
    kw = dict(device=dev)
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
    d_probe, c_probe, _ = _decode(_quantize(cam.render(poses[probe])), cfg, dev)
    hint = world[resumed[-1]]
    bad = hint.copy()
    bad[:3, 3] += [0.9, -0.6, 0.8]
    reloc = Relocalizer(intr, cfg, device=dev)
    # what the model sample covers: the surface sampler emits at most 4x the
    # budget, in pool order, before it thins; over the budget, the relocalizer
    # samples every block near its hint instead (ROADMAP C9)
    E = mc.snap_extract_blocks(int(vol.n_blocks), vol.tsdf.shape[0])
    _, total = mc.exact_budgets(mc._survey(vol, cfg.tsdf, extract_blocks=E, colors=False), cfg.tsdf)
    _, mm, m_ovf = mc.extract_surface_samples(vol, cfg.tsdf, reloc.model_points)
    ms_model = _median_ms(lambda: mc.extract_surface_samples(vol, cfg.tsdf, reloc.model_points),
                          dev)
    near = lambda: mc.extract_sampled_surface_model(
        vol, cfg.tsdf, reloc.model_points, torch.as_tensor(hint, dtype=torch.float32).to(dev),
        model_reach(cfg), sample_blocks=int(vol.n_blocks))
    _, nm, _ = near()
    ms_near = _median_ms(near, dev)
    _log(f"relocalizer model: the pool-order sample holds {int(mm.sum())} points from the first "
         f"{min(total, 4 * (reloc.model_points // 3))} of the volume's {total} triangles, "
         f"overflow {bool(m_ovf)} ({ms_model:.3f} ms), so the relocalizer samples the blocks "
         f"within {model_reach(cfg):.3f} m of its hint: {int(nm.sum())} points "
         f"({ms_near:.3f} ms) (synchronized, median of 5)  [{gpu}]")

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, ms_since(t0)

    T_h, ms_cold = timed(lambda: reloc.attempt(vol, d_probe, c_probe, T_hint=hint))
    rung0 = reloc.n_hint_success == 1
    _, ms_cached = timed(lambda: reloc.attempt(vol, d_probe, c_probe, T_hint=hint))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    T_g, ms_garbage = timed(lambda: reloc.attempt(vol, d_probe, c_probe, T_hint=bad))
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
    m_feats = reloc._model_cache[-1]
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
        T_c = rc.attempt(host, d_probe.cpu(), c_probe.cpu(), T_hint=hint)
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


def _soup_rows(mesh):
    """A triangle soup as (9 xyz + 9 rgb) rows in canonical (lexsorted)
    order: slot order differs between pools."""
    import numpy as np

    t = np.concatenate([np.asarray(mesh.vertices).reshape(-1, 9),
                        np.asarray(mesh.vertex_colors).reshape(-1, 9)], axis=1)
    return t[np.lexsort(t.T[::-1])]


def _corridor_pass(intr, cfg, raw, dev, streaming, on_frame=None, **kw):
    """``raw`` through ``MonoOdometryTSDF(..., worklist_size=2048,
    streaming=streaming, **kw)`` with one sync at the end, calling
    ``on_frame(i, pipe)`` (host work only) after frame ``i``: (pipeline,
    seconds)."""
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )

    pipe = MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048, streaming=streaming, **kw)
    pipe.telemetry.sink = lambda line: None
    _sync(dev)
    t0 = time.perf_counter()
    for i, (d, c) in enumerate(raw):
        pipe.process_frame(d, c)
        if on_frame is not None:
            on_frame(i, pipe)
    _sync(dev)
    return pipe, time.perf_counter() - t0


def streaming_phase(cfg, dev, gpu: str, runs=STREAM_RUNS, cli: bool = True,
                    revisit: bool = True, warm: bool = True):
    """Host streaming on bench.py's corridor runs (``STREAM_RUNS``):
    ``MonoOdometryTSDF(..., streaming=StreamingTSDF.for_pipeline(cfg,
    check_interval=8, margin=...))`` into the 1,024-block pool, one warm
    pass (with ``warm``) and one timed pass with the launch counters zeroed
    just before and read just after, then the same frames (warm, timed)
    into a plain 4,096-block pool. Checks: no overflow and at least one
    eviction; B1 exactly once a frame and B2 once a tracked frame; the
    trajectory equal to the comparator's to the bit; the assembled
    ``extract_mesh`` soup, sorted, equal to the comparator's to the bit;
    ``extract_point_cloud`` with the comparator's row count. Prints
    frames/s of both and their ratio, tick ms by stage, the host store's
    bytes. With ``revisit``, each run's frames then go out and back: through
    the live loop on the ``REVISIT_LOOP_SCALE`` run (``revisit_run``), at the
    true poses through the manager on the other, with the live loop over
    its first ``REVISIT_SHORT_OUT`` frames (``manager_revisit_run``,
    ``revisit_run``), and over the whole run only reported (ROADMAP C16:
    its misses are printed and fail nothing); the loss and recovery run on
    the ``REVISIT_LOSS_SCALE`` run (or the only one), then once more with
    the relocalizer's first attempt 2 frames after the resumed pose (C15);
    the thrash and the frame-to-model revisit on the
    ``REVISIT_THRASH_SCALE`` and ``REVISIT_F2M_SCALE`` runs, and the
    full-pool deferral once (``deferral_check``). Then, with ``cli``, runs
    the port's ``live_mono`` entry point with ``--streaming`` in a
    subprocess. Returns (failures, launch counts by pass: ``one_way`` and
    ``revisit`` a list a run, ``revisit_short``, ``loss``, ``loss_late``,
    ``thrash``, ``f2m`` when they ran)."""
    import dataclasses

    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.cli.bench import corridor_scene
    from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF

    failures = []
    all_counts = {"one_way": [], "revisit": []}
    scfg = dataclasses.replace(
        cfg, tsdf=TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=16,
                             block_capacity=1024, hash_capacity=8192),
        camera=cfg.camera.replace(depth_trunc=0.7))
    pcfg = dataclasses.replace(scfg, tsdf=scfg.tsdf.replace(
        block_capacity=STREAM_PLAIN_BLOCKS, hash_capacity=4 * STREAM_PLAIN_BLOCKS))
    scene = corridor_scene()
    scales = [r[0] for r in runs]
    loss_scale = REVISIT_LOSS_SCALE if REVISIT_LOSS_SCALE in scales else scales[0]
    t_revisit = t_faults = 0.0
    for scale, n, step, margin in runs:
        intr = Intrinsics.azure_kinect_depth_nfov().scaled(scale)
        cam = SyntheticCamera(scene=scene, intrinsics=intr, device=dev)
        xs = [step * i for i in range(n)]
        raw = [_quantize(cam.render(_corridor_pose(x))) for x in xs]
        manager = lambda: StreamingTSDF.for_pipeline(scfg, check_interval=8, margin=margin,
                                                     device=dev)
        what = f"streaming {intr.width}x{intr.height}, {n} frames at {step} m"
        if warm:
            _corridor_pass(intr, scfg, raw, dev, manager())  # set-up, the eviction path
        build.launches.clear()
        sp, s_sec = _corridor_pass(intr, scfg, raw, dev, manager())
        counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
        all_counts["one_way"].append(counts)
        if warm:
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
             f"at the end{', warm passes first' if warm else ''}); reload<{sv.reload_dist:.3f} m, "
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
        del sp, pp, sv, ms_, mp, soups
        if not revisit:
            continue
        # -- the revisit: out and back over the same frames ------------------------------
        t0 = time.perf_counter()
        size = f"{intr.width}x{intr.height}"
        if scale == REVISIT_LOOP_SCALE:
            f, c = revisit_run(intr, scfg, pcfg, raw, xs, dev, gpu, margin, 0.85,
                               f"revisit {size} ({scfg.tsdf.block_capacity} blocks)")
        else:
            f, c = manager_revisit_run(intr, scfg, pcfg, raw, xs, dev, gpu, margin)
            failures += f
            short = dataclasses.replace(scfg, tsdf=scfg.tsdf.replace(
                block_capacity=REVISIT_SHORT_BLOCKS))
            f, all_counts["revisit_short"] = revisit_run(
                intr, short, pcfg, raw[:REVISIT_SHORT_OUT], xs, dev, gpu, margin,
                REVISIT_SHORT_HIGH_WATER, f"revisit {size}, {REVISIT_SHORT_OUT} frames out "
                f"({REVISIT_SHORT_BLOCKS} blocks)")
            failures += f
            # C16, open: the whole run out and back through the live loop, as at 640x576;
            # its state is printed, and its misses do not fail the run
            t1 = time.perf_counter()
            f, _ = revisit_run(intr, scfg, pcfg, raw, xs, dev, gpu, margin, 0.85,
                               f"C16 (open; reported, not checked): revisit {size} through the "
                               f"live loop ({scfg.tsdf.block_capacity} blocks)")
            _log(f"C16 (open; reported, not checked): {len(f)} of the revisit's checks missed"
                 f"{': ' + '; '.join(f) if f else ''}  [{gpu}]")
            f = []
            t_faults += time.perf_counter() - t1
        failures += f
        all_counts["revisit"].append(c)
        if scale == REVISIT_THRASH_SCALE:
            f, all_counts["thrash"] = thrash_run(intr, scfg, pcfg, raw, xs, dev, gpu, margin)
            failures += f
        if scale == loss_scale:
            args = ((intr, scfg, pcfg, raw, xs, dev, gpu, margin)
                    if scale == REVISIT_LOOP_SCALE else
                    (intr, short, pcfg, raw[:REVISIT_SHORT_OUT], xs, dev, gpu, margin,
                     REVISIT_SHORT_HIGH_WATER))
            f, all_counts["loss"] = loss_run(*args)
            failures += f
            # C15: the relocalizer's first attempt 2 frames after the resumed pose
            t1 = time.perf_counter()
            f, all_counts["loss_late"] = loss_run(*args, shift=2, plain=False)
            failures += f
            t_faults += time.perf_counter() - t1
        if scale == REVISIT_F2M_SCALE:
            f, all_counts["f2m"] = f2m_revisit_run(
                intr, short, pcfg, raw[:REVISIT_SHORT_OUT], xs, dev, gpu, margin,
                REVISIT_SHORT_HIGH_WATER)
            failures += f
        gc.collect()
        t_revisit += time.perf_counter() - t0
        del raw
    if revisit:
        t0 = time.perf_counter()
        failures += deferral_check(dev, gpu)
        t_revisit += time.perf_counter() - t0
        _log(f"streaming revisit checks wall time {t_revisit - t_faults:.1f} s, and the C15 "
             f"check and the open fault's report (C16) {t_faults:.1f} s (host clock)  [{gpu}]")
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

class _StreamWatch:
    """What a ``StreamingTSDF`` did over one pass, read by wrapping its
    instance's ``_evict``, ``_reload_keys`` and ``tick`` (the manager's code
    is unchanged): the keys each eviction stored and how often each key was
    evicted and restored; the keys each reload call restored, and those no
    eviction of this pass had stored (``foreign``); each batch a reload
    copied whole, against the rows it wanted; per tick the camera, the host
    store's bytes before and after, whether it evicted, and the least
    distance of a stored block from the camera. ``timing()`` also times
    every ``_scatter_reload`` by CUDA events on a card (the host clock on
    the CPU)."""

    def __init__(self, sv, dev):
        import collections

        import numpy as np

        from azurekinect3dreconstruction_tpu_torch.tsdf import streaming as st

        self.sv, self.dev, self.st = sv, dev, st
        self.evicted, self.foreign = set(), set()
        self.n_evicted, self.n_restored = collections.Counter(), collections.Counter()
        self.restored, self.batch_rows, self.ticks, self._scatter = [], [], [], []
        self.emptied = []  # per reload call: (batches emptied, their bytes, bytes the store lost)
        evict, reload, tick = sv._evict, sv._reload_keys, sv.tick

        def _evict(*a, **k):
            before = set(sv.store)
            out = evict(*a, **k)
            new = set(sv.store) - before
            self.evicted |= new
            self.n_evicted.update(new)
            return out

        def _reload_keys(want):
            before, p0 = set(sv.store), sv.pinned_bytes
            per = collections.Counter(sv.store[int(k)][0] for k in want)
            self.batch_rows += [(sv._pbatch[b].tsdf.shape[0], m) for b, m in per.items()]
            size = {b: sum(t.numel() * t.element_size()
                           for t in (sv._pbatch[b].tsdf, sv._pbatch[b].weight, sv._pbatch[b].color))
                    for b in per}
            reload(want)
            gone = [b for b in per if b not in sv._pbatch]
            self.emptied.append((len(gone), sum(size[b] for b in gone), p0 - sv.pinned_bytes))
            back = before - set(sv.store)
            self.restored.append(back)
            self.n_restored.update(back)
            self.foreign |= back - self.evicted

        def _tick(cam_pos, _state=None):
            p0, e0 = sv.pinned_bytes, sv.n_evictions
            tick(cam_pos, _state=_state)
            c = cam_pos.detach().cpu().numpy() if hasattr(cam_pos, "detach") else cam_pos
            c = np.asarray(c, np.float64)
            c = c[:3, 3] if c.shape == (4, 4) else c.reshape(3)
            keys = np.fromiter(sv.store, np.int32, len(sv.store))
            d = float(sv._block_dist(st.unpack_np(keys), c).min()) if len(keys) else float("inf")
            self.ticks.append(dict(cam=c, pinned=(p0, sv.pinned_bytes),
                                   evicted=sv.n_evictions != e0, stored_min_dist=d))

        sv._evict, sv._reload_keys, sv.tick = _evict, _reload_keys, _tick

    @contextlib.contextmanager
    def timing(self):
        import torch

        orig = self.st._scatter_reload

        def timed(*a, **k):
            if self.dev.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = orig(*a, **k)
                ev[1].record()
                self._scatter.append(ev)
            else:
                t0 = time.perf_counter()
                out = orig(*a, **k)
                self._scatter.append((t0, time.perf_counter()))
            return out

        self.st._scatter_reload = timed
        try:
            yield self
        finally:
            self.st._scatter_reload = orig

    def scatter_ms(self) -> float:
        """``_scatter_reload``'s total ms over the pass."""
        _sync(self.dev)
        if self.dev.type == "cuda":
            return sum(a.elapsed_time(b) for a, b in self._scatter)
        return sum((b - a) * 1e3 for a, b in self._scatter)

    def reload_calls(self) -> int:
        """Reload calls that brought back at least one block."""
        return sum(1 for r in self.restored if r)

    def cycles(self) -> int:
        """The most evict -> restore cycles one key went through."""
        return max((min(n, self.n_restored[k]) for k, n in self.n_evicted.items()), default=0)

    def pinned_falls(self):
        """(ticks whose host store grew without an eviction, batches the
        reloads emptied, reload calls after which the store did not shrink
        by exactly the emptied batches' bytes): the store only grows by an
        eviction, and a batch leaves it with its last row."""
        grew = sum(1 for t in self.ticks if not t["evicted"] and t["pinned"][1] > t["pinned"][0])
        emptied = sum(g for g, _, _ in self.emptied)
        wrong = sum(1 for _, want, got in self.emptied if want != got)
        return grew, emptied, wrong


def _live_and_stored(sv, vol) -> int:
    """Keys that are both in ``vol``'s pool and in ``sv``'s host store."""
    from azurekinect3dreconstruction_tpu_torch.tsdf.hash import pack_key_np

    n = int(vol.n_blocks)
    live = set(pack_key_np(vol.block_coords[:n].cpu().numpy()).tolist())
    return len(live & set(sv.store))


def _map_weight(sv, vol):
    """The whole map's (keys, weight sum): the pool's live blocks and the
    host store's, in float64 (weights are whole observation counts, so the
    sums are exact and an eviction or a reload moves none)."""
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.tsdf.hash import pack_key_np

    n = int(vol.n_blocks)
    keys = set(pack_key_np(vol.block_coords[:n].cpu().numpy()).tolist()) | set(sv.store)
    w = float(vol.weight[:n].double().sum())
    for key in sv.store:
        w += float(np.asarray(sv._stored_payload(key)[1], np.float64).sum())
    return keys, w


def _pose_err(T, G):
    """(m, rad) between two 4x4 poses."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core import se3

    xi = se3.se3_log(torch.as_tensor(np.linalg.inv(G) @ np.asarray(T, np.float64))).numpy()
    return float(np.linalg.norm(xi[:3])), float(np.linalg.norm(xi[3:]))


def _batch_copy_ms(sv, dev):
    """The host-to-device copy of the host store's largest batch, whole,
    as ``_reload_keys`` copies a batch: (rows, MB, ms by CUDA events, median
    of 5), or None without a batch or a card."""
    import statistics

    import torch

    if dev.type != "cuda" or not sv._pbatch:
        return None
    b = max(sv._pbatch.values(), key=lambda b: b.tsdf.shape[0])
    parts = (b.tsdf, b.weight, b.color)
    times = []
    for _ in range(6):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = [a.to(dev, non_blocking=True) for a in parts]
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        del out
    mb = sum(a.numel() * a.element_size() for a in parts) / 1e6
    return b.tsdf.shape[0], mb, statistics.median(times[1:])


def _storage_checks(what: str, sv, watch, vol, dev, gpu: str, turn=None) -> list:
    """What every revisit pass holds the manager to, printed with its
    numbers: evictions, and reload calls that restore only blocks this pass
    evicted; no key both live and stored; at the last tick every stored
    block farther than ``reload_dist`` from the camera; the host store
    never grows without an eviction, loses each batch's bytes with its last
    row, and holds no empty batch. Also prints blocks reloaded and merged,
    the store's bytes at the turn (``turn``) and at the end,
    ``_scatter_reload``'s ms, the batches the reloads copied whole against
    the rows they wanted, and one whole batch's copy to the card."""
    both = _live_and_stored(sv, vol)
    last = watch.ticks[-1] if watch.ticks else dict(stored_min_dist=float("inf"))
    empty = (sum(1 for b in sv._pbatch.values() if b.live <= 0)
             + sum(1 for b in sv._sbatch.values() if b.refs <= 0))
    grew, emptied, wrong = watch.pinned_falls()
    scatter_ms = watch.scatter_ms()
    rows = sum(r for r, _ in watch.batch_rows)
    wanted = sum(m for _, m in watch.batch_rows)
    turn = turn or {}
    ticks = max(sv.n_ticks, 1)
    stage = {k: round(v / ticks, 3) for k, v in sorted(sv.tick_ms.items(), key=lambda kv: -kv[1])}
    _log(f"{what}: reload<{sv.reload_dist:.3f} m, evict>{sv.evict_dist:.3f} m, high water "
         f"{sv.high_water}; {sv.n_ticks} ticks, {sv.n_evictions} evictions, "
         f"{watch.reload_calls()} reload calls restoring {sum(len(r) for r in watch.restored)} "
         f"blocks (n_blocks_reloaded {getattr(sv, 'n_blocks_reloaded', None)}), "
         f"{len(watch.foreign)} of them not evicted earlier in this pass, "
         f"{getattr(sv, 'n_reload_merged', None)} merged into a live key; at the turn "
         f"{turn.get('stored')} blocks stored, host store {turn.get('pinned', 0) / 2**20:.3f} MiB, "
         f"at the end {sv.n_stored} stored, {sv.pinned_bytes / 2**20:.3f} MiB "
         f"({'page-locked' if dev.type == 'cuda' else 'CPU memory'}); batches the reloads "
         f"emptied {emptied}, reload calls after which the store did not shrink by their bytes "
         f"{wrong}, ticks where it grew without an eviction {grew}, empty batches held {empty}; "
         f"live and stored keys {both}; the last tick's nearest stored block "
         f"{last['stored_min_dist']:.3f} m from the camera; {int(vol.n_blocks)} live  [{gpu}]")
    _log(f"{what}: tick ms per tick by stage (host clock) {json.dumps(stage)}; _scatter_reload "
         f"{scatter_ms:.3f} ms over {len(watch._scatter)} calls "
         f"({'CUDA events' if dev.type == 'cuda' else 'host clock'}); the reloads copied "
         f"{len(watch.batch_rows)} batches whole, {rows} rows for the {wanted} they wanted  "
         f"[{gpu}]")
    copy = _batch_copy_ms(sv, dev)
    if copy is not None:
        r, mb, ms = copy
        _log(f"{what}: one whole batch to the card as _reload_keys copies it ({r} rows, "
             f"{mb:.2f} MB, page-locked): {ms:.4f} ms ({mb / ms:.2f} GB/s; CUDA events, median "
             f"of 5)  [{gpu}]")
    failures = []
    if sv.n_evictions == 0 or watch.reload_calls() == 0 or watch.foreign:
        failures.append(f"{what}: {sv.n_evictions} evictions, {watch.reload_calls()} reload "
                        f"calls, {len(watch.foreign)} blocks reloaded that this pass had not "
                        "evicted")
    if both or not last["stored_min_dist"] > sv.reload_dist:
        failures.append(f"{what}: {both} keys live and stored; the last tick's nearest stored "
                        f"block {last['stored_min_dist']:.3f} m, not beyond {sv.reload_dist:.3f}")
    if grew or not emptied or wrong or empty:
        failures.append(f"{what}: the host store grew without an eviction at {grew} ticks; "
                        f"{emptied} batches emptied, {wrong} reloads not freeing their bytes; "
                        f"{empty} empty batches held")
    return failures


def _equal_to_plain(what: str, soups, clouds, trajs=None) -> list:
    """Sorted soups equal to the bit, point cloud rows equal, and, with
    ``trajs``, trajectories equal to the bit; printed."""
    import numpy as np

    same_soup = soups[0].shape == soups[1].shape and np.array_equal(*soups)
    same_traj = trajs is None or np.array_equal(*trajs)
    _log(f"{what}: trajectory equal to the plain pass's to the bit: "
         f"{'n/a' if trajs is None else same_traj}; sorted soup equal to the bit: {same_soup} "
         f"({soups[0].shape[0]} / {soups[1].shape[0]} triangles); point cloud rows "
         f"{clouds[0]} / {clouds[1]}")
    if not (same_traj and same_soup and clouds[0] == clouds[1]):
        return [f"{what}: the streamed pass differs from the plain pass (trajectory "
                f"{same_traj}, soup {same_soup}, cloud rows {clouds[0]} / {clouds[1]})"]
    return []


def _track_report(traj, gt, n_out: int) -> str:
    """The trajectory ``traj`` (one pose a frame) against the truth ``gt``
    on an out-and-back pass of ``n_out`` frames out: ATE RMSE and the
    largest error, and the error at the turn and at the end (x, y, z in mm
    and rotation in mrad, from the se3 log of truth^-1 @ estimate)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core import se3

    xi = np.stack([se3.se3_log(torch.as_tensor(np.linalg.inv(G) @ np.asarray(T, np.float64)))
                   .numpy() for T, G in zip(traj, gt)])
    err = np.stack([np.asarray(T, np.float64)[:3, 3] - G[:3, 3] for T, G in zip(traj, gt)]) * 1e3
    at = lambda i: (f"x {err[i, 0]:.2f} y {err[i, 1]:.2f} z {err[i, 2]:.2f} mm, rotation "
                    f"{np.linalg.norm(xi[i, 3:]) * 1e3:.2f} mrad")
    norm = np.linalg.norm(err, axis=1)
    return (f"against the truth: ATE RMSE {np.sqrt(np.mean(norm ** 2)):.3f} mm, largest "
            f"{norm.max():.3f} mm; at the turn {at(n_out - 1)}; at the end {at(-1)}")


def revisit_run(intr, scfg, pcfg, raw, xs, dev, gpu: str, margin: float, high_water: float,
                what: str):
    """Host streaming's revisit through the live loop: ``raw`` out, then
    back over the same frames in reverse to the first (no frame rendered
    again), through ``MonoOdometryTSDF(..., streaming=StreamingTSDF.
    for_pipeline(scfg, high_water=high_water, check_interval=8,
    margin=margin))`` with the counters zeroed just before and read just
    after, and into a plain pool (``pcfg``). Checks: ``_storage_checks``;
    no overflow; B1 exactly once a frame and B2 once a tracked frame; the
    trajectory and the sorted ``extract_mesh`` soup equal to the plain
    pass's to the bit, ``extract_point_cloud`` with its rows. Prints
    frames/s of both, the reloads a full pool deferred, and the streamed
    trajectory against the truth (``xs``, the frames' positions along the
    corridor; ``_track_report``). Returns (failures, launch counts)."""
    import re

    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.tsdf import streaming as st
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF

    n_out = len(raw)
    frames = list(raw) + list(raw[-2::-1])
    gt = [_corridor_pose(xs[i]) for i in list(range(n_out)) + list(range(n_out - 2, -1, -1))]
    n = len(frames)
    sv = StreamingTSDF.for_pipeline(scfg, high_water=high_water, check_interval=8,
                                    margin=margin, device=dev)
    watch = _StreamWatch(sv, dev)
    turn = {}

    def on_frame(i, pipe):
        if i == n_out - 1:
            turn.update(pinned=sv.pinned_bytes, stored=sv.n_stored)

    deferred = []  # blocks a full pool deferred, a warning each
    warn = st.log_warning

    def log_warning(msg):
        m = re.search(r"deferred reload of (\d+) blocks", msg)
        if m:
            deferred.append(int(m.group(1)))
        warn(msg)

    build.launches.clear()
    st.log_warning = log_warning
    try:
        with watch.timing():
            sp, s_sec = _corridor_pass(intr, scfg, frames, dev, sv, on_frame)
    finally:
        st.log_warning = warn
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    failures = _storage_checks(what, sv, watch, sp.volume, dev, gpu, turn)
    pp, p_sec = _corridor_pass(intr, pcfg, frames, dev, None)
    overflow = bool(sp.volume.overflow) or bool(pp.volume.overflow)
    _log(f"{what} launches: {json.dumps(counts)} over {n} frames ({n_out} out, {n - n_out} back); "
         f"streamed {n / s_sec:.3f} frames/s, plain {n / p_sec:.3f} frames/s (host clock, one "
         f"sync at the end); {int(pp.volume.n_blocks)} blocks in the plain pool; gate rejections "
         f"{sp.odometry_failures}; overflow {overflow}; reloads a full pool deferred "
         f"{len(deferred)} times ({sum(deferred)} blocks)  [{gpu}]")
    _log(f"{what}: {_track_report(sp.trajectory[1:], gt, n_out)}  [{gpu}]")
    import numpy as np

    failures += _equal_to_plain(
        what, (_soup_rows(sp.extract_mesh()), _soup_rows(pp.extract_mesh().compact())),
        (sp.extract_point_cloud()[0].shape[0], pp.extract_point_cloud()[0].shape[0]),
        (np.stack(sp.trajectory), np.stack(pp.trajectory)))
    if overflow:
        failures.append(f"{what}: overflow")
    if counts[tk.KERNEL] != n or counts[odo.KERNEL] != n - 1:
        failures.append(f"{what}: launches {counts}, not B1 once a frame and B2 once a tracked "
                        "frame")
    return failures, counts


def _manager_pass(intr, scfg, pcfg, raw, xs, idx, dev, margin: float):
    """The frames ``raw[i]`` for ``i`` in ``idx`` at their true poses
    through ``StreamingTSDF.for_pipeline(scfg, check_interval=8,
    margin=margin)``'s own ``integrate_frame`` (B1 once a frame over the
    pool), with the counters zeroed just before and read just after, and
    through ``integrate_step`` (B1 once a frame) into a plain pool
    (``pcfg``): (manager, watch, plain volume, streamed seconds, launch
    counts, the store at the turn: the last index of the largest x)."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF

    rays = pixel_rays(intr, dev)
    dec = {i: _decode(raw[i], scfg, dev)[:2] for i in sorted(set(idx))}
    pose = {i: torch.as_tensor(_corridor_pose(xs[i]), dtype=torch.float32, device=dev)
            for i in dec}
    turn_at = max(range(len(idx)), key=lambda j: (idx[j], -j))
    sv = StreamingTSDF.for_pipeline(scfg, check_interval=8, margin=margin, device=dev)
    watch = _StreamWatch(sv, dev)
    turn = {}
    _sync(dev)
    build.launches.clear()
    t0 = time.perf_counter()
    with watch.timing():
        for j, i in enumerate(idx):
            sv.integrate_frame(*dec[i], rays, pose[i], intr)
            if j == turn_at:
                turn.update(pinned=sv.pinned_bytes, stored=sv.n_stored)
        _sync(dev)
    s_sec = time.perf_counter() - t0
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    vol = tsdf.create(pcfg.tsdf, dev)
    for i in idx:
        vol = tk.integrate_step(vol, *dec[i], pose[i], rays, intr, pcfg.tsdf, 2048, 2)
    return sv, watch, vol, s_sec, counts, turn


def _manager_soups(sv, vol, pcfg):
    """(sorted soups, point cloud rows) of the manager and the plain pool."""
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf

    soups = _soup_rows(sv.extract_mesh()), _soup_rows(mc.extract_mesh(vol, pcfg.tsdf).compact())
    rows = (sv.extract_point_cloud()[0].shape[0],
            tsdf.extract_point_cloud(vol, pcfg.tsdf)[0].shape[0])
    return soups, rows


def manager_revisit_run(intr, scfg, pcfg, raw, xs, dev, gpu: str, margin: float):
    """The revisit of every frame of ``raw`` at the true poses
    (``_manager_pass``): out, then back in reverse to the first. Checks:
    ``_storage_checks``, no overflow, B1 exactly once a frame, the sorted
    soup and the cloud's rows equal to the plain pool's. Returns (failures,
    launch counts)."""
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk

    idx = list(range(len(raw))) + list(range(len(raw) - 2, -1, -1))
    n = len(idx)
    what = f"revisit at the true poses {intr.width}x{intr.height} ({scfg.tsdf.block_capacity} blocks)"
    sv, watch, vol, s_sec, counts, turn = _manager_pass(intr, scfg, pcfg, raw, xs, idx, dev,
                                                        margin)
    failures = _storage_checks(what, sv, watch, sv.vol, dev, gpu, turn)
    overflow = bool(sv.vol.overflow) or bool(vol.overflow)
    _log(f"{what} (the manager's integrate_frame, no tracking): launches {json.dumps(counts)} "
         f"over {n} frames, {n / s_sec:.3f} frames/s (host clock, one sync at the end); "
         f"{int(vol.n_blocks)} blocks in the plain pool; overflow {overflow}  [{gpu}]")
    failures += _equal_to_plain(what, *_manager_soups(sv, vol, pcfg))
    if overflow:
        failures.append(f"{what}: overflow")
    if counts != {tk.KERNEL: n, odo.KERNEL: 0}:
        failures.append(f"{what}: launches {counts}, not B1 once a frame")
    return failures, counts


def thrash_run(intr, scfg, pcfg, raw, xs, dev, gpu: str, margin: float):
    """The thrash pattern of ``tests/test_torch_streaming.py``'s slow test
    at the corridor's quarter-resolution rings, as that test runs it: at
    the true poses through the manager's own ``integrate_frame``
    (``_manager_pass``). Out over ``raw[:THRASH_OUT]`` (past the eviction
    ring), then ``THRASH_SWINGS`` times back ``THRASH_BACK`` frames and out
    again, across the reload / evict band. Checks: at least 3 reload calls
    restoring blocks this pass evicted, and none other; one key through at
    least 3 evict -> restore cycles; no key live and stored; the sorted soup
    equal to the plain pool's to the bit; no overflow; B1 once a frame.
    Returns (failures, launch counts)."""
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk

    idx = list(range(THRASH_OUT))
    for _ in range(THRASH_SWINGS):
        idx += list(range(THRASH_OUT - 2, THRASH_OUT - 2 - THRASH_BACK, -1))
        idx += list(range(THRASH_OUT - THRASH_BACK, THRASH_OUT))
    n = len(idx)
    what = f"thrash {intr.width}x{intr.height}"
    sv, watch, vol, s_sec, counts, _ = _manager_pass(intr, scfg, pcfg, raw, xs, idx, dev,
                                                     margin)
    both = _live_and_stored(sv, sv.vol)
    overflow = bool(sv.vol.overflow) or bool(vol.overflow)
    calls, cycles = watch.reload_calls(), watch.cycles()
    _log(f"{what} (the manager's integrate_frame at the true poses): out to x = "
         f"{xs[THRASH_OUT - 1]:.2f} m, then {THRASH_SWINGS} x ({THRASH_BACK} frames back, "
         f"{THRASH_BACK} out), {n} frames, {n / s_sec:.3f} frames/s; launches "
         f"{json.dumps(counts)}; {sv.n_evictions} evictions, {calls} reload calls restoring "
         f"evicted blocks ({len(watch.foreign)} blocks not evicted earlier), the most cycles of "
         f"one key {cycles}; live and stored keys {both}; overflow {overflow}  [{gpu}]")
    failures = _equal_to_plain(what, *_manager_soups(sv, vol, pcfg))
    if not (calls >= 3 and cycles >= 3 and not watch.foreign and not both and not overflow):
        failures.append(f"{what}: {calls} reload calls, {cycles} cycles, {len(watch.foreign)} "
                        f"foreign, {both} live and stored, overflow {overflow}")
    if counts != {tk.KERNEL: n, odo.KERNEL: 0}:
        failures.append(f"{what}: launches {counts}, not B1 once a frame")
    return failures, counts


def loss_run(intr, scfg, pcfg, raw, xs, dev, gpu: str, margin: float,
             high_water: float = 0.85, shift: int = 0, plain: bool = True):
    """A loss and a recovery in a streamed map: the revisit's frames with
    ``N_REVISIT_DARK`` dark frames on the way back, starting about
    ``REVISIT_DARK_AT`` of the way back, then the scan resumed at the pose
    where it went dark, through ``MonoOdometryTSDF(...,
    relocalize=True, reloc_window=2, reloc_interval=4)`` streamed, and the
    same into a plain pool. Checks (``PERF.md`` §2's relocalization row):
    the loss declared once and one recovery; nothing fused from the first
    dark frame until the recovery (the map's keys and weight sum, live and
    stored, unchanged); the stream given the stale pose on every lost
    frame, and a tick among them; the hint rung's recovered pose within 6
    cm / 0.12 rad; the
    pipeline's pool the manager's afterwards; B2 once a frame through the
    step, B1 once a frame through the step plus the first and the recovery;
    no overflow. Prints the recovered pose's difference from the plain
    run's (with ``plain`` False no plain run), the relocalizer's ms an
    attempt, the poses its slide gate turned down and the global winners
    its consensus gate turned down. ``shift`` starts the
    dark frames that many frames earlier than the alignment below, so that
    the relocalizer's first attempt with a frame comes ``shift`` frames
    after the resumed pose (ROADMAP C15): then the checks take at most one
    recovery, by any rung, within the bounds, and none fused before it.
    Returns (failures, launch counts)."""
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF

    n_out = len(raw)
    back = list(range(n_out - 2, -1, -1))
    k = int(REVISIT_DARK_AT * len(back))
    # the dark frames start 2 frames after a tracking check (every 4): the
    # check after the second declares the loss, the relocalizer's next
    # attempt (every 4th lost frame) is the first resumed frame, and one of
    # the lost frames is a tick's (every 8 frames through the stream)
    k -= (n_out + k - 2) % 4 + shift
    H, W = intr.height, intr.width
    dark = (np.zeros((H, W), np.uint16), np.zeros((H, W, 3), np.uint8))
    idx = list(range(n_out)) + back[:k] + [None] * N_REVISIT_DARK + back[k - 1:]
    frames = [dark if i is None else raw[i] for i in idx]
    s = n_out + k  # the first dark frame
    what = f"streamed loss {W}x{H}, {n_out} frames out"
    if shift:
        what = f"C15 (checked): {what}, the first attempt {shift} frames after the resumed pose"
    kw = dict(relocalize=True, reloc_window=2, reloc_interval=4)
    sv = StreamingTSDF.for_pipeline(scfg, high_water=high_water, check_interval=8,
                                    margin=margin, device=dev)
    watch = _StreamWatch(sv, dev)
    rec = dict(lost_at=None, recovered_at=None, stepped=0, lost_poses=[], lost_ticks=0,
               latched=[])

    def on_frame(i, pipe):
        if pipe.lost and rec["lost_at"] is None:
            rec["lost_at"] = i
        if rec["lost_at"] is not None and not pipe.lost and rec["recovered_at"] is None:
            rec["recovered_at"] = i
        if i == s - 1:
            rec["stretch"] = [(float(c[0]) + 0.5) * scfg.tsdf.block_size
                              for c in _unpack(list(watch.evicted))]
            rec["stored"] = sv.n_stored
        if i >= s - 1 and rec["recovered_at"] is None:
            rec["latched"].append(_map_weight(sv, pipe.volume))

    def stepped_process(pipe):
        """Count the frames through the step, and what the stream is given
        on a lost frame: the pose ``maybe_tick`` reads against the stale
        pose, and whether a tick ran."""
        process, maybe_tick = pipe.process_frame, sv.maybe_tick
        seen = []

        def tick_seen(cam_pos):
            seen.append(np.asarray(cam_pos().detach().cpu().numpy(), np.float64)[:3, 3])
            return maybe_tick(cam_pos)

        def process_counted(d, c):
            was_lost, t0 = pipe.lost, len(watch.ticks)
            stale = pipe.T_world_cam[:3, 3].copy()
            rec["stepped"] += int(pipe._prev_int is not None and not was_lost)
            seen.clear()
            out = process(d, c)
            if was_lost:
                rec["lost_poses"] += [float(np.abs(p - stale).max()) for p in seen]
                rec["lost_ticks"] += len(watch.ticks) - t0
            return out

        pipe.process_frame, sv.maybe_tick = process_counted, tick_seen

    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )

    pipe = MonoOdometryTSDF(intr, scfg, device=dev, worklist_size=2048, streaming=sv, **kw)
    pipe.telemetry.sink = lambda line: None
    stepped_process(pipe)
    _sync(dev)
    build.launches.clear()
    for i, (d, c) in enumerate(frames):
        pipe.process_frame(d, c)
        on_frame(i, pipe)
    _sync(dev)
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    ev = pipe.counts
    rel = pipe._relocalizer
    ra = rec["recovered_at"]
    traj = pipe.trajectory
    err = (_pose_err(traj[ra + 1], _corridor_pose(xs[idx[ra]])) if ra is not None
           else (float("inf"),) * 2)
    first = rec["latched"][0] if rec["latched"] else None
    unfused = bool(first) and all(kk == first[0] and w == first[1] for kk, w in rec["latched"])
    lost_ticks = rec["lost_ticks"]
    at_stale = bool(rec["lost_poses"]) and max(rec["lost_poses"]) == 0.0 and lost_ticks > 0
    one_pool = pipe.volume is sv.vol
    overflow = bool(pipe.volume.overflow)
    want_b1 = rec["stepped"] + 1 + ev.get("relocalized", 0)
    # the stretch evicted before the camera went dark, and where it went dark
    ev_x = sorted(rec.get("stretch", []))
    x_dark = xs[back[k - 1]]
    # the same frames into a plain pool
    p_ra = None
    diff = "n/a"
    if plain:
        pp = MonoOdometryTSDF(intr, pcfg, device=dev, worklist_size=2048, **kw)
        pp.telemetry.sink = lambda line: None
        for d, c in frames:
            pp.process_frame(d, c)
    if plain and ra is not None:
        pdiff = _pose_err(traj[ra + 1], pp.trajectory[ra + 1])
        diff = f"{pdiff[0] * 1e3:.3f} mm / {pdiff[1] * 1e3:.3f} mrad"
        p_ra = pp.counts.get("relocalized", 0)
    _log(f"{what} launches: {json.dumps(counts)} over {len(frames)} frames ({rec['stepped']} "
         f"through the step)  [{gpu}]")
    n_att = rel.n_attempts if rel is not None else 0
    _log(f"{what}: {n_att} relocalization attempts, "
         f"{pipe.telemetry.mean_time_ms('relocalize'):.1f} ms each on average (host clock, the "
         f"empty frames' included); the slide gate turned down "
         f"{getattr(rel, 'n_texture_rejects', 0)} poses by texture and "
         f"{getattr(rel, 'n_free_space_rejects', 0)} by relief, the consensus gate "
         f"{getattr(rel, 'n_consensus_rejects', 0)} global winners (the last's RANSAC inliers "
         f"and its rival's {list(getattr(rel, 'last_consensus', ()))})  [{gpu}]")
    _log(f"{what}: {N_REVISIT_DARK} dark frames from frame {s} (the way back at x = "
         f"{x_dark:.3f} m, inside the {len(ev_x)} blocks the pass had evicted by then, x "
         f"{ev_x[0] if ev_x else float('nan'):.2f} to {ev_x[-1] if ev_x else float('nan'):.2f} m, "
         f"{rec.get('stored')} of them still stored), "
         f"resumed at that pose at frame {s + N_REVISIT_DARK}; loss declared at frame "
         f"{rec['lost_at']}, recovered at frame {ra} by rung {'0 (hint)' if rel is not None and rel.n_hint_success else 'global'}; events "
         f"{json.dumps(ev)}; map keys and weight unchanged from the first dark frame to the "
         f"recovery: {unfused} ({len(rec['latched'])} frames read); {lost_ticks} ticks while lost, "
         f"the stream given the stale pose on every lost frame and a tick among them: "
         f"{at_stale}; recovered pose off by {err[0] * 1e3:.3f} mm / "
         f"{err[1] * 1e3:.3f} mrad; the pipeline's pool is the manager's: {one_pool}; "
         f"{sv.n_evictions} evictions, {watch.reload_calls()} reload calls; overflow {overflow}; "
         f"against the same run into a plain pool (recovered {p_ra}): {diff}  [{gpu}]")
    failures = []
    n_rec = ev.get("relocalized", 0)
    if not (ev.get("tracking_lost", 0) == 1 and (n_rec == 1 or shift and n_rec == 0) and unfused
            and at_stale and one_pool and not overflow):
        failures.append(f"{what}: events {ev}, nothing fused while latched {unfused}, ticks while "
                        f"lost at the stale pose {at_stale} ({lost_ticks} ticks, "
                        f"{rec['lost_poses']}), one pool {one_pool}, overflow {overflow}")
    if ra is not None and not (err[0] <= RELOC_T_LIMIT_M and err[1] <= RELOC_R_LIMIT_RAD):
        failures.append(f"{what}: a relocalization accepted off the bounds ({err})")
    if not shift and not (rel is not None and rel.n_hint_success >= 1 and ra is not None):
        failures.append(f"{what}: not recovered by the hint rung")
    if counts[odo.KERNEL] != rec["stepped"] or counts[tk.KERNEL] != want_b1:
        failures.append(f"{what}: launches {counts}, not B2 {rec['stepped']} and B1 {want_b1}")
    return failures, counts


def f2m_revisit_run(intr, scfg, pcfg, raw, xs, dev, gpu: str, margin: float,
                    high_water: float):
    """Frame-to-model tracking on the revisit: the out-and-back frames with
    ``tracking="frame_to_model"``, streamed (``StreamingTSDF.for_pipeline(...,
    tracking="frame_to_model")``, whose reload ring holds every block a
    refresh reads) and into a plain pool. Its model refresh samples the
    blocks within ``model_reach``, reloaded ones on the way back, in block
    key order (ROADMAP C17). Checks: the two trajectories and sorted
    ``extract_mesh`` soups equal to the bit, both ATE RMSE <= 20 mm, no
    overflow, B1 once a frame and B2 once a tracked frame. Returns
    (failures, launch counts)."""
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.tsdf.streaming import StreamingTSDF
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate

    idx = list(range(len(raw))) + list(range(len(raw) - 2, -1, -1))
    frames = [raw[i] for i in idx]
    n = len(frames)
    gt = [_corridor_pose(xs[i]) for i in idx]
    what = f"frame-to-model revisit {intr.width}x{intr.height}, {len(raw)} frames out"
    sv = StreamingTSDF.for_pipeline(scfg, high_water=high_water, check_interval=8,
                                    margin=margin, tracking="frame_to_model", device=dev)
    watch = _StreamWatch(sv, dev)
    build.launches.clear()
    sp, s_sec = _corridor_pass(intr, scfg, frames, dev, sv, tracking="frame_to_model")
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    pp, p_sec = _corridor_pass(intr, pcfg, frames, dev, None, tracking="frame_to_model")
    ts, tp = np.stack(sp.trajectory[1:]), np.stack(pp.trajectory[1:])
    a_s, a_p = ate(list(ts), gt)["rmse"], ate(list(tp), gt)["rmse"]
    worst = max((_pose_err(a, b) for a, b in zip(ts, tp)), key=lambda e: e[0] + e[1])
    equal = np.array_equal(ts, tp)
    soups = _soup_rows(sp.extract_mesh()), _soup_rows(pp.extract_mesh().compact())
    same_soup = soups[0].shape == soups[1].shape and np.array_equal(*soups)
    cs, cp = sp.counts, pp.counts
    overflow = bool(sp.volume.overflow) or bool(pp.volume.overflow)
    _log(f"{what}: {n} frames, streamed {n / s_sec:.3f} frames/s, plain {n / p_sec:.3f}; launches "
         f"{json.dumps(counts)}; ATE rmse streamed {a_s * 1e3:.3f} mm, plain {a_p * 1e3:.3f} mm; "
         f"largest pose difference {worst[0] * 1e3:.4f} mm / {worst[1] * 1e3:.4f} mrad, "
         f"trajectories equal to the bit: {equal}, sorted soups equal to the bit: {same_soup} "
         f"({soups[0].shape[0]} / {soups[1].shape[0]} triangles); reload<{sv.reload_dist:.3f} "
         f"m; refinements accepted {cs.get('model_icp_ok', 0)} / "
         f"{cp.get('model_icp_ok', 0)}, model samples over budget {cs.get('model_truncated', 0)} / "
         f"{cp.get('model_truncated', 0)}; {sv.n_evictions} evictions, {watch.reload_calls()} "
         f"reload calls; overflow {overflow}  [{gpu}]")
    _log(f"{what}: streamed {_track_report(ts, gt, len(raw))}; plain "
         f"{_track_report(tp, gt, len(raw))}  [{gpu}]")
    failures = []
    if not (equal and same_soup):
        failures.append(f"{what}: streamed and plain differ (trajectory equal {equal}, soup equal "
                        f"{same_soup}; largest pose difference {worst})")
    if not (a_s <= ATE_LIMIT_M and a_p <= ATE_LIMIT_M and not overflow
            and sv.n_evictions and watch.reload_calls()):
        failures.append(f"{what}: ATE {a_s:.4f} / {a_p:.4f} m, overflow {overflow}, "
                        f"{sv.n_evictions} evictions, {watch.reload_calls()} reload calls")
    if counts[tk.KERNEL] != n or counts[odo.KERNEL] != n - 1:
        failures.append(f"{what}: launches {counts}, not B1 once a frame and B2 once a tracked "
                        "frame")
    return failures, counts


def deferral_check(dev, gpu: str):
    """A reload into a full pool (``tests/test_torch_streaming.py``'s
    ``test_reload_defers_when_pool_full`` on the phase's device): a 64-block
    pool of 2 cm voxels filled by corridor frames, a stored payload far
    away; a tick there defers its reload (the payload kept in the store,
    unchanged, the warning logged) and evicts the pool; the next tick's
    reload restores the block to the bit. Then a batch reloaded whole while
    the stream is busy, freed as its reload returns, and page-locked memory
    allocated and overwritten at once: every reloaded block equal to what
    was evicted, to the bit. Returns the failures."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.cli.bench import corridor_scene
    from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera
    from azurekinect3dreconstruction_tpu_torch.tsdf import streaming as st
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
    from azurekinect3dreconstruction_tpu_torch.tsdf.hash import pack_key_np

    cfg = TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8, block_capacity=64,
                     hash_capacity=256)
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)
    cam = SyntheticCamera(scene=corridor_scene(), intrinsics=intr, device=dev)
    rays = pixel_rays(intr, dev)
    R3 = cfg.block_resolution ** 3

    def fill(sv):
        for i in range(40):
            T = _corridor_pose(0.08 * i)
            z, c = cam.render(T)
            sv.vol = tsdf.integrate_frame(sv.vol, z, c, rays, torch.as_tensor(
                T, dtype=torch.float32, device=dev), intr, cfg)
            if int(sv.vol.n_blocks) == cfg.block_capacity - 1:
                return True
        return False

    warnings_ = []
    orig_warn = st.log_warning
    st.log_warning = warnings_.append
    try:
        sv = st.StreamingTSDF(cfg, evict_dist=1.4, reload_dist=1.1, high_water=0.5, device=dev)
        full = fill(sv)
        crd = np.array([50, 0, 3], np.int32)
        key = int(pack_key_np(crd[None])[0])
        rng = np.random.default_rng(0)
        payload = (rng.uniform(-1, 1, R3).astype(np.float32),
                   rng.integers(1, 30, R3).astype(np.float32),
                   rng.uniform(0, 1, (3, R3)).astype(np.float32))
        sv._store_payload(key, *payload, crd)
        sv._stored_cks[key] = 123
        far = (crd + 0.5) * cfg.block_size
        sv.tick(far)
        kept = key in sv.store and all(np.array_equal(a, b) for a, b in
                                       zip(sv._stored_payload(key)[:3], payload))
        logged = any("deferred reload" in w for w in warnings_)
        evicted = int(sv.vol.n_blocks)
        sv.tick(far)
        restored = False
        if key not in sv.store:
            n = int(sv.vol.n_blocks)
            keys = pack_key_np(sv.vol.block_coords[:n].cpu().numpy())
            slot = int(np.flatnonzero(keys == key)[0]) if (keys == key).any() else None
            restored = slot is not None and all(
                np.array_equal(getattr(sv.vol, f)[slot].cpu().numpy(), a)
                for f, a in zip(("tsdf", "weight", "color"), payload))
        _log(f"deferral: pool full {full}; the reload into it deferred, the warning logged "
             f"{logged}, the payload kept in the store unchanged {kept}; the tick's eviction left "
             f"{evicted} live; the next tick restored the block to the bit {restored}  [{gpu}]")
        failures = []
        if not (full and kept and logged and restored):
            failures.append(f"deferral: full {full}, kept {kept}, logged {logged}, restored "
                            f"{restored}")

        # a whole batch reloaded behind a busy stream and freed at once
        sv = st.StreamingTSDF(cfg, evict_dist=1.4, reload_dist=1.1, high_water=0.5, device=dev)
        fill(sv)
        n = int(sv.vol.n_blocks)
        ref = {int(k): tuple(getattr(sv.vol, f)[s].cpu().numpy() for f in ("tsdf", "weight", "color"))
               for s, k in enumerate(pack_key_np(sv.vol.block_coords[:n].cpu().numpy()))}
        sv.tick(far)  # evicts all into one batch
        stored = np.fromiter(sv.store, np.int32, len(sv.store))
        busy = None
        if dev.type == "cuda":
            busy = torch.randn(4096, 4096, device=dev)
            for _ in range(20):
                busy = busy @ busy / 4096.0
        sv._reload_keys(stored)
        freed = not sv._pbatch
        churn = [torch.empty((len(stored), R3), pin_memory=dev.type == "cuda").fill_(float("nan"))
                 for _ in range(16)]
        _sync(dev)
        n = int(sv.vol.n_blocks)
        keys = pack_key_np(sv.vol.block_coords[:n].cpu().numpy())
        same = len(keys) == len(ref) and all(
            all(np.array_equal(getattr(sv.vol, f)[s].cpu().numpy(), ref[int(k)][j])
                for j, f in enumerate(("tsdf", "weight", "color")))
            for s, k in enumerate(keys))
        behind = " behind 20 queued 4096^2 matmuls" if busy is not None else ""
        del churn, busy
        _log(f"deferral: {len(stored)} blocks evicted into one batch, reloaded whole{behind}, the "
             f"batch freed as the reload returned {freed}, "
             f"{'page-locked' if dev.type == 'cuda' else 'host'} memory allocated and overwritten "
             f"at once; every block equal to what was evicted, to the bit: {same}  [{gpu}]")
        if not (freed and same):
            failures.append(f"deferral: a batch freed after its reload {freed}, blocks equal "
                            f"{same}")
    finally:
        st.log_warning = orig_warn
    return failures


def _corridor_pose(x):
    """The corridor's camera pose at ``x`` m along it (4x4 float64)."""
    import numpy as np

    T = np.eye(4)
    T[0, 3] = x
    return T


def _unpack(keys):
    from azurekinect3dreconstruction_tpu_torch.tsdf.hash import unpack_key_np
    import numpy as np

    return unpack_key_np(np.asarray(keys, np.int32)) if keys else np.zeros((0, 3), np.int32)


def _centroid_set(soup):
    """A host triangle soup's triangle centroids rounded to 0.1 mm, as a set
    (tests/test_sharded_volume.py's parity measure)."""
    import numpy as np

    c = np.asarray(soup.vertices).reshape(-1, 3, 3).mean(1)
    return {tuple(x) for x in np.round(c, 4).tolist()}


def _meshes_match(a, b):
    """tests/test_sharded_volume.py's bounds on two host soups, ``b`` the
    reference: (ok, triangles of a, of b, share of b's rounded centroids
    that a holds)."""
    na, nb = a.triangles.shape[0], b.triangles.shape[0]
    ca, cb = _centroid_set(a), _centroid_set(b)
    overlap = len(ca & cb) / max(len(cb), 1)
    ok = nb > 0 and abs(na - nb) <= max(2, nb // 1000) and overlap > SHARDED_CENTROID_MIN
    return ok, na, nb, overlap


def sharded_phase(intr, cfg, cam, raw, mono_traj, mono_ms, dev, gpu: str,
                  dual_pairs: int = N_SHARDED_DUAL_PAIRS, cli: bool = True):
    """The sharded volume, ``parallel.sharded_volume``, in three parts.

    (a) The JAX bench's cell (``bench.py:224-255``): ``make_sharded_slam_batch``
    on a 1 x 1 mesh over the main path's frames, the launch counters zeroed
    just before and read just after: every fit > 0.3, the trajectory equal
    to the mono loop's (``mono_traj``) within 1e-5 (to the bit expected),
    no overflow, B1 and B2 exactly once a tracked frame; then
    ``sharded_slam_fps`` and ``sharded_slam_frame_ms`` by the bench's method
    (3 batches less 1, over 2 x 15 frames) beside the mono loop's ms/frame.
    (b) A 2 x 2 grid on ``dev``: two mounts, each tracking its own stream of
    the main sweep's relative motion, the counters zeroed just before and
    read just after: B2 once a camera a tracked frame, B1 once a camera a
    shard a tracked frame; each camera's poses against a
    ``compute_odometry_fast`` chain within 1e-4; disjoint shards;
    ``combine_shards`` extraction against a single volume fed the same
    frames at the same poses (triangle counts within max(2, n // 1000),
    rounded centroids shared > 0.999); then 2 sharded steps on the card
    against a CPU grid, shard by shard by block key with B1's tolerances.
    (c) ``DualCameraFusion(sharded=True, devices=[dev] * 4)`` over the
    first ``dual_pairs`` pairs of the bench rig's moving pass, beside the
    unsharded pipeline: B1 exactly 4 a pair, ms/pair synchronized per pair
    and with one sync; the combined volume against a single volume fed in
    the sharded order (both cameras allocate, then both integrate), by key
    and by mesh, and the unsharded pipeline's mesh, at the bounds of (b);
    the save read back; then, with ``cli``,
    ``cli.dual_fusion --sharded`` in a subprocess (one card: the fallback's
    warning) must save a mesh and a cloud. Returns (failures, the launch
    counts of each part)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.cli.bench import bench_rig
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.parallel import sharded_volume as sv
    from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import DualCameraFusion
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
    from azurekinect3dreconstruction_tpu_torch.viz.savers import read_obj, read_ply

    failures, counts = [], {}
    t_phase = time.perf_counter()
    tcfg = cfg.tsdf
    rays = pixel_rays(intr, dev)
    launched = lambda: {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    gc.collect()  # earlier phases' dropped volumes

    # -- a. the bench's cell: the SLAM batch on a 1 x 1 mesh --------------------------
    dec = [_decode(r, cfg, dev) for r in raw]
    n = len(dec)
    stack = lambda k: torch.stack([f[k] for f in dec])[None]
    depths, colors, intens = stack(0), stack(1), stack(2)
    eye = torch.eye(4, device=dev)[None]
    m11 = sv.make_mesh(1, 1, [dev])
    batch = sv.make_sharded_slam_batch(m11, intr, cfg, stride=2, worklist_size=2048)
    run = lambda v: batch(v, eye, intens, depths, colors, rays)
    run(sv.create_sharded(tcfg, m11))
    _sync(dev)
    build.launches.clear()
    vol, poses, fits = run(sv.create_sharded(tcfg, m11))
    _sync(dev)
    counts["sharded"] = launched()
    fit = fits.cpu().numpy()[0]
    dtraj = float(np.abs(poses.cpu().numpy()[0].astype(np.float64) - np.stack(mono_traj)).max())
    overflow = bool(vol.overflow.any())
    del vol

    def sharded_run(k):
        t0 = time.perf_counter()
        v = sv.create_sharded(tcfg, m11)
        for _ in range(k):
            v, _, _ = run(v)
        _sync(dev)
        return time.perf_counter() - t0

    sh1 = min(sharded_run(1) for _ in range(2))
    sh3 = min(sharded_run(3) for _ in range(2))
    frame_ms = (sh3 - sh1) / (2 * (n - 1)) * 1e3
    _log(f"sharded 1x1 SLAM batch launches: {json.dumps(counts['sharded'])} over {n} frames  "
         f"[{gpu}]")
    _log(f"sharded 1x1 SLAM batch (bench.py's cell): min fit {fit.min():.4f}, trajectory vs the "
         f"mono loop max |dpose| {dtraj:.3g} (equal to the bit: {dtraj == 0.0}), overflow "
         f"{overflow}; sharded_slam_fps {1e3 / frame_ms:.3f}, sharded_slam_frame_ms "
         f"{frame_ms:.3f} (bench.py's method: 3 batches less 1 over 2 x {n - 1} frames, host "
         f"clock, min of 2) beside the mono loop's {mono_ms:.3f} ms/frame (one sync)  [{gpu}]")
    if not (fit > 0.3).all():
        failures.append(f"sharded 1x1: a fit under 0.3 ({fit.min():.4f})")
    if not dtraj <= SHARDED_TRAJ_TOL:
        failures.append(f"sharded 1x1: trajectory {dtraj:.3g} off the mono loop's")
    if overflow:
        failures.append("sharded 1x1: volume overflow")
    if counts["sharded"] != {tk.KERNEL: n - 1, odo.KERNEL: n - 1}:
        failures.append(f"sharded 1x1 launches {counts['sharded']}, not B1 and B2 once a "
                        "tracked frame")
    del depths, colors, intens, dec

    # -- b. a 2 x 2 grid on one device: two mounts, each its own stream -----------------
    sweep = orbit_trajectory(64, radius=0.35, angle_span=1.3)[:n]
    mounts = orbit_trajectory(2, radius=0.25, angle_span=0.5)
    rel = [np.linalg.inv(sweep[0]) @ T for T in sweep]
    streams = [[_decode(_quantize(cam.render(M @ R)), cfg, dev) for R in rel] for M in mounts]
    grid = lambda k: torch.stack([torch.stack([f[k] for f in s]) for s in streams])
    D2, C2, I2 = grid(0), grid(1), grid(2)
    del streams
    T0 = torch.as_tensor(np.stack(mounts), dtype=torch.float32, device=dev)
    m22 = sv.make_mesh(2, 2, [dev] * 4)
    batch22 = sv.make_sharded_slam_batch(m22, intr, cfg, stride=2, worklist_size=2048)
    vol22 = sv.create_sharded(tcfg, m22)
    _sync(dev)
    build.launches.clear()
    t0 = time.perf_counter()
    vol22, poses22, fits22 = batch22(vol22, T0, I2, D2, C2, rays)
    _sync(dev)
    grid_ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    counts["grid"] = launched()
    errs = []
    for c in range(2):
        T = mounts[c].astype(np.float64)
        for f in range(1, n):
            res = odo.compute_odometry_fast(I2[c, f - 1], D2[c, f - 1], I2[c, f], D2[c, f], intr,
                                            cfg.odometry)
            T = T @ np.linalg.inv(res.T_target_source.cpu().numpy().astype(np.float64))
            d = se3.se3_log(torch.as_tensor(np.linalg.inv(T) @ poses22[c, f - 1].cpu().numpy()))
            errs.append(float(d.norm()))
    keys = [set(map(tuple, s.block_coords[:int(s.n_blocks)].cpu().tolist()))
            for s in vol22.shards]
    disjoint = not (keys[0] & keys[1])
    single = tsdf.create(tcfg, dev)
    for f in range(1, n):
        for c in range(2):
            single = tsdf.allocate(single, D2[c, f], rays, poses22[c, f - 1], tcfg, stride=2)
        for c in range(2):
            single = tk.integrate_worklist(single, D2[c, f], C2[c, f], poses22[c, f - 1], intr,
                                           tcfg, 2048)
    combined = sv.combine_shards(vol22, tcfg, 2)
    same_keys, frac, err_t, err_c = _volumes_by_key(combined, single)
    t0 = time.perf_counter()
    mesh_c = mc.extract_mesh(combined, tcfg).compact()
    combine_extract_ms = (time.perf_counter() - t0) * 1e3
    ok_mesh, nt_c, nt_s, overlap = _meshes_match(mesh_c, mc.extract_mesh(single, tcfg).compact())
    overflow = bool(vol22.overflow.any()) or bool(single.overflow)
    fit22 = fits22.cpu().numpy()
    _log(f"sharded 2x2 grid launches: {json.dumps(counts['grid'])} over 2 cameras x {n} frames  "
         f"[{gpu}]")
    _log(f"sharded 2x2 grid (two mounts on one device): {grid_ms:.3f} ms a frame of both cameras "
         f"(host clock, one sync); min fit {fit22.min():.4f}; poses vs compute_odometry_fast "
         f"chains max |se3 log| {max(errs):.3g}; shard blocks {[len(k) for k in keys]}, disjoint "
         f"{disjoint}; combined vs a single volume fed the same frames: same keys {same_keys}, "
         f"weights equal on {frac:.6%}, max |dtsdf| {err_t:.3g}, max |dcolor| {err_c:.3g}; "
         f"meshes {nt_c} / {nt_s} triangles, centroids shared {overlap:.6f}; combine_shards + "
         f"extract_mesh {combine_extract_ms:.1f} ms (host clock); overflow {overflow}  [{gpu}]")
    if counts["grid"] != {tk.KERNEL: 4 * (n - 1), odo.KERNEL: 2 * (n - 1)}:
        failures.append(f"sharded 2x2 launches {counts['grid']}, not B1 4 and B2 2 a frame")
    if not ((fit22 > 0.3).all() and max(errs) < SHARDED_POSE_TOL):
        failures.append(f"sharded 2x2: tracking off (min fit {fit22.min():.4f}, pose "
                        f"{max(errs):.3g})")
    if not (disjoint and ok_mesh and not overflow):
        failures.append(f"sharded 2x2: disjoint {disjoint}, meshes {nt_c} / {nt_s} with "
                        f"{overlap:.6f} shared, overflow {overflow}")
    del single, combined, mesh_c, vol22

    cpu = torch.device("cpu")
    mcpu = sv.make_mesh(2, 2, [cpu] * 4)
    vg, vc = sv.create_sharded(tcfg, m22), sv.create_sharded(tcfg, mcpu)
    step_g = sv.make_sharded_step(m22, intr, tcfg, stride=2, worklist_size=2048)
    step_c = sv.make_sharded_step(mcpu, intr, tcfg, stride=2, worklist_size=2048)
    t0 = time.perf_counter()
    for f in (1, 2):
        vg = step_g(vg, D2[:, f], C2[:, f], poses22[:, f - 1], rays)
        vc = step_c(vc, D2[:, f].cpu(), C2[:, f].cpu(), poses22[:, f - 1].cpu(), rays.cpu())
    by_key = [_volumes_by_key(a, b) for a, b in zip(vg.shards, vc.shards)]
    _log(f"sharded 2x2 steps card vs CPU grid over 2 frames, by shard: same keys / weights equal "
         f"/ max |dtsdf| / max |dcolor| {[(k, round(w, 6), t, c) for k, w, t, c in by_key]} "
         f"({time.perf_counter() - t0:.1f} s)")
    if not all(k and w >= B1_WEIGHT_EQUAL_MIN and t <= B1_VALUE_TOL and c <= B1_VALUE_TOL
               for k, w, t, c in by_key):
        failures.append("sharded 2x2 steps on the card differ from the CPU grid")
    del vg, vc, D2, C2, I2

    # -- c. the dual pipeline, sharded on [dev] * 4 beside unsharded ---------------------
    rig = bench_rig()
    moving = [((cam.capture(T), cam.capture(T @ rig)), T, T @ rig) for T in sweep[:dual_pairs]]
    tmp = tempfile.TemporaryDirectory()

    def dual(sharded):
        p = DualCameraFusion((intr, intr), cfg, device=dev, output_dir=tmp.name, sharded=sharded,
                             devices=[dev] * 4 if sharded else None)
        p.calibrated = True
        return p

    def fuse(p, each):
        ms = []
        t0 = t_all = time.perf_counter()
        for pr, A, B in moving:
            p.extrinsics = [A, B]
            p.process_frames(pr)
            if each:
                _sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
        _sync(dev)
        return ms if each else (time.perf_counter() - t_all) * 1e3 / len(moving)

    med = lambda a: sorted(a)[len(a) // 2]
    ps = dual(True)
    _sync(dev)
    build.launches.clear()
    ms_s = fuse(ps, True)
    counts["dual"] = launched()
    one_s = fuse(dual(True), False)
    pu = dual(False)
    ms_u = fuse(pu, True)
    one_u = fuse(dual(False), False)
    # the sharded step's order on one volume: both cameras allocate, then both integrate
    ref = tsdf.create(tcfg, dev)
    for pr, A, B in moving:
        dec2 = [_decode(r, cfg, dev) for r in pr]
        Ts = [torch.as_tensor(T, dtype=torch.float32, device=dev) for T in (A, B)]
        for (d, _, _), T in zip(dec2, Ts):
            ref = tsdf.allocate(ref, d, rays, T, tcfg, stride=2)
        for (d, c, _), T in zip(dec2, Ts):
            ref = tk.integrate_worklist(ref, d, c, T, intr, tcfg, 2048)
    combined = ps.extraction_volume()
    same_keys, frac, err_t, err_c = _volumes_by_key(combined, ref)
    mesh_s = mc.extract_mesh(combined, tcfg).compact()
    ok_ref, _, nt_r, overlap_r = _meshes_match(mesh_s, mc.extract_mesh(ref, tcfg).compact())
    _, nt_s, nt_u, overlap = _meshes_match(mesh_s, mc.extract_mesh(pu.volume, tcfg).compact())
    ok_unsharded = abs(nt_s - nt_u) <= max(2, nt_u // 1000) and overlap > SHARDED_CENTROID_MIN
    del combined, ref, mesh_s
    overflow = bool(ps.volume.overflow.any()) or bool(pu.volume.overflow)
    t0 = time.perf_counter()
    paths = ps.save_current_state()
    save_ms = (time.perf_counter() - t0) * 1e3
    cv, ccol, _ = read_ply(paths["pointcloud"]) if "pointcloud" in paths else (None,) * 3
    mv, _, mf = read_obj(paths["mesh"])
    ok_save = (cv is not None and len(cv) > 1000 and np.isfinite(cv).all() and ccol is not None
               and mf is not None and len(mf) > 1000 and np.isfinite(mv).all()
               and mf.max() < len(mv))
    _log(f"sharded dual launches: {json.dumps(counts['dual'])} over {dual_pairs} pairs  [{gpu}]")
    _log(f"sharded dual ({ps.mesh.shape}, the bench rig's moving pass): ms/pair synchronized per "
         f"pair median {med(ms_s):.3f} (min {min(ms_s):.3f}, max {max(ms_s):.3f}), one sync "
         f"{one_s:.3f}; unsharded median {med(ms_u):.3f} (min {min(ms_u):.3f}, max "
         f"{max(ms_u):.3f}), one sync {one_u:.3f} (host clock); combined vs a single volume "
         f"in the sharded order: same keys {same_keys}, weights equal on {frac:.6%}, max "
         f"|dtsdf| {err_t:.3g}, max |dcolor| {err_c:.3g}, meshes {nt_s} / {nt_r} triangles, "
         f"centroids shared {overlap_r:.6f}; vs unsharded {nt_s} / {nt_u}, centroids shared "
         f"{overlap:.6f}; save {save_ms:.1f} ms (host) read back "
         f"{ok_save} ({0 if cv is None else len(cv)} points, {0 if mf is None else len(mf)} "
         f"triangles); overflow {overflow}  [{gpu}]")
    if counts["dual"] != {tk.KERNEL: 4 * dual_pairs, odo.KERNEL: 0}:
        failures.append(f"sharded dual launches {counts['dual']}, not B1 4 a pair")
    same_voxels = (same_keys and frac >= B1_WEIGHT_EQUAL_MIN and err_t <= B1_VALUE_TOL
                   and err_c <= B1_VALUE_TOL)
    if not (ps.sharded and same_voxels and ok_ref and ok_unsharded and ok_save and not overflow):
        failures.append(f"sharded dual: sharded {ps.sharded}, same voxels {same_voxels}, meshes "
                        f"{nt_s} / {nt_r} ({overlap_r:.6f} shared) / {nt_u} unsharded "
                        f"({overlap:.6f}), save {ok_save}, overflow {overflow}")
    del ps, pu
    tmp.cleanup()

    if cli:
        with tempfile.TemporaryDirectory() as out:
            args = ["--source", "synthetic", "--frames", str(dual_pairs), "--sharded",
                    "--output", out]
            if dev.type != "cuda":
                args += ["--device", "cpu", "--scale", "0.25"]
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", f"{PKG}.cli.dual_fusion", *args],
                               capture_output=True, text=True, timeout=600, cwd=REPO)
            names = sorted(os.listdir(out))
            saved = "latest_mesh.obj" in names and "latest_merged.ply" in names
            said = r.stdout + r.stderr
            fallback = "falling back to single-device" in said
            tail = [ln for ln in said.splitlines() if "pairs," in ln or "sharded" in ln]
            _log(f"cli.dual_fusion --sharded over {dual_pairs} pairs: rc {r.returncode}, "
                 f"{time.perf_counter() - t0:.1f} s (host clock, process start included), wrote "
                 f"{names}; {' | '.join(tail)}")
            one_card = dev.type != "cuda" or torch.cuda.device_count() < 2
            if r.returncode != 0 or not saved or fallback != one_card:
                failures.append(f"cli.dual_fusion --sharded: rc {r.returncode}, wrote {names}, "
                                f"fallback {fallback}; {r.stderr[-1500:]}")
    _log(f"sharded phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)  [{gpu}]")
    return failures, counts


def _equal_by_key(va, vb) -> bool:
    """Two volumes hold the same block keys with every pool row equal, to
    the bit (tsdf, weight and color)."""
    import numpy as np

    rows = _matched_rows(va, vb)
    return rows is not None and all(np.array_equal(*rows(f)) for f in ("tsdf", "weight", "color"))


def _feeder_overlap(prof):
    """From a ``torch.profiler`` trace of a fed loop: (the device's idle
    share of the window from its first to its last device event, the share
    of host-to-device copy time that overlaps a kernel, copies, kernels);
    (None, None, 0, 0) when the trace holds no device events."""
    def union(iv):
        total, end = 0.0, float("-inf")
        for a, b in sorted(iv):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    kernels, copies = [], []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        iv = (e.time_range.start, e.time_range.end)
        if "Memcpy HtoD" in e.name:
            copies.append(iv)
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append(iv)
    if not kernels:
        return None, None, 0, 0
    every = kernels + copies
    span = max(b for _, b in every) - min(a for a, _ in every)
    idle = 1.0 - union(every) / span if span > 0 else None
    copy_time = sum(b - a for a, b in copies)
    overlapped = sum(union([(max(a, c), min(b, d)) for c, d in kernels if c < b and d > a])
                     for a, b in copies)
    return idle, (overlapped / copy_time if copy_time > 0 else None), len(copies), len(kernels)


def fed_loop_syncs(pipe, host, dev):
    """``pipe`` (reset) over ``host`` frames fed through ``prefetch_to_device``
    with torch's sync-debug mode at "warn" on a card: the synchronizing
    calls of each frame (a list of warnings a frame, the feeder's puts for
    the next frame included), and how many of the feeder's puts found
    their staging set's last copy still in flight (the reuse wait, an
    event wait, which the mode does not report)."""
    import warnings

    import torch

    from azurekinect3dreconstruction_tpu_torch.io import streams

    pipe.reset()
    _sync(dev)
    orig = streams.DeviceFeeder._upload
    waits = {"puts": 0, "busy": 0}

    def upload(self, leaves):
        waits["puts"] += 1
        slot = self._staging[self._n_put % self.depth]
        waits["busy"] += int(slot is not None and not slot[1].query())
        return orig(self, leaves)

    syncs = []
    streams.DeviceFeeder._upload = upload
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                seen = 0
                for d, c in streams.prefetch_to_device(iter(host), device=dev):
                    pipe.process_frame(d, c)
                    syncs.append([w for w in caught[seen:] if "synchroniz" in str(w.message)
                                  and "prototype feature" not in str(w.message)])
                    seen = len(caught)
            finally:
                if dev.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
    finally:
        streams.DeviceFeeder._upload = orig
    _sync(dev)
    return syncs, waits


def device_step_phase(cfg, cam, raw, mono_traj, dev, gpu: str, n_sweep: int = N_SWEEP,
                      n_slam: int = N_SLAM_BATCH, n_fed: int = N_FED):
    """The device-resident step and batches and the frame feeder, by
    ``bench.py``'s methods at its configuration (``cfg``, ``cam``'s
    intrinsics), each with the launch counters zeroed just before and read
    just after.

    (a) ``make_fused_batch_fn`` (``bench.py:67-121``): a 32-frame warmup on
    its own trajectory into a volume then dropped; the ``n_sweep``-pose
    sweep (rendered, not quantized) cold in two half batches: ``n_blocks``
    grows between them, B1 exactly once a frame, no overflow, the volume
    equal by key, to the bit, to ``n_sweep`` calls of ``integrate_step``;
    ``fused_cold_fps`` from the min of 3 cold passes, ``fused_steady_fps``
    from the warm repass slope ((3 half batches - 1) / 2 x n_sweep / 2).
    (b) ``make_device_slam_batch`` (``bench.py:165-221``): the first
    ``n_slam`` sweep renders, B2 and B1 once each a tracked frame, min fit
    > 0.3, ``slam_batch_fps`` by the (3 batches - 1 batch) / 2 (n_slam - 1)
    slope; on the main path's decoded frames (``raw``) the poses equal to
    the mono loop's (``mono_traj``) and to a 1 x 1 ``make_sharded_slam_batch``'s,
    to the bit; ``slam_ate`` / ``slam_rpe`` over the whole sweep.
    (c) ``prefetch_to_device`` (``bench.py:259-290``): ``MonoOdometryTSDF``
    over the first ``n_fed`` sweep frames quantized to u16 / u8 on the
    host, fed through the feeder with one sync at the end
    (``pipeline_fps``), its trajectory equal to the same loop fed host
    arrays, to the bit; ``h2d_mbps`` by the bench's method (4 x 2 MiB
    pageable uploads, one sync); on a card, the feeder's overlap from a
    ``torch.profiler`` trace of the fed loop (device idle share, share of
    copy time under a kernel). Returns (failures, the launch counts of each
    part)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu_torch.io.streams import prefetch_to_device
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory
    from azurekinect3dreconstruction_tpu_torch.ops.image import rgb_to_intensity
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.parallel import sharded_volume as sv
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
        make_device_slam_batch,
    )
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate, rpe

    failures, counts = [], {}
    t_phase = time.perf_counter()
    tcfg, intr = cfg.tsdf, cam.intrinsics
    rays = pixel_rays(intr, dev)
    launched = lambda: {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    gc.collect()

    def render_all(poses):
        r = [cam.render(T) for T in poses]
        return (torch.stack([z for z, _ in r]), torch.stack([c for _, c in r]),
                torch.as_tensor(np.stack(poses), dtype=torch.float32, device=dev))

    sweep = orbit_trajectory(n_sweep, radius=0.35, angle_span=1.3)
    depths, colors, posearr = render_all(sweep)
    half = n_sweep // 2

    # -- a. the fused batch ------------------------------------------------------------
    batch = tk.make_fused_batch_fn(intr, tcfg, 2048, 2)
    wd, wc, wp = render_all(orbit_trajectory(32, radius=0.3, angle_span=1.2,
                                             center=(0.05, 0.05, 1.3)))
    batch(tsdf.create(tcfg, dev), wd, wc, wp, rays)
    _sync(dev)
    del wd, wc, wp
    build.launches.clear()
    vol = batch(tsdf.create(tcfg, dev), depths[:half], colors[:half], posearr[:half], rays)
    n_mid = int(vol.n_blocks)
    vol = batch(vol, depths[half:], colors[half:], posearr[half:], rays)
    _sync(dev)
    counts["fused"] = launched()
    n_blocks, overflow = int(vol.n_blocks), bool(vol.overflow)
    ref = tsdf.create(tcfg, dev)
    for f in range(n_sweep):
        ref = tk.integrate_step(ref, depths[f], colors[f], posearr[f], rays, intr, tcfg, 2048, 2)
    equal = _equal_by_key(vol, ref)
    del ref

    def cold_pass():
        t0 = time.perf_counter()
        v = batch(tsdf.create(tcfg, dev), depths[:half], colors[:half], posearr[:half], rays)
        v = batch(v, depths[half:], colors[half:], posearr[half:], rays)
        float(v.weight.sum())
        return time.perf_counter() - t0

    cold = [cold_pass() for _ in range(3)]
    state = {"v": vol}

    def repass(k):
        t0 = time.perf_counter()
        v = state["v"]
        for _ in range(k):
            v = batch(v, depths[:half], colors[:half], posearr[:half], rays)
        float(v.weight.sum())
        state["v"] = v
        return time.perf_counter() - t0

    repass(1)
    t1 = min(repass(1) for _ in range(2))
    t3 = min(repass(3) for _ in range(2))
    del state, vol
    fused_cold_fps = n_sweep / min(cold)
    fused_steady_fps = 2 * half / (t3 - t1)
    _log(f"fused batch launches: {json.dumps(counts['fused'])} over one cold pass of {n_sweep} "
         f"frames  [{gpu}]")
    _log(f"fused batch (bench.py's method, make_fused_batch_fn, worklist 2048, stride 2): "
         f"fused_cold_fps {fused_cold_fps:.3f} (min of 3 cold passes {min(cold) * 1e3:.1f} ms, "
         f"all {[round(t * 1e3, 1) for t in cold]}), fused_steady_fps {fused_steady_fps:.3f} "
         f"(warm repass slope, {(t3 - t1) * 1e3 / (2 * half):.3f} ms/frame); n_blocks {n_mid} "
         f"after {half} frames, {n_blocks} after {n_sweep}; overflow {overflow}; equal to "
         f"{n_sweep} integrate_step calls by key, to the bit: {equal} (host clock)  [{gpu}]")
    if counts["fused"] != {tk.KERNEL: n_sweep, odo.KERNEL: 0}:
        failures.append(f"fused batch launches {counts['fused']}, not B1 once a frame")
    if not (0 < n_mid < n_blocks and not overflow and equal):
        failures.append(f"fused batch: n_blocks {n_mid} -> {n_blocks}, overflow {overflow}, "
                        f"equal to integrate_step {equal}")

    # -- b. the SLAM batch -------------------------------------------------------------
    slam = make_device_slam_batch(intr, cfg, worklist_size=2048, stride=2)
    intens = torch.stack([rgb_to_intensity(c) for c in colors[:n_slam]])
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    run = lambda v: slam(v, eye, intens, depths[:n_slam], colors[:n_slam], rays)
    run(tsdf.create(tcfg, dev))
    _sync(dev)
    build.launches.clear()
    svol, _, fits = run(tsdf.create(tcfg, dev))
    _sync(dev)
    counts["slam"] = launched()
    min_fit, s_overflow = float(fits.min()), bool(svol.overflow)
    del svol

    def slam_run(k):
        t0 = time.perf_counter()
        v, _, _ = run(tsdf.create(tcfg, dev))
        for _ in range(k - 1):
            v, _, _ = run(v)
        float(v.weight.sum())
        return time.perf_counter() - t0

    s1 = min(slam_run(1) for _ in range(2))
    s3 = min(slam_run(3) for _ in range(2))
    slam_ms = (s3 - s1) / (2 * (n_slam - 1)) * 1e3
    # the mono loop's own decoded frames: the same poses as the loop and the 1 x 1 grid
    dec = [_decode(r, cfg, dev) for r in raw]
    dD, dC, dI = (torch.stack([f[k] for f in dec]) for k in range(3))
    _, mposes, _ = slam(tsdf.create(tcfg, dev), eye, dI, dD, dC, rays)
    m11 = sv.make_mesh(1, 1, [dev])
    _, sposes, _ = sv.make_sharded_slam_batch(m11, intr, cfg, stride=2, worklist_size=2048)(
        sv.create_sharded(tcfg, m11), eye[None], dI[None], dD[None], dC[None], rays)
    mposes = mposes.cpu().numpy()
    eq_mono = np.array_equal(mposes.astype(np.float64), np.stack(mono_traj))
    eq_sharded = np.array_equal(mposes, sposes[0].cpu().numpy())
    del dec, dD, dC, dI
    # tracking accuracy over the whole sweep
    intens_all = torch.stack([rgb_to_intensity(c) for c in colors])
    _, traj_all, fits_all = slam(tsdf.create(tcfg, dev), eye, intens_all, depths, colors, rays)
    est = traj_all.cpu().numpy().astype(np.float64)
    gt0 = np.linalg.inv(sweep[0])
    gt = np.stack([gt0 @ T for T in sweep[1:]])
    slam_ate, slam_rpe = ate(est, gt), rpe(est, gt)
    del intens_all, traj_all, intens
    _log(f"SLAM batch launches: {json.dumps(counts['slam'])} over one {n_slam}-frame batch  "
         f"[{gpu}]")
    _log(f"SLAM batch (bench.py's method, make_device_slam_batch): slam_batch_fps "
         f"{1e3 / slam_ms:.3f}, {slam_ms:.3f} ms/frame ((3 batches - 1) / 2 x {n_slam - 1} "
         f"frames, host clock, min of 2); min fit {min_fit:.4f}, overflow {s_overflow}; on the "
         f"mono loop's decoded frames the poses equal the mono loop's to the bit: {eq_mono}, "
         f"the 1 x 1 sharded batch's: {eq_sharded}; over the {n_sweep}-pose sweep slam_ate "
         f"rmse {slam_ate['rmse'] * 1e3:.3f} mm (max {slam_ate['max'] * 1e3:.3f} mm), slam_rpe "
         f"trans {slam_rpe['trans_rmse'] * 1e3:.3f} mm rot "
         f"{np.degrees(slam_rpe['rot_rmse']):.4f} deg, min fit "
         f"{float(fits_all.min()):.4f}  [{gpu}]")
    if counts["slam"] != {tk.KERNEL: n_slam - 1, odo.KERNEL: n_slam - 1}:
        failures.append(f"SLAM batch launches {counts['slam']}, not B1 and B2 once a tracked "
                        "frame")
    if not (min_fit > 0.3 and not s_overflow and eq_mono and eq_sharded):
        failures.append(f"SLAM batch: min fit {min_fit:.4f}, overflow {s_overflow}, equal to the "
                        f"mono loop {eq_mono}, to the sharded batch {eq_sharded}")
    if not slam_ate["rmse"] <= ATE_LIMIT_M:
        failures.append(f"SLAM batch ATE {slam_ate['rmse']:.4f} m over {ATE_LIMIT_M} m")

    # -- c. the feeder -----------------------------------------------------------------
    host = [_quantize((depths[i], colors[i])) for i in range(n_fed)]
    del depths, colors, posearr
    pipe = MonoOdometryTSDF(intr, cfg, device=dev, worklist_size=2048)
    for d, c in host[:3]:
        pipe.process_frame(d, c)
    _sync(dev)

    def fed_loop(feed: bool):
        pipe.reset()
        _sync(dev)
        t0 = time.perf_counter()
        for d, c in (prefetch_to_device(iter(host), device=dev) if feed else host):
            pipe.process_frame(d, c)
        _sync(dev)
        return (time.perf_counter() - t0) / len(host), np.stack(pipe.trajectory)

    build.launches.clear()
    fed_dt, fed_traj = fed_loop(True)
    counts["fed"] = launched()
    unfed_dt, unfed_traj = fed_loop(False)
    fed_equal = np.array_equal(fed_traj, unfed_traj)
    # in turns (fed, unfed, unfed, fed): the host's pace drifts within a run
    unfed_dt = [unfed_dt, fed_loop(False)[0]]
    fed_dt = [fed_dt, fed_loop(True)[0]]
    bufs = [np.random.default_rng(i).integers(0, 255, 2 << 20, dtype=np.uint8) for i in range(4)]
    torch.from_numpy(bufs[0]).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    up = [torch.from_numpy(b).to(dev) for b in bufs]
    _sync(dev)
    h2d_mbps = len(bufs) * 2.0 / (time.perf_counter() - t0)
    del up
    idle = overlap = None
    n_copies = n_kernels = 0
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fed_loop(True)
        idle, overlap, n_copies, n_kernels = _feeder_overlap(prof)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
    syncs, waits = fed_loop_syncs(pipe, host, dev)
    later = sum(len(x) for x in syncs[1:])
    where = sorted({f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                    for x in syncs for w in x})
    _log(f"fed loop synchronizing calls (torch.cuda.set_sync_debug_mode('warn'), by frame): first "
         f"frame {len(syncs[0]) if syncs else 0}, frames 1-{len(syncs) - 1} {later} "
         f"({' '.join(str(len(x)) for x in syncs)}) at {where}, the feeder's included; its "
         f"staging-ring reuse waited on a copy in flight at "
         f"{waits['busy']} of {waits['puts']} puts (an event wait, which the sync-debug mode "
         f"does not report)  [{gpu}]")
    if later:
        failures.append(f"the fed loop synchronized {later} times after its first frame: "
                        f"{where}")
    _log(f"feeder launches: {json.dumps(counts['fed'])} over {n_fed} fed frames  [{gpu}]")
    ms = lambda ts: ", ".join(f"{t * 1e3:.3f}" for t in ts)
    _log(f"feeder (bench.py's method, MonoOdometryTSDF over prefetch_to_device, one sync): "
         f"pipeline_fps {1.0 / fed_dt[0]:.3f} ({fed_dt[0] * 1e3:.3f} ms/frame); in turns fed "
         f"{ms(fed_dt)} ms/frame (first, last) and unfed {ms(unfed_dt)} (second, third); "
         f"trajectory equal to the unfed loop's to the bit: "
         f"{fed_equal}; h2d_mbps {h2d_mbps:.1f} (4 x 2 MiB pageable uploads, one sync); "
         f"profiled fed loop: device idle share {fmt(idle)}, share of copy time under a kernel "
         f"{fmt(overlap)} ({n_copies} host-to-device copies, {n_kernels} device kernels) "
         f"(host clock; torch.profiler)  [{gpu}]")
    if counts["fed"] != {tk.KERNEL: n_fed, odo.KERNEL: n_fed - 1}:
        failures.append(f"feeder launches {counts['fed']}, not B1 once a frame and B2 once a "
                        "tracked frame")
    if not fed_equal:
        failures.append("the fed loop's trajectory differs from the unfed loop's")
    del pipe
    _log(f"device step phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)  "
         f"[{gpu}]")
    return failures, counts


def _png_rgb(path):
    """(height, width, 3) u8 pixels of a PNG that ``viz.render.write_png``
    wrote (8-bit RGB, filter 0 rows)."""
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.rindex(b"IEND") - 4])
    return np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def _native_missing() -> list:
    """What the native runtime's build needs and this machine lacks."""
    import shutil

    return [what for what, ok in (("g++", shutil.which("g++")),
                                  ("zlib.h", os.path.exists("/usr/include/zlib.h"))) if not ok]


def native_build() -> list:
    """Build and load ``io.native``'s library once, before any phase saves a
    PLY, so that no timed save holds the compile; its time on a line of its
    own. Without g++ or zlib's header it says why (the savers then write in
    Python); any other failed build fails the run. Returns the failures."""
    from azurekinect3dreconstruction_tpu_torch.io import native

    missing = _native_missing()
    if missing:
        _log(f"native runtime not built: this machine has no {' and no '.join(missing)}, so "
             "the savers write in Python")
        return []
    t0 = time.perf_counter()
    try:
        native.load()
    except (RuntimeError, OSError) as e:
        return [f"the native runtime did not build or load: {e}"]
    _log(f"native runtime built (g++) and loaded in {time.perf_counter() - t0:.2f} s -> "
         f"{os.path.relpath(str(native.library_path()), REPO)}")
    return []


def _native_check(mesh, cloud, gpu: str) -> list:
    """``io.native``'s binary PLY writers against the Python writers on the
    served mesh and cloud: the same bytes. Without g++ or zlib's header the
    check says why on a line of its own and is not made; any other failed
    build fails the run. Returns the failures."""
    from azurekinect3dreconstruction_tpu_torch.io import native
    from azurekinect3dreconstruction_tpu_torch.viz import savers

    missing = _native_missing()
    if missing:
        _log(f"native PLY check not made: this machine has no {' and no '.join(missing)}, so "
             f"the savers write in Python  [{gpu}]")
        return []
    try:
        native.load()  # built by native_build before the phases
    except (RuntimeError, OSError) as e:
        return [f"the native runtime did not build or load: {e}"]
    same = {}
    with tempfile.TemporaryDirectory() as td:
        for name, geom in (("mesh", mesh), ("cloud", cloud)):
            a, b = os.path.join(td, f"native_{name}.ply"), os.path.join(td, f"python_{name}.ply")
            if name == "mesh":
                ok = native.write_ply_mesh_native(a, geom.vertices, geom.triangles,
                                                  geom.vertex_colors)
            else:
                ok = native.write_ply_points_native(a, geom.points, geom.colors, geom.normals)
            avail = native.is_available
            native.is_available = lambda: False  # the savers' Python path
            try:
                (savers.write_ply_mesh if name == "mesh" else savers.write_ply_point_cloud)(b, geom)
            finally:
                native.is_available = avail
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same[name] = bool(ok) and fa.read() == fb.read()
    _log(f"native PLY writers ({os.path.relpath(str(native.library_path()), REPO)}): bytes "
         f"equal to the Python writers' for the served mesh "
         f"({mesh.triangles.shape[0]} triangles) {same['mesh']} and cloud "
         f"({cloud.points.shape[0]} points) {same['cloud']}  [{gpu}]")
    return [] if all(same.values()) else ["the native PLY bytes differ from the Python writers'"]


def serve_phase(intr, cfg, raw, dev, gpu: str, turns: int = SERVE_TURNS):
    """The live session at full width: ``cli.live_mono``'s loop
    (``LiveSession.run``, the frames through ``prefetch_to_device``) over
    ``raw``, headless, then served by a ``BrowserLiveViewer`` on 127.0.0.1
    with a thread polling ``/meta.json`` and fetching each new
    ``/geometry.bin`` as the page does, and ``M`` / ``S`` sent over HTTP at
    ``SERVE_KEY_FRAMES``, frames that are not vis frames. Checks, the
    counters zeroed just before the served run and read just after: B1 once
    a frame and B2 once a tracked frame; the trajectory equal to the
    headless run's to the bit; on the card, no synchronizing call between
    the previous frame's end and a key's arrival (and whether the stream
    still had work pending then, logged); each key queued until that
    frame's ``tick`` and acting there; at the last mesh-mode vis frame the
    sent soup equal to
    ``extract_mesh`` of that volume (count and centroid set at 5 decimals)
    and the ``geometry.bin`` of that revision equal to its pack (decimated
    whole triangles past the viewer's 2,000,000 vertices); at the last
    cloud-mode vis frame the sent cloud equal to ``extract_point_cloud(
    max_points=200000)`` and its bytes to its pack; the status line's frame
    and a finite rate; the save (mesh, cloud, trajectory, preview) read
    back; the native PLY writers. Then ms/frame of the loop headless,
    served in cloud mode and served in mesh mode, in turns (median of
    ``turns``; the page thread runs through each served turn and not
    through the headless ones), the vis frames' ``inc.update`` and
    ``pack_geometry`` ms,
    one ``geometry.bin``'s bytes, and the synchronizing calls by frame of a
    served run (``torch.cuda.set_sync_debug_mode``). Returns (failures,
    launches)."""
    import shutil
    import statistics
    import threading
    import urllib.request
    import warnings

    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.cli.common import NullViewer
    from azurekinect3dreconstruction_tpu_torch.cli.live_mono import LiveSession
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )
    from azurekinect3dreconstruction_tpu_torch.viz.live_server import (
        MAGIC,
        BrowserLiveViewer,
        pack_geometry,
    )
    from azurekinect3dreconstruction_tpu_torch.viz.savers import ResultSaver, read_ply

    t_phase = time.perf_counter()
    failures = []
    n, every = len(raw), cfg.vis_update_interval
    key_at = {f: k for k, f in SERVE_KEY_FRAMES.items()}
    vis = list(range(0, n, every))
    last_mesh = max(i for i in vis if i > SERVE_KEY_FRAMES["M"])
    last_cloud = max(i for i in vis if i <= SERVE_KEY_FRAMES["M"])
    pipe = MonoOdometryTSDF(intr, cfg, device=dev)  # cli.live_mono's default worklist
    get = lambda url: urllib.request.urlopen(url, timeout=10).read()
    td = tempfile.mkdtemp(prefix="chip_smoke_serve_")

    def run(viewer, out, on_frame=None, mesh_mode=False):
        pipe.reset()
        s = LiveSession(pipe, viewer, ResultSaver(os.path.join(td, out)))
        s.mesh_mode = mesh_mode
        _sync(dev)
        t0 = time.perf_counter()
        s.run(iter(raw), on_frame=on_frame)
        _sync(dev)
        return s, (time.perf_counter() - t0) * 1e3 / n

    viewer = BrowserLiveViewer(port=0, window_name="chip_smoke serve")
    url = viewer.server.url
    stop = threading.Event()
    page = {"polls": 0, "fetches": [], "bytes": 0, "errors": []}

    def poll():  # the page: poll the meta, fetch each new revision
        known = None
        while not stop.is_set():
            try:
                obj = json.loads(get(url + "meta.json"))["objects"].get("surface")
                page["polls"] += 1
                if obj and obj["rev"] != known:
                    blob = get(url + "geometry.bin?name=surface")
                    page["fetches"].append(struct.unpack_from("<3I", blob))
                    page["bytes"] += len(blob)
                    known = obj["rev"]
            except OSError as e:
                page["errors"].append(repr(e))
            stop.wait(0.05)

    def page_on():
        stop.clear()
        t = threading.Thread(target=poll, name="chip-smoke-page", daemon=True)
        t.start()
        return t

    def page_off(t):
        stop.set()
        t.join(timeout=10)

    @contextlib.contextmanager
    def sync_calls():
        """The synchronizing calls made inside (on the card), as a growing
        list of torch's sync-debug warnings."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield caught
            finally:
                if dev.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")

    n_sync = lambda caught: sum("synchroniz" in str(w.message) for w in caught)
    checks, queued, vis_ms = {}, [], {"inc": [], "pack_mesh": [], "pack_cloud": []}
    # at each key: the synchronizing calls since the previous frame's check, and
    # whether the card's stream still had work pending
    key_syncs, key_busy, seen = [], [], {"caught": [], "n": 0}

    def check_frame(s, i):
        if i in key_at:
            key_syncs.append(n_sync(seen["caught"]) - seen["n"])
            if dev.type == "cuda":
                key_busy.append(not torch.cuda.current_stream(dev).query())
        if s.vis_frames and s.vis_frames[-1][0] == i:
            mode = s.vis_frames[-1][1]
            geom = s.sent[mode][1]
            if mode == "mesh":
                vis_ms["inc"].append(sum(s.inc.timings.values()) * 1e3)
            t0 = time.perf_counter()
            pack_geometry(geom, 1, viewer.server.max_vertices)
            vis_ms[f"pack_{mode}"].append((time.perf_counter() - t0) * 1e3)
            if i in (last_mesh, last_cloud):
                blob = get(url + "geometry.bin?name=surface")
                rev, _, nv = struct.unpack_from("<3I", blob, 8)  # rev, mode, n_vertices
                out = dict(frame=i, bytes_equal=blob == pack_geometry(
                    geom, rev, viewer.server.max_vertices), geometry_bin_bytes=len(blob))
                if mode == "mesh":
                    full = s.pipe.extract_mesh().compact()
                    cen = lambda v: (lambda r: r[np.lexsort(r.T)])(
                        np.round(np.asarray(v).reshape(-1, 3, 3).mean(1), 5))
                    out.update(same_as_extract=(
                        geom.triangles.shape[0] == full.triangles.shape[0]
                        and np.array_equal(cen(geom.vertices), cen(full.vertices))),
                        triangles=int(geom.triangles.shape[0]), sent_vertices=int(nv),
                        decimated=bool(nv < geom.vertices.shape[0]))
                else:
                    pts, cols = s.pipe.extract_point_cloud(max_points=s.CLOUD_POINTS)
                    out.update(same_as_extract=bool(np.array_equal(pts, geom.points)
                                                    and np.array_equal(cols, geom.colors)),
                               points=int(pts.shape[0]))
                checks[mode] = out
            checks["status"] = json.loads(get(url + "meta.json"))["status"]
        if i in key_at:
            before = list(s.keys)
            get(url + "key?c=" + key_at[i].lower())
            queued.append(s.keys == before)
        seen["n"] = n_sync(seen["caught"])

    ms = {"headless": [], "cloud": [], "mesh": []}
    try:
        ms["headless"].append(run(NullViewer(), "headless")[1])
        traj_headless = np.stack(pipe.trajectory)
        t_page = page_on()
        with sync_calls() as seen["caught"]:
            build.launches.clear()
            served, _ = run(viewer, "served", on_frame=check_frame)
            counts = {k: build.launches[k] for k in (tk.KERNEL, odo.KERNEL)}
        page_off(t_page)
        traj_served = np.stack(pipe.trajectory)
        mesh_geom, cloud_geom = served.sent["mesh"][1], served.sent["cloud"][1]
        # the synchronizing calls of a served run, frame by frame
        per_frame = []
        if dev.type == "cuda":
            with sync_calls() as caught:
                last = [0]

                def count(s, i):
                    per_frame.append(n_sync(caught) - last[0])
                    last[0] = n_sync(caught)

                run(viewer, "syncs", on_frame=count, mesh_mode=True)
        # ms/frame headless and served, in turns (the first headless turn above); the
        # page polls and fetches through each served turn
        page_before = (len(page["fetches"]), page["bytes"], page["polls"])
        for t in range(turns):
            for what in (("cloud", "mesh", "headless") if t % 2 == 0
                         else ("headless", "mesh", "cloud")):
                if len(ms[what]) < turns:
                    t_page = None if what == "headless" else page_on()
                    try:
                        v = NullViewer() if what == "headless" else viewer
                        ms[what].append(run(v, "timing", mesh_mode=what == "mesh")[1])
                    finally:
                        if t_page is not None:
                            page_off(t_page)
        turn_page = (len(page["fetches"]) - page_before[0], page["bytes"] - page_before[1],
                     page["polls"] - page_before[2])
    finally:
        stop.set()
        viewer.close()

    traj_equal = np.array_equal(traj_served, traj_headless)
    want_keys = [(SERVE_KEY_FRAMES["M"], "M"), (SERVE_KEY_FRAMES["S"], "S")]
    want_vis = [(i, "mesh" if i > SERVE_KEY_FRAMES["M"] else "cloud") for i in vis]
    status = checks.get("status", "").split(" | ")
    status_ok = (len(status) == 2 and status[0] == f"frame {vis[-1]}"
                 and np.isfinite(float(status[1].split()[0])))
    fetched = page["fetches"]
    page_ok = (page["polls"] > 0 and fetched and not page["errors"]
               and all(m == MAGIC and v == 1 for m, v, _ in fetched)
               and [r for _, _, r in fetched] == sorted(r for _, _, r in fetched))
    saved = os.path.join(td, "served")
    try:
        mv, _, mf = read_ply(os.path.join(saved, "latest_mesh.ply"))
        cv, cc, _ = read_ply(os.path.join(saved, "latest_volume_pcd.ply"))
        tr = np.loadtxt(os.path.join(saved, "latest_trajectory.txt"))
        img = _png_rgb(os.path.join(saved, "latest_preview.png"))
        save_ok = (mf is not None and len(mf) > 10000 and np.isfinite(mv).all()
                   and cv.shape[0] > 10000 and cc is not None
                   and tr.shape == (SERVE_KEY_FRAMES["S"] + 2, 16) and img.shape == (480, 640, 3)
                   and bool((np.abs(img.astype(int) - [18, 18, 24]).sum(-1) > 10).any()))
        save_what = (f"mesh {len(mf)} faces, cloud {cv.shape[0]} points, trajectory "
                     f"{tr.shape[0]} poses, preview {img.shape[1]}x{img.shape[0]} with "
                     f"{float((np.abs(img.astype(int) - [18, 18, 24]).sum(-1) > 10).mean()):.3f} "
                     "of its pixels off the background")
    except (OSError, ValueError) as e:
        save_ok, save_what = False, f"not read back: {e}"
    _log(f"serve launches: {json.dumps(counts)} over {n} frames  [{gpu}]")
    m_chk = {k: v for k, v in checks.get("mesh", {}).items()}
    c_chk = {k: v for k, v in checks.get("cloud", {}).items()}
    _log(f"served loop (LiveSession over prefetch_to_device, BrowserLiveViewer on {url}): "
         f"trajectory equal to the headless loop's to the bit: {traj_equal}; vis frames "
         f"{served.vis_frames}; keys {served.keys}, each queued until that frame's tick: "
         f"{queued}, synchronizing calls since the previous frame before each {key_syncs}, the "
         f"card's stream still busy at each {key_busy}; "
         f"mesh check {json.dumps(m_chk)}; cloud check {json.dumps(c_chk)}; status "
         f"{checks.get('status')!r}; the page thread polled {page['polls']} times and fetched "
         f"{len(fetched)} revisions, errors {page['errors'][:2]}; save: {save_what}  [{gpu}]")
    med = lambda xs: statistics.median(xs) if xs else float("nan")
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    _log(f"served ms/frame (host clock, one sync after {n} frames, {turns} turns, median): "
         f"headless {med(ms['headless']):.3f} ({fmt(ms['headless'])}), served cloud mode "
         f"{med(ms['cloud']):.3f} ({fmt(ms['cloud'])}), served mesh mode {med(ms['mesh']):.3f} "
         f"({fmt(ms['mesh'])}); during the served turns the page thread polled "
         f"{turn_page[2]} times and fetched {turn_page[0]} revisions, {turn_page[1]} bytes  "
         f"[{gpu}]")
    _log(f"served vis frames (every {every}, host clock): inc.update ms median "
         f"{med(vis_ms['inc']):.3f} ({fmt(vis_ms['inc'])}), pack_geometry ms median mesh "
         f"{med(vis_ms['pack_mesh']):.3f} ({fmt(vis_ms['pack_mesh'])}) / cloud "
         f"{med(vis_ms['pack_cloud']):.3f} ({fmt(vis_ms['pack_cloud'])})  [{gpu}]")
    _log(f"one geometry.bin: {m_chk.get('geometry_bin_bytes')} bytes (mesh, "
         f"{m_chk.get('sent_vertices')} vertices), {c_chk.get('geometry_bin_bytes')} bytes "
         f"(cloud, {c_chk.get('points')} points)  [{gpu}]")
    if per_frame:
        other = [c for i, c in enumerate(per_frame) if i % every]
        _log(f"synchronizing calls by frame of a served mesh-mode run "
             f"(torch.cuda.set_sync_debug_mode): {per_frame}; on the {len(other)} frames that "
             f"are not vis frames {sum(other)}  [{gpu}]")
    if counts != {tk.KERNEL: n, odo.KERNEL: n - 1}:
        failures.append(f"serve launches {counts}, not B1 once a frame and B2 once a tracked "
                        "frame")
    if not traj_equal:
        failures.append("the served loop's trajectory differs from the headless loop's")
    if served.keys != want_keys or not all(queued) or len(queued) != 2:
        failures.append(f"keys handled {served.keys}, queued until the tick {queued}")
    if dev.type == "cuda" and any(key_syncs):
        failures.append(f"the loop synchronized before a key arrived: {key_syncs}")
    if served.vis_frames != want_vis:
        failures.append(f"vis frames {served.vis_frames}, not {want_vis}")
    if not (m_chk.get("same_as_extract") and m_chk.get("bytes_equal")):
        failures.append(f"the served mesh differs from extract_mesh or its pack: {m_chk}")
    if not (c_chk.get("same_as_extract") and c_chk.get("bytes_equal")):
        failures.append(f"the served cloud differs from extract_point_cloud or its pack: {c_chk}")
    if not status_ok:
        failures.append(f"the status line {checks.get('status')!r}")
    if not page_ok:
        failures.append(f"the page thread: {page['polls']} polls, fetches {fetched[:3]}, errors "
                        f"{page['errors'][:2]}")
    if not save_ok:
        failures.append(f"the save: {save_what}")
    failures += _native_check(mesh_geom, cloud_geom, gpu)
    shutil.rmtree(td, ignore_errors=True)
    _log(f"serve phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)  [{gpu}]")
    return failures, counts


def bench_phase(dev, gpu: str):
    """The port's ``bench.py``, ``python -m azurekinect3dreconstruction_tpu_torch.cli.bench``,
    in a subprocess on ``dev``: logs its JSON line and its stderr marks
    (progress and each section's launches). Checks: exit code 0; the last
    line parses, with exactly ``cli.bench.KEYS`` and ``"errors"``, and
    ``"errors"`` empty; ``blocks_growing``; no extraction or streaming
    overflow; evictions in both corridors; ``slam_ate_rmse_mm`` <= 20 and
    both least fitnesses > 0.3; ``reloc_err_mm`` in [0, 50); refinements
    accepted; on a card, every section's launches equal to the count it
    expects. Returns (failures, the bench's launches of each kernel)."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.cli.bench import KEYS

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # this process's cached blocks, for the bench's volumes
    cmd = [sys.executable, "-m", f"{PKG}.cli.bench", "--device", dev.type]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S, cwd=REPO)
    except subprocess.TimeoutExpired as e:
        return [f"cli.bench did not finish in {BENCH_TIMEOUT_S} s: "
                f"{(e.stderr or b'')[-1500:]!r}"], {}
    wall = time.perf_counter() - t0
    marks = [ln for ln in r.stderr.splitlines() if ln.startswith("[bench")]
    for ln in marks:
        _log(f"cli.bench stderr: {ln}")
    lines = r.stdout.strip().splitlines()
    _log(f"cli.bench line: {lines[-1] if lines else '(none)'}")
    _log(f"cli.bench: rc {r.returncode}, {wall:.1f} s (host clock, process start and the "
         f"render of its frames included)  [{gpu}]")
    failures = []
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError) as e:
        return [f"cli.bench printed no JSON line (rc {r.returncode}, {e}): "
                f"{r.stderr[-1500:]}"], {}
    if r.returncode != 0 or line.get("errors"):
        failures.append(f"cli.bench: rc {r.returncode}, errors {line.get('errors')}")
    if list(line) != [*KEYS, "errors"]:
        odd = sorted(set(line) ^ {*KEYS, "errors"})
        failures.append(f"cli.bench's keys differ from bench.py's: {odd}")
    checks = {
        "blocks_growing": line.get("blocks_growing") is True,
        "extract_overflow": line.get("extract_overflow") is False,
        "streaming_overflow": line.get("streaming_overflow") is False,
        "streaming_n_evictions": (line.get("streaming_n_evictions") or 0) > 0,
        "streaming_fullres_evictions": (line.get("streaming_fullres_evictions") or 0) > 0,
        "slam_ate_rmse_mm": (line.get("slam_ate_rmse_mm") or 1e9) <= ATE_LIMIT_M * 1e3,
        "min_odometry_fitness": (line.get("min_odometry_fitness") or 0) > BENCH_MIN_FITNESS,
        "min_sharded_fitness": (line.get("min_sharded_fitness") or 0) > BENCH_MIN_FITNESS,
        "reloc_err_mm": 0 <= (line.get("reloc_err_mm") if line.get("reloc_err_mm") is not None
                              else -1) < BENCH_RELOC_ERR_LIMIT_MM,
        "f2m_refines_ok": (line.get("f2m_refines_ok") or 0) > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        failures.append("cli.bench out of bounds: " + ", ".join(f"{k} {line.get(k)}" for k in bad))
    totals = {}
    sections = [json.loads(ln[len("[bench launches] "):]) for ln in marks
                if ln.startswith("[bench launches] ")]
    for sec in sections:
        for k, v in sec["launches"].items():
            totals[k] = totals.get(k, 0) + v
        if dev.type == "cuda" and sec["launches"] != {k: sec["expected"].get(k, 0)
                                                      for k in sec["launches"]}:
            failures.append(f"cli.bench section {sec['section']}: launches {sec['launches']}, "
                            f"expected {sec['expected']}")
    if len(sections) != 16:
        failures.append(f"cli.bench reported the launches of {len(sections)} sections, not 16")
    _log(f"cli.bench launches over its 16 sections: {json.dumps(totals)}  [{gpu}]")
    return failures, totals


def rig_calib_phase(dev, gpu: str, n_pairs: int = N_RIG_CALIB_PAIRS, scale: float = 1.0):
    """The checkerboard route for a rig outside ICP's basin: ``cli.
    calibrate_rig --source synthetic --views 8`` into a temporary directory
    on the host (its extrinsic within tests/test_io_calib.py's 4 cm / 3 deg
    of the true T10), then ``cli.dual_fusion --source synthetic --frames
    n_pairs --rig-calib DIR`` on the card, in process, the counters zeroed
    just before and read just after: it logs the loaded calibration, makes
    no auto-calibration attempt (``calib_ok`` + ``calib_reject`` = 0), B1
    twice a pair, no overflow. Returns (failures, launches)."""
    import contextlib
    import io

    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.calib.extrinsics import RigCalibration
    from azurekinect3dreconstruction_tpu_torch.cli import calibrate_rig, dual_fusion
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk

    t_phase = time.perf_counter()
    failures = []
    with tempfile.TemporaryDirectory() as td:
        calib = os.path.join(td, "calibration")
        t0 = time.perf_counter()
        rc = calibrate_rig.main(["--source", "synthetic", "--views", "8", "--calib-dir", calib])
        calib_ms = (time.perf_counter() - t0) * 1e3
        cal = RigCalibration.load_newest(calib, expected_serials=["SYNTH0", "SYNTH1"])
        T_true = calibrate_rig._exp64(calibrate_rig.SYNTH_T10_XI)
        t_err = r_err = float("nan")
        if cal is not None:
            T = np.asarray(cal.extrinsics[1])
            t_err = float(np.linalg.norm(T[:3, 3] - T_true[:3, 3]))
            cos = (np.trace(T[:3, :3].T @ T_true[:3, :3]) - 1) / 2
            r_err = float(np.degrees(np.arccos(np.clip(cos, -1, 1))))
        _log(f"rig calibration (cli.calibrate_rig, 8 synthetic view pairs, host): rc {rc}, "
             f"extrinsic {t_err * 1e3:.2f} mm / {r_err:.3f} deg from the truth, "
             f"{calib_ms:.1f} ms with the board renders  [{gpu}]")
        if rc != 0 or not (t_err < RIG_T_LIMIT_M and r_err < RIG_R_LIMIT_DEG):
            failures.append(f"the checkerboard extrinsic is {t_err:.4f} m / {r_err:.3f} deg off "
                            f"(rc {rc})")
        buf = io.StringIO()
        build.launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = dual_fusion.main(["--source", "synthetic", "--frames", str(n_pairs), "--scale",
                                   str(scale), "--device", str(dev), "--rig-calib", calib,
                                   "--output", os.path.join(td, "fused")])
        _sync(dev)
        dual_s = time.perf_counter() - t0
        counts = {k: build.launches[k] for k in (tk.KERNEL, odo.KERNEL)}
    out = buf.getvalue()
    summary = [l for l in out.splitlines() if "pairs, calibrated" in l]
    loaded = [l for l in out.splitlines() if "rig calibration loaded" in l]
    _log(f"dual_fusion --rig-calib ({n_pairs} pairs, {dual_s:.1f} s with its set-up and save): "
         f"rc {rc}; {loaded[0] if loaded else 'NO rig calibration loaded line'}; "
         f"{summary[0] if summary else 'NO summary line'}; launches {json.dumps(counts)}  [{gpu}]")
    if rc != 0 or not loaded or not summary:
        failures.append("dual_fusion --rig-calib did not load the calibration or finish")
    elif not ("calibration events {}" in summary[0] and "overflow False" in summary[0]
              and "calibrated True" in summary[0]):
        failures.append(f"dual_fusion --rig-calib: {summary[0]}")
    if counts != {tk.KERNEL: 2 * n_pairs, odo.KERNEL: 0}:
        failures.append(f"rig-calibrated dual launches {counts}, not B1 twice a pair")
    _log(f"rig calibration phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)  "
         f"[{gpu}]")
    return failures, counts


def _aligned_cfg():
    """The live camera's paths' configuration: the bench's 5 mm voxels in
    16^3 blocks, in a pool of ``ALIGNED_BLOCKS`` blocks."""
    from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig

    return PipelineConfig(tsdf=TSDFConfig(voxel_size=0.005, sdf_trunc=0.02, block_resolution=16,
                                          block_capacity=ALIGNED_BLOCKS,
                                          hash_capacity=4 * ALIGNED_BLOCKS))


def _aligned_cals(color_scale: float = 1.0):
    """(camera 0's, camera 1's) nominal k4a calibration, the 640x576 depth
    camera and the color camera, whose 1280x720 intrinsics ``color_scale``
    scales (1.5: the 1080p mode, the same sensor area). Camera 1's color
    intrinsics differ from camera 0's by ``ALIGNED_CAM1_DFX`` /
    ``ALIGNED_CAM1_DCX`` pixels of 1280x720, as two factory units differ."""
    from azurekinect3dreconstruction_tpu_torch.core.camera import CameraCalibration

    cal = CameraCalibration.azure_kinect_nominal()
    color = cal.color.scaled(color_scale)
    cal0 = dataclasses.replace(cal, color=color)
    cal1 = dataclasses.replace(cal0, color=dataclasses.replace(
        color, fx=color.fx + ALIGNED_CAM1_DFX * color_scale,
        cx=color.cx + ALIGNED_CAM1_DCX * color_scale))
    return cal0, cal1


class AlignedCamera:
    """One k4a unit as ``--source k4a`` and ``mkv:`` see it, on the
    synthetic scene: ``render(T)`` at the color camera's pose ``T`` is the
    depth camera's render (at ``T @ cal.color_from_depth``, with relative
    depth noise ``depth_noise`` drawn from ``generator``) put through
    ``ops.depth_to_color.transformed_depth`` into the color camera, and the
    color camera's own color render; ``capture(T)`` quantizes it to u16 mm
    and u8 RGB on the host. ``intrinsics`` are the color camera's."""

    def __init__(self, cal, dev, scene=None, depth_noise: float = 0.0, generator=None):
        import numpy as np

        from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
        from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera

        self.cal, self.intrinsics = cal, cal.color
        self.cam_d = SyntheticCamera(scene=scene, intrinsics=cal.depth, depth_noise=depth_noise,
                                     generator=generator, device=dev)
        self.cam_c = SyntheticCamera(scene=scene, intrinsics=cal.color, device=dev)
        self.rays_d = pixel_rays(cal.depth, dev)
        self.T_color_depth = np.asarray(cal.color_from_depth, np.float64)

    def render(self, T_world_color=None):
        import numpy as np

        from azurekinect3dreconstruction_tpu_torch.ops.depth_to_color import transformed_depth

        T = np.eye(4) if T_world_color is None else np.asarray(T_world_color, np.float64)
        z, _ = self.cam_d.render(T @ self.T_color_depth)
        _, color = self.cam_c.render(T)
        return transformed_depth(z, self.rays_d, self.cal), color

    def capture(self, T_world_color=None):
        return _quantize(self.render(T_world_color))


def _in_front(d0, d1, intrs, rays, T01) -> float:
    """The larger of two cameras' shares of pixels in front of the other's
    surface (``tracking.icp.free_space_shares``, the band from the pair's
    own noise) at the extrinsic ``T01``: depths ``d0``, ``d1``, each
    camera's intrinsics and ray table in ``intrs``, ``rays``."""
    import torch

    from azurekinect3dreconstruction_tpu_torch.tracking import icp

    band = icp.free_space_band(d0, d1)
    T = torch.as_tensor(T01, dtype=torch.float32, device=d0.device)
    return round(max(float(icp.free_space_shares(d0, intrs[0], d1, rays[1], T, band)[0]),
                     float(icp.free_space_shares(d1, intrs[1], d0, rays[0], torch.linalg.inv(T),
                                                 band)[0])), 6)


def aligned_calibration(cals, cfg, dev, gpu: str, out_dir: str) -> list:
    """``DualCameraFusion.calibrate`` on the color-aligned frames of two
    units with the calibrations ``cals`` (each camera with its own color
    intrinsics): the bench rig (``cli.bench.bench_rig``) in
    ``Scene.default()`` and ``Scene.cluttered()`` and the test rig
    (``CALIB_RIG_XI``) in the default scene, each rig the color camera 1's
    pose in color camera 0's frame, from each RANSAC seed of
    ``ALIGNED_CALIB_SEEDS`` at each relative depth noise of
    ``ALIGNED_CALIB_NOISES`` (drawn in the depth cameras
    from a generator seeded alike). Each must be accepted within 2 cm /
    0.03 rad; each is logged with its scores, the free-space band, the
    share in front at the truth (``_in_front``), whether the colored
    fallback ran, the stage ms and the first pair's ms. Returns
    failures."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.cli.bench import bench_rig
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import Scene
    from azurekinect3dreconstruction_tpu_torch.pipelines.dual_fusion import DualCameraFusion

    failures = []
    intrs = tuple(c.color for c in cals)
    size = f"{intrs[0].width}x{intrs[0].height}"
    test_rig = se3.se3_exp(torch.tensor(CALIB_RIG_XI, dtype=torch.float64)).numpy()
    rigs = (("bench rig", bench_rig(), ("default", "cluttered")),
            ("test rig", test_rig, ("default",)))
    t_all, n = time.perf_counter(), 0
    for name, rig, scenes in rigs:
        for noise in ALIGNED_CALIB_NOISES:
            for scene in scenes:
                for seed in ALIGNED_CALIB_SEEDS:
                    gen = torch.Generator(device=dev).manual_seed(seed) if noise else None
                    cams = [AlignedCamera(c, dev, getattr(Scene, scene)(), noise, gen)
                            for c in cals]
                    pair = cams[0].capture(np.eye(4)), cams[1].capture(rig)
                    p = DualCameraFusion(intrs, cfg, device=dev, output_dir=out_dir)
                    p.generator = torch.Generator(device=dev).manual_seed(seed)
                    t0 = time.perf_counter()
                    p.process_frames(pair)
                    _sync(dev)
                    ms = (time.perf_counter() - t0) * 1e3
                    et = er = float("inf")
                    if p.calibrated:
                        d = se3.se3_log(torch.as_tensor(np.linalg.inv(rig) @ p.extrinsics[1]))
                        et, er = float(d[:3].norm()), float(d[3:].norm())
                    stages = {k: round(v, 3) for k, v in p.calib_stage_ms.items()}
                    scores = {k: round(float(v), 6) for k, v in p.calib_scores.items()}
                    d0, d1 = (f.depth for f in p._decoded_frames())
                    scores["in_front_at_truth"] = _in_front(d0, d1, p.intr, p.rays, rig)
                    _log(f"aligned dual calibration ({name}, {size}, camera 1's fx / cx "
                         f"{intrs[1].fx - intrs[0].fx:+.2f} / {intrs[1].cx - intrs[0].cx:+.2f} px, "
                         f"{scene} scene, depth noise {noise}, seed {seed}): calibrated "
                         f"{p.calibrated}, extrinsic error {et * 1e3:.4f} mm / {er * 1e3:.4f} "
                         f"mrad; scores {json.dumps(scores)}; colored fallback "
                         f"{'colored_refine' in stages}; first pair {ms:.3f} ms (host clock, "
                         f"calibration + fuse); stage ms (synchronized after each): "
                         f"{json.dumps(stages)} (sum {sum(stages.values()):.3f})  [{gpu}]")
                    if not (p.calibrated and et <= CALIB_T_LIMIT_M and er <= CALIB_R_LIMIT_RAD):
                        failures.append(f"aligned {name} calibration ({size}, {scene}, noise "
                                        f"{noise}, seed {seed}): calibrated {p.calibrated}, "
                                        f"{et:.4f} m / {er:.4f} rad")
                    n += 1
                    del p
    _log(f"aligned dual calibrations: {n} in {time.perf_counter() - t_all:.1f} s (host clock)  "
         f"[{gpu}]")
    return failures


def aligned_dual_phase(dev, gpu: str):
    """The two-camera rig on the color-aligned 1280x720 frames ``--source
    k4a`` feeds (``_aligned_cals``: each unit's depth
    through ``transformed_depth`` into its own color camera, camera 1's
    color intrinsics a few pixels off camera 0's), with 5 mm voxels
    (``_aligned_cfg``): ``aligned_calibration``, then ``dual_fusion_checks``
    at the bench rig. Returns (failures, launch counts of the moving-rig
    pass, B1's figures on camera 1's frame or None)."""
    from azurekinect3dreconstruction_tpu_torch.cli.bench import bench_rig

    t_phase = time.perf_counter()
    cfg, cals = _aligned_cfg(), _aligned_cals()
    size = f"{cals[0].color.width}x{cals[0].color.height}"
    with tempfile.TemporaryDirectory() as tmp:
        failures = aligned_calibration(cals, cfg, dev, gpu, tmp)
        cams = [AlignedCamera(c, dev) for c in cals]
        fuse_failures, counts, b1 = dual_fusion_checks(
            cams, [c.color for c in cals], cfg, bench_rig(), dev, gpu, tmp, N_ALIGNED_DUAL_PAIRS,
            N_ALIGNED_DUAL_CPU_PAIRS, f"{size} aligned")
    _log(f"aligned dual phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)  "
         f"[{gpu}]")
    return failures + fuse_failures, counts, b1


def aligned_recorder_phase(dev, gpu: str, jump_draws: int = JUMP_DRAWS):
    """The recorder (``recorder_phase``) on the color-aligned 1280x720
    frames, with the color intrinsics, over the first ``N_REC_FRAMES``
    aligned sweep frames, its keyframe jump rendered aligned too
    (``AlignedCamera``) and its ladder run again from ``jump_draws`` fresh
    seeds. Returns (failures, launch counts)."""
    t_phase = time.perf_counter()
    cal = _aligned_cals()[0]
    _, raw, truth, _ = _aligned_frames(dev, N_REC_FRAMES, cal)
    out = recorder_phase(cal.color, _aligned_cfg(), AlignedCamera(cal, dev), raw, truth, dev, gpu,
                         jump_draws)
    _log(f"aligned recorder phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)  "
         f"[{gpu}]")
    return out


def aligned_reloc_phase(dev, gpu: str):
    """Relocalization (``reloc_phase``) on the color-aligned 1280x720
    frames, with the color intrinsics and the sweep's color camera poses;
    the healthy
    ms/frame over its first ``N_FRAMES`` aligned frames. Returns (failures,
    launch counts)."""
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory

    t_phase = time.perf_counter()
    cal = _aligned_cals()[0]
    _, raw, _, _ = _aligned_frames(dev, N_FRAMES, cal)
    T_depth_color = np.linalg.inv(cal.color_from_depth)
    poses = [T @ T_depth_color for T in orbit_trajectory(64, radius=0.35, angle_span=1.3)]
    out = reloc_phase(cal.color, _aligned_cfg(), AlignedCamera(cal, dev), poses, raw, dev, gpu)
    _log(f"aligned relocalization phase wall time {time.perf_counter() - t_phase:.1f} s (host "
         f"clock)  [{gpu}]")
    return out


def hd_phase(dev, gpu: str):
    """One mono frame-to-frame pass on the color-aligned 1920x1080 frames,
    the size an ``mkv:`` from ``k4arecorder``'s defaults feeds (the 1080p
    color intrinsics, 1.5 x the 720p ones), over the first
    ``N_HD_FRAMES`` sweep poses into the 5 mm pool at the default worklist,
    the counters zeroed just before and read just after: B1 once a frame,
    B2 once a pair, no gate rejection, no overflow, ATE <= 20 mm against
    the color camera's truth, ms/frame beside the 33.3 ms limit. Before
    it, B1 on one frame and B2 on one pair against their plain versions (B2's
    level 0 outgrows the shared-memory band: the large-frame route, levels 1
    and 2 the shared one).
    Returns (failures, launch counts, the kernels' figures by name)."""
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate, rpe

    t_phase = time.perf_counter()
    failures, figures = [], {}
    cfg = _aligned_cfg()
    cal = _aligned_cals(HD_SCALE)[0]
    intr = cal.color
    size = f"{intr.width}x{intr.height}"
    n = N_HD_FRAMES
    _, raw, truth, _ = _aligned_frames(dev, n, cal)
    dec = [_decode(r, cfg, dev) for r in raw[:3]]
    figures[tk.KERNEL] = b1_frame_check(dec, truth, intr, pixel_rays(intr, dev), cfg.tsdf,
                                        cfg.tsdf.block_capacity, gpu, size)
    if not figures[tk.KERNEL]["bitwise"]:
        failures.append(f"B1 at {size} differs from its plain version")
    b2_failures, figures[odo.KERNEL] = b2_pair_check(dec, intr, cfg.odometry, gpu, size)
    failures += b2_failures
    routes = figures[odo.KERNEL]["routes"]
    if not (routes[0].startswith("large") and routes[1:] == ["shared"] * (len(routes) - 1)):
        failures.append(f"B2 at {size} took the routes {routes}, not level 0 on the large route "
                        "and the others shared")
    _run_frames(MonoOdometryTSDF(intr, cfg, device=dev), raw[:3], False)
    pipe = MonoOdometryTSDF(intr, cfg, device=dev)
    _sync(dev)
    build.launches.clear()
    frame_ms = _run_frames(pipe, raw, True)
    counts = {tk.KERNEL: build.launches[tk.KERNEL], odo.KERNEL: build.launches[odo.KERNEL]}
    gt_np = [g.cpu().numpy().astype(np.float64) for g in truth]
    traj = pipe.trajectory[1:]
    a, r = ate(traj, gt_np), rpe(traj, gt_np)
    rejected, overflow = pipe.odometry_failures, bool(pipe.volume.overflow)
    n_blocks = int(pipe.volume.n_blocks)
    pipe.reset()
    sync_ms = _run_frames(pipe, raw, False)
    steady = sorted(frame_ms[1:])
    _log(f"{size} frame_to_frame over {n} aligned frames (the default worklist, the whole pool "
         f"of {cfg.tsdf.block_capacity}): launches {json.dumps(counts)}; ATE rmse "
         f"{a['rmse'] * 1e3:.3f} mm (max {a['max'] * 1e3:.3f}), RPE {r['trans_rmse'] * 1e3:.3f} "
         f"mm / {np.degrees(r['rot_rmse']):.4f} deg against the color camera's truth; gate "
         f"rejections {rejected}, overflow {overflow}, n_blocks {n_blocks}; ms/frame "
         f"synchronized per frame: frame 0 {frame_ms[0]:.3f}, tracked median "
         f"{steady[len(steady) // 2]:.3f}, max {steady[-1]:.3f}; one sync at the end "
         f"{sync_ms:.3f} (limit {FRAME_LIMIT_MS} ms)  [{gpu}]")
    if rejected or len(pipe.fitness) != n - 1:
        failures.append(f"{size} frame_to_frame: {rejected} gate rejection(s)")
    if overflow or bool(pipe.volume.overflow):
        failures.append(f"{size} frame_to_frame: overflow at the default worklist")
    if not a["rmse"] <= ATE_LIMIT_M:
        failures.append(f"{size} frame_to_frame ATE {a['rmse']:.5f} m over {ATE_LIMIT_M} m")
    if counts != {tk.KERNEL: n, odo.KERNEL: n - 1}:
        failures.append(f"{size} frame_to_frame launches {counts}, not B1 once a frame and B2 "
                        "once a pair")
    _log(f"{size} phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)  [{gpu}]")
    return failures, counts, figures


def uhd_check(dev, gpu: str):
    """B2 on the first two color-aligned 3840x2160 frames (the k4a's
    RES_2160P color mode, 3 x the 720p intrinsics), made as ``hd_phase``
    makes its frames (``b2_pair_check``): against its plain version within
    B2's tolerances, a second launch equal to the bit, its device us beside
    its bound; levels 0 and 1 on the large-frame route, level 2 on the
    shared one. Returns (failures, B2's figures)."""
    cfg = _aligned_cfg()
    cal = _aligned_cals(UHD_SCALE)[0]
    _, raw, _, _ = _aligned_frames(dev, 2, cal)
    dec = [_decode(r, cfg, dev) for r in raw]
    size = f"{cal.color.width}x{cal.color.height}"
    failures, figures = b2_pair_check(dec, cal.color, cfg.odometry, gpu, size)
    routes = figures["routes"]
    if not (all(r.startswith("large") for r in routes[:2]) and routes[2:] == ["shared"]):
        failures.append(f"B2 at {size} took the routes {routes}, not levels 0 and 1 on the large "
                        "route and level 2 shared")
    return failures, figures


def aligned_paths(dev, gpu: str, jump_draws: int = JUMP_DRAWS):
    """The live camera's other paths at its color-aligned frame sizes:
    ``aligned_dual_phase``, ``aligned_recorder_phase`` (its ladder from
    ``jump_draws`` fresh seeds), ``aligned_reloc_phase``, ``hd_phase`` and
    ``uhd_check``. Returns (failures, {kernel name: the launch counts of
    each path and the kernels' figures at the new sizes})."""
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk

    dual_failures, dual_counts, b1_dual = aligned_dual_phase(dev, gpu)
    rec_failures, rec_counts = aligned_recorder_phase(dev, gpu, jump_draws)
    reloc_failures, reloc_counts = aligned_reloc_phase(dev, gpu)
    hd_failures, hd_counts, hd_figures = hd_phase(dev, gpu)
    uhd_failures, uhd_figures = uhd_check(dev, gpu)
    out = {}
    for name in (tk.KERNEL, odo.KERNEL):
        out[name] = {"launches_aligned_dual": dual_counts[name],
                     "launches_aligned_recorder": rec_counts[name],
                     "launches_aligned_relocalize": reloc_counts[name],
                     "launches_1920x1080": hd_counts[name],
                     "aligned_1920x1080": hd_figures.get(name, {})}
    out[tk.KERNEL]["aligned_dual_camera1"] = b1_dual or {}
    out[odo.KERNEL]["aligned_3840x2160"] = uhd_figures
    return dual_failures + rec_failures + reloc_failures + hd_failures + uhd_failures, out


def _aligned_frames(dev, n: int, cal=None):
    """The live camera's frames (``--source k4a`` and ``mkv:`` hand the
    pipeline ``capture.transformed_depth``): over the bench sweep's first
    ``n`` poses, each a depth-camera pose, depth rendered in the NFOV depth
    camera, put through ``ops.depth_to_color.transformed_depth`` with the
    nominal calibration (its 32 mm baseline) into the 720p color camera and
    quantized to u16 mm, and color rendered at 720p from the color camera's
    pose (``cal``, default the nominal one, sets both cameras). Returns (the
    calibration, the frames, the color camera's poses relative to its first
    as the truth, the first depth-camera render)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core.camera import CameraCalibration
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory

    cal = cal or CameraCalibration.azure_kinect_nominal()
    cam = AlignedCamera(cal, dev)
    T_depth_color = np.linalg.inv(cal.color_from_depth)
    colors = [T @ T_depth_color for T in orbit_trajectory(64, radius=0.35, angle_span=1.3)[:n]]
    raw = [cam.capture(T) for T in colors]
    first = cam.cam_d.render(colors[0] @ cam.T_color_depth)[0]
    truth = [torch.as_tensor(np.linalg.inv(colors[0]) @ T, dtype=torch.float32, device=dev)
             for T in colors]
    return cal, raw, truth, first


def aligned_phase(dev, gpu: str):
    """The live camera's path on the card: the color-aligned 1280x720 frames
    that ``--source k4a`` and ``mkv:`` feed (``_aligned_frames``), with the
    color camera's intrinsics, at the bench's 5 mm pool of
    ``ALIGNED_BLOCKS`` blocks.

    ``transformed_depth`` on the card against the CPU on one frame; the
    blocks each frame allocates (unique keys against allocate's dedup
    budget) and the live blocks in the frustum (``n_active``) at the true
    poses, and from them the worklist a caller of the JAX class would pass
    (the first of ``WORKLIST_SIZES`` that holds the largest, and never
    below the pipeline's default); B1 on one frame and B2 on one pair
    against their plain versions (B1 to the bit, B2 within ``B2_POSE_TOL``
    / ``B2_FITNESS_TOL`` and a second launch to the bit), their device us,
    wrapper and plain ms, bounds, and which instance B2 took; frame to
    frame over ``N_ALIGNED_F2F`` poses and frame to model over
    ``N_ALIGNED_F2M`` (``f2m_phase`` at this size: beside frame to frame,
    its phase breakdown and the refinement's graph), both at the pipeline's
    default worklist (the whole pool), the counters zeroed just before and
    read just after each, against the color camera's truth, ms/frame
    synchronized per frame and with one sync beside the 33.3 ms limit; the
    mesh of the frame-to-frame pass; then ``cli.live_mono --source
    replay:DIR --voxel 0.005`` in a subprocess over the same frames, logged
    with a calibration whose depth and color are both the color camera's
    intrinsics. The entry point keeps the default worklist, the whole pool,
    so its sticky overflow must stay clear although the largest ``n_active``
    exceeds the JAX class's default of 2,048 (ROADMAP C18, repaired).
    Returns (failures, the kernels' figures by kernel name)."""
    import inspect

    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.core.camera import CameraCalibration, pixel_rays
    from azurekinect3dreconstruction_tpu_torch.io.replay import FrameRecorder
    from azurekinect3dreconstruction_tpu_torch.ops.depth_to_color import transformed_depth
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import odometry_kernels as odo
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import tsdf_kernels as tk
    from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import (
        MonoOdometryTSDF,
    )
    from azurekinect3dreconstruction_tpu_torch.tsdf import hash as vhash
    from azurekinect3dreconstruction_tpu_torch.tsdf import marching_cubes as mc
    from azurekinect3dreconstruction_tpu_torch.tsdf import volume as tsdf
    from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate, rpe

    t_phase = time.perf_counter()
    failures = []
    cfg = _aligned_cfg()
    tcfg, ocfg = cfg.tsdf, cfg.odometry
    voxel = tcfg.voxel_size
    n = max(N_ALIGNED_F2F, N_ALIGNED_F2M)
    t0 = time.perf_counter()
    cal, raw, truth, z0 = _aligned_frames(dev, n)
    intr = cal.color
    _sync(dev)
    make_s = time.perf_counter() - t0
    size = f"{intr.width}x{intr.height}"
    rays = pixel_rays(intr, dev)
    valid = [float((d > 0).mean()) for d, _ in raw]
    _log(f"aligned frames: {n} at {size} (depth {cal.depth.width}x{cal.depth.height} through "
         f"transformed_depth, 32 mm baseline), made in {make_s:.2f} s; depth valid on "
         f"{min(valid):.4f}-{max(valid):.4f} of the pixels  [{gpu}]")

    # -- transformed_depth: the card against the CPU on one frame ---------------
    rays_d = pixel_rays(cal.depth, dev)
    td = transformed_depth(z0, rays_d, cal)
    td_cpu = transformed_depth(z0.cpu(), pixel_rays(cal.depth, "cpu"), cal)
    diff = (td.cpu() - td_cpu).abs()
    td_equal = bool(torch.equal(td.cpu(), td_cpu))
    td_ms = _median_ms(lambda: transformed_depth(z0, rays_d, cal), dev, 11)
    _log(f"transformed_depth {cal.depth.width}x{cal.depth.height} -> {size} on {dev.type} "
         f"against the CPU: equal to the bit {td_equal} ({int((diff > 0).sum())} pixels differ, "
         f"max {float(diff.max()):.3g} m); {td_ms:.4f} ms a frame (synchronized, median of 11)"
         f"  [{gpu}]")
    if not td_equal:
        failures.append(f"transformed_depth on {dev.type} differs from the CPU's on "
                        f"{int((diff > 0).sum())} pixels")

    # -- allocation's dedup budget and the frustum's live blocks at the truth ---
    budget = inspect.signature(tsdf.allocate).parameters["dedup_budget"].default
    default_wl = inspect.signature(MonoOdometryTSDF).parameters["worklist_size"].default
    pool = tcfg.block_capacity
    dec = [_decode(r, cfg, dev) for r in raw]
    vol = tsdf.create(tcfg, dev)
    n_keys = -(-intr.height // 2) * -(-intr.width // 2) * 3  # allocate's stride-2 rays x 3
    unique, live = [], []
    for (d, _, _), T in zip(dec, truth):
        keys = tsdf.candidate_keys(d, rays, T, tcfg, dedup_budget=n_keys)
        unique.append(int((keys != vhash.EMPTY_KEY).sum()))
        vol = tsdf.allocate(vol, d, rays, T, tcfg)
        live.append(int(tk.build_worklist(vol.block_coords, vol.n_blocks, T, intr, tcfg)[1]))
    wl_size = next(m for m in WORKLIST_SIZES if m >= max(live))
    over = sum(u > budget for u in unique)
    past = [i for i, m in enumerate(live) if m > JAX_WORKLIST_DEFAULT]
    _log(f"aligned allocation at the true poses: unique block keys a frame {min(unique)}-"
         f"{max(unique)} (median {sorted(unique)[len(unique) // 2]}) against allocate's dedup "
         f"budget of {budget} ({over} frame(s) over it), {n_keys} candidates a frame; n_blocks "
         f"{int(vol.n_blocks)}; live blocks in the frustum (n_active) up to {max(live)} (frame "
         f"{live.index(max(live))}), over the JAX class's default worklist of "
         f"{JAX_WORKLIST_DEFAULT} on {len(past)} frame(s)"
         + (f" from frame {past[0]}" if past else "") + f"; a caller of the JAX class would pass "
         f"{wl_size} (the first of WORKLIST_SIZES that holds it); the port's default worklist "
         f"{default_wl}: the whole pool of {pool} rows  [{gpu}]")
    if default_wl is not None:
        failures.append(f"MonoOdometryTSDF's default worklist_size is {default_wl}, not the "
                        "whole pool (ROADMAP C18)")
    del vol

    # -- B1 on one frame, B2 on one pair: kernel against plain ------------------
    figures = {tk.KERNEL: b1_frame_check(dec, truth, intr, rays, tcfg, pool, gpu, size)}
    if not figures[tk.KERNEL]["bitwise"]:
        failures.append(f"B1 at {size} differs from its plain version")
    b2_failures, figures[odo.KERNEL] = b2_pair_check(dec, intr, ocfg, gpu, size)
    failures += b2_failures
    (d0, _, i0), (d1, _, i1) = dec[0], dec[1]
    failures += b2_route_check((i0, d0, i1, d1, intr, ocfg), ocfg, gpu)

    # -- the live loop: frame to frame, then frame to model ---------------------
    gt_np = [g.cpu().numpy().astype(np.float64) for g in truth]
    kw = dict(device=dev)
    frames = raw[:N_ALIGNED_F2F]
    _run_frames(MonoOdometryTSDF(intr, cfg, **kw), raw[:3], False)
    pipe = MonoOdometryTSDF(intr, cfg, **kw)
    _sync(dev)
    build.launches.clear()
    frame_ms = _run_frames(pipe, frames, True)
    f2f_counts = {k: build.launches[k] for k in (tk.KERNEL, odo.KERNEL)}
    traj = pipe.trajectory[1:]
    a_f, r_f = ate(traj, gt_np[:N_ALIGNED_F2F]), rpe(traj, gt_np[:N_ALIGNED_F2F])
    rejected, overflow = pipe.odometry_failures, bool(pipe.volume.overflow)
    pipe.reset()
    sync_ms = _run_frames(pipe, frames, False)
    steady = sorted(frame_ms[1:])
    med = steady[len(steady) // 2]
    _log(f"aligned frame_to_frame over {N_ALIGNED_F2F} frames at {size} (the default "
         f"worklist, the whole pool of {pool}): "
         f"launches {json.dumps(f2f_counts)}; ATE rmse {a_f['rmse'] * 1e3:.3f} mm (max "
         f"{a_f['max'] * 1e3:.3f}), RPE {r_f['trans_rmse'] * 1e3:.3f} mm / "
         f"{np.degrees(r_f['rot_rmse']):.4f} deg against the color camera's truth; gate "
         f"rejections {rejected}, overflow {overflow}, n_blocks {int(pipe.volume.n_blocks)}; "
         f"ms/frame synchronized per frame: frame 0 {frame_ms[0]:.3f}, tracked median "
         f"{med:.3f}, max {steady[-1]:.3f}; one sync at the end {sync_ms:.3f} (limit "
         f"{FRAME_LIMIT_MS} ms)  [{gpu}]")
    if rejected or len(pipe.fitness) != N_ALIGNED_F2F - 1:
        failures.append(f"aligned frame_to_frame: {rejected} gate rejection(s)")
    if overflow or bool(pipe.volume.overflow):
        failures.append("aligned frame_to_frame: overflow at the default worklist")
    if not a_f["rmse"] <= ATE_LIMIT_M:
        failures.append(f"aligned frame_to_frame ATE {a_f['rmse']:.5f} m over {ATE_LIMIT_M} m")
    if f2f_counts != {tk.KERNEL: N_ALIGNED_F2F, odo.KERNEL: N_ALIGNED_F2F - 1}:
        failures.append(f"aligned frame_to_frame launches {f2f_counts}, not B1 once a frame "
                        "and B2 once a pair")

    t0 = time.perf_counter()
    mesh = pipe.extract_mesh()
    mesh_ms = (time.perf_counter() - t0) * 1e3
    E = mc.snap_extract_blocks(int(pipe.volume.n_blocks), tcfg.block_capacity)
    cells, tris = mc.exact_budgets(mc._survey(pipe.volume, tcfg, extract_blocks=E), tcfg)
    nt = int(mesh.num_triangles)
    finite = bool(np.isfinite(mesh.vertices).all() and np.isfinite(mesh.vertex_colors).all())
    _log(f"aligned mesh: {nt} triangles in {mesh_ms:.1f} ms (host clock, host copy included), "
         f"overflow {mesh.overflow}, finite {finite}; exact budgets {cells} cells / {tris} "
         f"triangles against extract_mesh's defaults 65536 / 131072  [{gpu}]")
    if mesh.overflow or nt < 10000 or not finite:
        failures.append(f"aligned mesh: {nt} triangles, overflow {mesh.overflow}, finite "
                        f"{finite}")
    del pipe, mesh

    _log(f"aligned frame_to_model: f2m_phase at {size}, the default worklist, over the first "
         f"{N_ALIGNED_F2M} frames (limit {FRAME_LIMIT_MS} ms/frame)  [{gpu}]")
    m_failures, f2m_counts, _, _ = f2m_phase(intr, cfg, raw[:N_ALIGNED_F2M],
                                             truth[:N_ALIGNED_F2M], dev, gpu, worklist_size=None)
    failures += [f"aligned {f}" for f in m_failures]
    for name in (tk.KERNEL, odo.KERNEL):
        figures[name].update(launches_f2f=f2f_counts[name], launches_f2m=f2m_counts[name])

    # -- the entry point on a log of the aligned frames --------------------------
    # cli.live_mono keeps the default worklist, the whole pool: at this voxel the frustum
    # holds more live blocks than the JAX package's scripts/live_mono.py keeps (ROADMAP C18)
    k = N_ALIGNED_F2F
    with tempfile.TemporaryDirectory() as tmp:
        log, out = os.path.join(tmp, "frames"), os.path.join(tmp, "out")
        rec = FrameRecorder(log, CameraCalibration(depth=intr, color=intr, serial="aligned"))
        for d, c in raw[:k]:
            rec.write(d, c)
        args = ["--source", f"replay:{log}", "--frames", str(k), "--voxel", str(voxel),
                "--headless", "--output", out]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", f"{PKG}.cli.live_mono", *args],
                           capture_output=True, text=True, timeout=600, cwd=REPO)
        names = sorted(os.listdir(out)) if os.path.isdir(out) else []
        mesh_bytes = (os.path.getsize(os.path.join(out, "latest_mesh.ply"))
                      if "latest_mesh.ply" in names else 0)
        said = r.stdout + r.stderr
        tail = [ln for ln in said.splitlines() if "gate rejections" in ln]
        cli_ate = float("nan")
        if "latest_trajectory.txt" in names:
            cli_traj = np.loadtxt(os.path.join(out, "latest_trajectory.txt")).reshape(-1, 4, 4)
            cli_ate = ate(list(cli_traj[1:]), gt_np[:k])["rmse"]
        _log(f"cli.live_mono --source replay:DIR --voxel {voxel} over {k} aligned frames: rc "
             f"{r.returncode}, {time.perf_counter() - t0:.1f} s (host clock, process start "
             f"included), wrote {names} (mesh {mesh_bytes} bytes), ATE rmse "
             f"{cli_ate * 1e3:.3f} mm; {' | '.join(tail)}  [{gpu}]")
        if (r.returncode != 0 or mesh_bytes == 0 or not tail
                or "0 gate rejections" not in tail[0] or not cli_ate <= ATE_LIMIT_M):
            failures.append(f"cli.live_mono --source replay: rc {r.returncode}, wrote "
                            f"{names}; {said[-1500:]}")
        elif "overflow False" not in tail[0]:
            failures.append(f"cli.live_mono --source replay: its default worklist against "
                            f"n_active up to {max(live)}, but {tail[0]}")
        _log(f"C18 (repaired): cli.live_mono builds MonoOdometryTSDF with the default "
             f"worklist, the whole pool of {pool} rows; at {size} and {voxel * 1e3:g} mm voxels "
             f"the frustum holds up to {max(live)} live blocks, over the JAX package's 2,048 on "
             f"{len(past)} of {k} frames" + (f" from frame {past[0]}" if past else "")
             + f"; the entry point's summary above must say overflow False  [{gpu}]")
    _log(f"aligned phase wall time {time.perf_counter() - t_phase:.1f} s (host clock)  [{gpu}]")
    return failures, figures


def main() -> int:
    import torch

    t_start = time.perf_counter()
    why = _port_beside()
    if why:
        return _fail(why)
    import numpy as np

    from azurekinect3dreconstruction_tpu_torch.core.camera import pixel_rays
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

    failures = native_build()
    phase_s = {}

    def timed(name, phase, *args):
        """``phase(*args)``, its wall time kept under ``name``."""
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return out

    cfg, intr, cam, poses, raw = _bench(dev, N_FRAMES)
    tcfg, ocfg = cfg.tsdf, cfg.odometry
    dec = [_decode(r, cfg, dev) for r in raw[:3]]
    gt = [torch.as_tensor(np.linalg.inv(poses[0]) @ T, dtype=torch.float32, device=dev)
          for T in poses]
    rays = pixel_rays(intr, dev)
    kernels = []

    # -- B1: one frame into a 2-frame volume, B2 on one pair: kernel vs plain --
    b1 = b1_frame_check(dec, gt, intr, rays, tcfg, 2048, gpu, "640x576")
    if not (b1["weight_equal_fraction"] >= B1_WEIGHT_EQUAL_MIN
            and b1["max_abs_err"] <= B1_VALUE_TOL):
        failures.append("B1 kernel disagrees with its plain version")
    kernels.append(dict(name=tk.KERNEL, route="cuda", source=f"{PKG}/csrc/tsdf_integrate.cu",
                        replaces="azurekinect3dreconstruction_tpu/ops/pallas/tsdf_kernels.py:323",
                        **b1))
    r24_failures, r24 = b1_odd_r_check(dec, gt, intr, rays, dev, gpu)
    failures += r24_failures
    kernels[0].update(r24)
    failures += b1_odd_r_check(dec, gt, intr, rays, dev, gpu, B1_WIDE_R)[0]

    b2_failures, b2 = b2_pair_check(dec, intr, ocfg, gpu, "640x576")
    failures += b2_failures
    (d0, _, i0), (d1, _, i1) = dec[0], dec[1]
    args = (i0, d0, i1, d1, intr, ocfg)
    ms_call = b2["odometry_call_ms"]
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
                        graph_replay_ms=ms_graph, **b2))
    five_failures, five_launches, five_err = b2_five_level_check(args, ocfg, gpu, "NFOV")
    failures += five_failures + b2_route_check(args, ocfg, gpu)
    kernels[1].update(five_level_max_abs_err=five_err, launches_five_level=five_launches)
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
    mono_ms = _run_frames(pipe, raw, False)
    _log(f"ms/frame (host clock, one sync after {N_FRAMES} frames): {mono_ms:.3f}  [{gpu}]")
    if n_rejected or len(fit) != N_FRAMES - 1:
        failures.append(f"{n_rejected} frame(s) rejected by the fitness gate")
    if overflow:
        failures.append("volume overflow")
    if not a["rmse"] <= ATE_LIMIT_M:
        failures.append(f"ATE rmse {a['rmse']:.4f} m over {ATE_LIMIT_M} m")
    if not (pts.shape[0] > 10000 and np.isfinite(pts).all() and np.isfinite(cols).all()):
        failures.append("surface extraction is empty or not finite")

    # -- the save path and frame-to-model tracking -----------------------------
    failures += timed("mesh", mesh_phase, pipe, tcfg, dev, gpu)
    failures += timed("compact", compact_timing, pipe.volume, tcfg, dev, gpu)
    del pipe
    poses32, raw32, gt32 = _f2m_frames(cam, raw, dev)
    f2m_failures, f2m_counts, _, _ = timed("f2m", f2m_phase, intr, cfg, raw32, gt32, dev, gpu)
    failures += f2m_failures
    for k in kernels:
        k["launches_frame_to_model"] = f2m_counts[k["name"]]
    dual_failures, dual_launches = timed("dual", dual_phase, intr, cfg, dev, gpu)
    failures += dual_failures
    kernels[0]["launches_dual"] = dual_launches
    rec_failures, rec_counts = timed("recorder", recorder_phase, intr, cfg, cam,
                                      raw32[:N_REC_FRAMES], gt32[:N_REC_FRAMES], dev, gpu)
    failures += rec_failures
    off_failures, off_counts = timed("offline", offline_phase, intr, cfg, cam,
                                      poses32[:N_OFFLINE_OUT], dev, gpu)
    failures += off_failures
    for k in kernels:
        k["launches_recorder"] = rec_counts[k["name"]]
        k["launches_offline"] = off_counts[k["name"]]
    reloc_failures, reloc_counts = timed("relocalize", reloc_phase, intr, cfg, cam, poses32,
                                          raw, dev, gpu)
    failures += reloc_failures
    for k in kernels:
        k["launches_relocalize"] = reloc_counts[k["name"]]
    failures += timed("incremental", incremental_phase, intr, cfg, raw, dev, gpu)
    frag_failures, frag_counts = timed("fragments", fragments_phase, intr, cfg, cam, dev, gpu)
    failures += frag_failures
    cloud_failures, cloud_counts = timed("cloud", cloud_phase, intr, cfg, cam, raw, gt, dev, gpu)
    failures += cloud_failures
    for k in kernels:
        k["launches_fragments"] = frag_counts[k["name"]]
        k["launches_cloud"] = cloud_counts[k["name"]]
    # no warm passes: the card's kernels and caches are warm from the phases before
    stream_failures, stream_counts = timed("streaming", streaming_phase, cfg, dev, gpu,
                                           STREAM_RUNS, True, True, False)
    failures += stream_failures
    for k in kernels:
        k["launches_streaming"] = stream_counts["one_way"][0][k["name"]]
        k["launches_streaming_quarter"] = stream_counts["one_way"][1][k["name"]]
        k["launches_streaming_revisit"] = stream_counts["revisit"][0][k["name"]]
        k["launches_streaming_revisit_quarter"] = stream_counts["revisit"][1][k["name"]]
        for part in ("revisit_short", "loss", "thrash", "f2m"):
            k[f"launches_streaming_{part}"] = stream_counts[part][k["name"]]
    sharded_failures, sharded_counts = timed("sharded", sharded_phase, intr, cfg, cam, raw,
                                              traj[1:], mono_ms, dev, gpu)
    failures += sharded_failures
    for k in kernels:
        for part, key in (("sharded", "launches_sharded"), ("grid", "launches_sharded_grid"),
                          ("dual", "launches_sharded_dual")):
            k[key] = sharded_counts[part][k["name"]]
    step_failures, step_counts = timed("device_step", device_step_phase, cfg, cam, raw, traj[1:],
                                        dev, gpu)
    failures += step_failures
    for k in kernels:
        for part, key in (("fused", "launches_fused_batch"), ("slam", "launches_slam_batch"),
                          ("fed", "launches_fed_pipeline")):
            k[key] = step_counts[part][k["name"]]
    serve_failures, serve_counts = timed("serve", serve_phase, intr, cfg, raw32, dev, gpu)
    failures += serve_failures
    rig_failures, rig_counts = timed("rig_calib", rig_calib_phase, dev, gpu)
    failures += rig_failures
    for k in kernels:
        k["launches_serve"] = serve_counts[k["name"]]
        k["launches_rig_calib_dual"] = rig_counts[k["name"]]
    aligned_failures, aligned = timed("aligned", aligned_phase, dev, gpu)
    failures += aligned_failures
    for k in kernels:
        k["aligned_1280x720"] = aligned.get(k["name"], {})
    paths_failures, paths = timed("aligned_paths", aligned_paths, dev, gpu)
    failures += paths_failures
    for k in kernels:
        k.update(paths[k["name"]])
    bench_failures, bench_counts = timed("bench", bench_phase, dev, gpu)
    failures += bench_failures
    for k in kernels:
        k["launches_bench"] = bench_counts.get(k["name"], 0)
    _log(f"phase wall times (s, host clock): {json.dumps(phase_s)}")
    _log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s (host clock)")
    if failures:
        return _fail("; ".join(failures))

    _log(json.dumps({"kernels": kernels}))
    _log(gpu)
    _log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


def _port_beside(device: str = "cuda"):
    """Why the package beside this script cannot run on ``device`` (no
    card, no package, another copy imported), or None; puts it on the
    import path."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        return "no CUDA device is available"
    pkg_dir = os.path.join(REPO, PKG)
    if not os.path.isdir(pkg_dir):
        return f"the {PKG} package is not beside this script"
    sys.path.insert(0, REPO)
    import azurekinect3dreconstruction_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(pkg_dir + os.sep):
        return f"imported {port.__file__}, not the package beside this script"
    return None


def _f32_hex(t) -> list:
    """The float32 values of ``t`` as 8-digit hex words, to compare runs to
    the bit."""
    import torch

    bits = t.detach().to(torch.float32).reshape(-1).cpu().contiguous().view(torch.int32)
    return [format(b & 0xFFFFFFFF, "08x") for b in bits.tolist()]


def b2_routes(odo, dims, grid: int, band: int) -> list:
    """Where each level's source planes live in B2's launch, in words: the
    shared route, the large-frame route with the pixels of each CTA's band
    whose gradients stay in shared memory, or not iterated."""
    levels = range(len(dims) // 3)
    out = []
    for lvl, r in zip(levels, odo.level_routes(dims, grid, band)):
        chunk = -(-dims[3 * lvl] * dims[3 * lvl + 1] // grid)
        out.append("not iterated" if dims[3 * lvl + 2] <= 0 else "shared" if r == odo.SHARED
                   else f"large ({r} of {chunk} band pixels resident)")
    return out


@contextlib.contextmanager
def b2_forced_large(odo, resident=None):
    """``pyramid_cuda`` with every level on the large-frame route, the
    gradients of ``resident`` pixels of each CTA's band in shared memory
    (None: as many as fit, ``resident_pixels``): ``level_routes`` replaced
    by that plan for the block."""
    cap = 1 << 30 if resident is None else resident
    saved = odo.level_routes
    odo.level_routes = lambda dims, grid, band: [
        min(odo.resident_pixels(H, W, grid, band), cap) for H, W in zip(dims[::3], dims[1::3])]
    try:
        yield
    finally:
        odo.level_routes = saved


def _b2_launch_us(call):
    """B2's device us per launch of ``call``: the median of ``ODO_ROUNDS``
    ``torch.profiler`` rounds of ``ODO_ROUND_CALLS`` calls each (``_device_us``),
    and the rounds."""
    import statistics

    rounds = [_device_us(call, ODO_ROUND_CALLS, "odometry")[0] for _ in range(ODO_ROUNDS)]
    seen = [r for r in rounds if r is not None]
    return (statistics.median(seen) if seen else None), rounds


def _wfov_pair(cfg, dev):
    """The first two bench sweep frames at 1024x1024 (WFOV unbinned),
    decoded on ``dev``: (i0, d0, i1, d1, intrinsics)."""
    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
        SyntheticCamera,
        orbit_trajectory,
    )

    intr = Intrinsics(*WFOV)
    cam = SyntheticCamera(intrinsics=intr, device=dev)
    (d0, _, i0), (d1, _, i1) = [_decode(_quantize(cam.render(T)), cfg, dev)
                                for T in orbit_trajectory(64, radius=0.35, angle_span=1.3)[:2]]
    return i0, d0, i1, d1, intr


def _aligned_pair(dev, scale: float):
    """The first two color-aligned sweep frames at ``scale`` x the 720p
    color intrinsics (1.5: 1920x1080, 3: 3840x2160), made as ``hd_phase``
    makes its frames, decoded on ``dev``: (i0, d0, i1, d1, intrinsics)."""
    cfg = _aligned_cfg()
    cal = _aligned_cals(scale)[0]
    _, raw, _, _ = _aligned_frames(dev, 2, cal)
    (d0, _, i0), (d1, _, i1) = [_decode(r, cfg, dev) for r in raw]
    return i0, d0, i1, d1, cal.color


def _res3072_pair(dev):
    """A color-aligned 4096x3072 frame pair (the k4a's RES_3072P: the whole
    4:3 sensor at the 2160p mode's focal length, its principal point moved
    by the margins), made as ``_aligned_pair`` makes the 3840x2160 one:
    (i0, d0, i1, d1, intrinsics)."""
    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics

    cfg = _aligned_cfg()
    cal = _aligned_cals(UHD_SCALE)[0]
    c = cal.color
    cal = dataclasses.replace(cal, color=Intrinsics(4096, 3072, c.fx, c.fy, c.cx + 128.0,
                                                    c.cy + 456.0))
    _, raw, _, _ = _aligned_frames(dev, 2, cal)
    (d0, _, i0), (d1, _, i1) = [_decode(r, cfg, dev) for r in raw]
    return i0, d0, i1, d1, cal.color


def b2_pair_timing(odo, args, dev) -> dict:
    """B2 on one frame pair (``args`` as ``compute_odometry_fast`` takes
    them): the routes of its levels, its device us per launch (median of
    rounds), ``compute_odometry_fast``'s ms a call (the pyramids and the
    launch, synchronized, median of ``ODO_REPS``), the pose, fitness and
    rmse as float32 hex; then level 0 alone
    (its own iterations, one launch a call) on the route the plan gives it,
    forced onto the large-frame route and forced onto it with nothing
    resident, each with its device us and ps per valid pixel-iteration."""
    from azurekinect3dreconstruction_tpu_torch.ops.image import build_pyramid

    i0, d0, i1, d1, intr, ocfg = args
    dev = d0.device
    grid, band = odo.launch_grid()
    levels = len(ocfg.pyramid_iters)
    pyr_s, pyr_t = build_pyramid(i0, d0, levels), build_pyramid(i1, d1, levels)
    dims = odo.pack_levels(pyr_s, pyr_t, intr, ocfg, dev)[1]
    res = odo.compute_odometry_fast(*args)
    us, rounds = _b2_launch_us(lambda: odo.compute_odometry_fast(*args))
    out = {"size": f"{intr.width}x{intr.height}", "routes": b2_routes(odo, dims, grid, band),
           "device_us_median": us, "device_us_rounds": rounds,
           "odometry_call_ms": _median_ms(lambda: odo.compute_odometry_fast(*args), dev,
                                          ODO_REPS),
           "pose_hex": _f32_hex(res.T_target_source[:3]), "fitness_hex": _f32_hex(res.fitness),
           "rmse_hex": _f32_hex(res.rmse), "fitness": float(res.fitness)}
    cfg1 = dataclasses.replace(ocfg, pyramid_iters=ocfg.pyramid_iters[:1])
    terms = (0.0 if ocfg.term == "depth" else 1.0, 0.0 if ocfg.term == "color" else 1.0)
    valid = b2_work(pyr_s[:1], pyr_t[:1], intr, cfg1, terms)[2]
    one = lambda: odo.odometry_pyramid(odo.pyramid_cuda, i0, d0, i1, d1, intr, cfg1)
    level0 = {"valid_pixel_iterations": valid,
              "routes": {"plan": b2_routes(odo, dims[:3], grid, band)[0]}}
    runs = [("plan", contextlib.nullcontext()), ("large", b2_forced_large(odo)),
            ("large_nothing_resident", b2_forced_large(odo, 0))]
    for name, ctx in runs:
        with ctx:
            t_us = _b2_launch_us(one)[0]
            if name != "plan":
                level0["routes"][name] = b2_routes(odo, dims[:3], grid, band)[0]
        level0[f"{name}_us"] = t_us
        level0[f"{name}_ps_per_valid_pixel_iteration"] = (None if t_us is None
                                                          else t_us * 1e6 / valid)
    out["level0"] = level0
    return out


def odometry_main() -> int:
    """``--odometry``: the odometry numbers of the package beside this
    script; its per-pair part (``b2_pair_timing``) needs the per-level
    plan."""
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
    del pipe
    pairs = {"640x576": args}
    for scale in (1.0, HD_SCALE, UHD_SCALE):
        pair = _aligned_pair(dev, scale)
        pairs[f"{pair[4].width}x{pair[4].height}"] = (*pair, cfg.odometry)
    pairs["4096x3072"] = (*_res3072_pair(dev), cfg.odometry)
    pairs["1024x1024"] = (*_wfov_pair(cfg, dev), cfg.odometry)
    b2 = {}
    for name, pair_args in pairs.items():
        b2[name] = b2_pair_timing(odo, pair_args, dev)
        _log(f"B2 at {name}: {json.dumps(b2[name])}  [{gpu}]")
    _log(json.dumps({
        "checkout": REPO, "gpu": gpu,
        "odometry_device_us_per_call": us, "odometry_kernels_per_call": per_call,
        "launch_counter_per_call": counter,
        "odometry_call_ms_synced_median": ms_call,
        "mono_ms_per_frame_synced_median": statistics.median(frame_ms[1:]),
        "mono_ms_per_frame_one_sync": loop_ms, "mono_gate_rejections": rejected,
        "pose": res.T_target_source.cpu().numpy().round(7).tolist(),
        "fitness": float(res.fitness),
        "b2_pairs": {k: {key: v[key] for key in ("routes", "device_us_median", "odometry_call_ms",
                                                  "pose_hex", "fitness_hex", "rmse_hex")}
                     for k, v in b2.items()}}))
    return 0


def _f2m_frames(cam, raw, dev):
    """The frame-to-model pass's frames: ``raw`` (the first ``N_FRAMES``
    of the bench sweep) and the sweep's next ones to ``N_F2M_FRAMES``:
    (the sweep's poses, the frames, the poses relative to the first as the
    ground truth)."""
    import numpy as np
    import torch

    from azurekinect3dreconstruction_tpu_torch.io.synthetic import orbit_trajectory

    poses = orbit_trajectory(64, radius=0.35, angle_span=1.3)[:N_F2M_FRAMES]
    frames = raw + [_quantize(cam.render(T)) for T in poses[len(raw):]]
    gt = [torch.as_tensor(np.linalg.inv(poses[0]) @ T, dtype=torch.float32, device=dev)
          for T in poses]
    return poses, frames, gt


def f2m_main(repeats: int = 3) -> int:
    """``--f2m``: frame-to-model tracking of the package beside this
    script, through calls every version of the port has: ``f2m_phase`` on
    the bench sweep's first 32 frames (its checks, ms/frame, the
    refinement's graph and op-by-op ms), then ``cli.bench``'s
    ``pipeline`` section and ``repeats`` times its ``frame_to_model``
    section (``f2m_fps`` by bench.py's method). Prints one JSON line; exits
    1 on a failed check."""
    import torch

    why = _port_beside()
    if why:
        return _fail(why)
    from azurekinect3dreconstruction_tpu_torch.cli import bench as cb
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gpu = _gpu_line()
    _log(f"gpu: {gpu}")
    build.build()
    build.library()
    cfg, intr, cam, _, raw = _bench(dev, N_FRAMES)
    _, frames, gt = _f2m_frames(cam, raw, dev)
    failures, _, times, loop_ms = f2m_phase(intr, cfg, frames, gt, dev, gpu)
    sections = dict(cb.SECTIONS)
    fps = []
    with tempfile.TemporaryDirectory() as out:
        b = cb.make_inputs(dev, out)
        runs = [("pipeline", sections["pipeline"])]
        runs += [("frame_to_model", sections["frame_to_model"])] * repeats
        for name, keys in runs:
            values, errors = cb.run_sections(b, [(name, keys)])
            if errors:
                failures.append(f"cli.bench section {name}: {errors}")
            if name == "frame_to_model":
                fps.append(values["f2m_fps"])
        del b
    _log(json.dumps({"checkout": REPO, "gpu": gpu, "f2m_phase_ms": times,
                     "f2m_ms_per_frame_one_sync": round(loop_ms, 3), "f2m_fps": fps,
                     "failures": failures}))
    return _fail("; ".join(failures)) if failures else 0


def integrate_main() -> int:
    """``--integrate``: B1's numbers of the package beside this script,
    through calls every version of the port has (the bound needs
    ``tsdf_kernels.updated_voxels``; a version without it prints null).
    The 16-frame mono loop runs at the pipeline's own default worklist
    (2,048 rows before ROADMAP C18's repair, the whole pool after), with
    its ms/frame."""
    import inspect
    import statistics

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

    # the 16-frame mono loop at the pipeline's default worklist: B1's device
    # time per launch, then ms/frame synchronized per frame and with one sync
    _run_frames(MonoOdometryTSDF(intr, cfg, device=dev), raw[:3], False)
    pipe = MonoOdometryTSDF(intr, cfg, device=dev)
    torch.cuda.synchronize()
    total, launches = _profiled(lambda: _run_frames(pipe, raw, False), "tsdf_integrate")
    pipe.reset()
    frame_ms = _run_frames(pipe, raw, True)
    pipe.reset()
    loop_ms = _run_frames(pipe, raw, False)
    default_wl = inspect.signature(MonoOdometryTSDF).parameters["worklist_size"].default
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
        "mono_b1_launches": launches, "mono_frames": N_FRAMES,
        "mono_default_worklist": default_wl,
        "mono_ms_per_frame_synced_median": statistics.median(frame_ms[1:]),
        "mono_ms_per_frame_one_sync": loop_ms, "mono_overflow": bool(pipe.volume.overflow)}))
    return 0


def calibration_main(device: str, scale: float, noises, seeds) -> int:
    """``--calibration``: the two-camera auto-calibration of the package
    beside this script (``calibration_runs``) on the test rig in
    ``Scene.default()`` and the bench rig in both scenes, at ``scale`` of
    640x576, at each relative depth noise in ``noises``, from each seed in
    ``seeds``: one JSON line a calibration; then, for each scene and noise,
    the larger share of pixels in front (``tracking.icp.
    free_space_shares``, both directions; null in a version without it)
    at the truth and at ``cli.bench.BENCH_RIG_WRONG_XI``'s poses of that
    scene (noise drawn from the last seed). The registration defaults
    with a 2 cm TSDF; on the CPU, 2 torch threads."""
    import numpy as np
    import torch

    why = _port_beside(device)
    if why:
        return _fail(why)
    from azurekinect3dreconstruction_tpu_torch.cli import bench
    from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
    from azurekinect3dreconstruction_tpu_torch.core import se3
    from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
    from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame
    from azurekinect3dreconstruction_tpu_torch.io.synthetic import Scene, SyntheticCamera
    from azurekinect3dreconstruction_tpu_torch.tracking import icp

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(2)
    gpu = _gpu_line() if dev.type == "cuda" else "cpu"
    _log(f"gpu: {gpu}")
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=0.02, sdf_trunc=0.08, block_resolution=8,
                                         block_capacity=2048, hash_capacity=8192))
    intr = Intrinsics.azure_kinect_depth_nfov()
    at = intr.scaled(scale)
    rays = pixel_rays(at, dev)
    pose = lambda xi: se3.se3_exp(torch.tensor(xi, dtype=torch.float64)).numpy()
    rigs = (("test rig", pose(CALIB_RIG_XI), ("default",)),
            ("bench rig", bench.bench_rig(), ("default", "cluttered")))
    tmp = tempfile.TemporaryDirectory()
    for noise in noises:
        for name, rig, scenes in rigs:
            for r in calibration_runs(intr, cfg, dev, tmp.name, rig, scenes, seeds, scale,
                                      noise):
                _log(json.dumps({"rig": name, **r, "gpu": gpu}))
        if not hasattr(icp, "free_space_shares"):
            continue
        rig = bench.bench_rig()
        for name in ("default", "cluttered"):
            gen = torch.Generator(device=dev).manual_seed(seeds[-1]) if noise else None
            cam = SyntheticCamera(scene=getattr(Scene, name)(), intrinsics=at,
                                  depth_noise=noise, generator=gen, device=dev)
            cc = cfg.camera
            d0, d1 = (RGBDFrame.from_raw(*(torch.from_numpy(a).to(dev) for a in cam.capture(T)),
                                         cc.depth_scale, cc.depth_trunc, cc.depth_min).depth
                      for T in (np.eye(4), rig))
            in_front = lambda T: _in_front(d0, d1, (at, at), (rays, rays), T)
            _log(json.dumps({
                "rig": "bench rig", "scene": name, "noise": noise, "noise_seed": seeds[-1],
                "in_front_at_truth": in_front(rig),
                "in_front_at": {k: in_front(pose(xi))
                                for k, (s, xi) in bench.BENCH_RIG_WRONG_XI.items() if s == name},
                "gpu": gpu}))
    tmp.cleanup()
    return 0


def streaming_main(device: str, scale) -> int:
    """``--streaming``: host streaming's checks alone (``streaming_phase``
    without the CLI subprocess: the corridor one way, its revisit, the
    thrash, the loss and recovery, frame-to-model on the revisit, the
    full-pool deferral) of the package beside this script, on the card or
    on the CPU (4 torch threads, no warm passes), at every run of
    ``STREAM_RUNS`` or only at ``scale``'s (the loss then runs there).
    Copied into a parent checkout it measures the parent with what it has.
    Prints one JSON line (the outcome, launches by pass, seconds); exits 1
    on a failed check."""
    import torch

    why = _port_beside(device)
    if why:
        return _fail(why)
    from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        build.build()
        build.library()
    else:
        torch.set_num_threads(4)
    gpu = _gpu_line() if dev.type == "cuda" else "cpu"
    _log(f"gpu: {gpu}")
    runs = [r for r in STREAM_RUNS if scale is None or r[0] == scale]
    if not runs:
        return _fail(f"no streaming run at scale {scale} (the runs' scales: "
                     f"{[r[0] for r in STREAM_RUNS]})")
    t0 = time.perf_counter()
    failures, counts = streaming_phase(PipelineConfig(), dev, gpu, runs=runs, cli=False,
                                       warm=dev.type == "cuda")
    _log(json.dumps({"streaming": "failed" if failures else "ok", "launches": counts,
                     "seconds": round(time.perf_counter() - t0, 1), "checkout": REPO,
                     "gpu": gpu}))
    return _fail("; ".join(failures)) if failures else 0


def aligned_main(jump_draws: int) -> int:
    """``--aligned``: ``aligned_phase`` and ``aligned_paths`` (the aligned
    recorder's ladder from ``jump_draws`` fresh seeds) alone on the card,
    the live camera's color-aligned frames through the package beside this
    script. Prints one JSON line; exits 1 on a failed check."""
    import torch

    why = _port_beside()
    if why:
        return _fail(why)
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    build.library()
    gpu = _gpu_line()
    _log(f"gpu: {gpu}")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    failures, figures = aligned_phase(dev, gpu)
    paths_failures, paths = aligned_paths(dev, gpu, jump_draws)
    for name, more in paths.items():
        figures.setdefault(name, {}).update(more)
    failures += paths_failures
    _log(json.dumps({"aligned": "failed" if failures else "ok", "kernels": figures,
                     "seconds": round(time.perf_counter() - t0, 1), "checkout": REPO,
                     "gpu": gpu}))
    return _fail("; ".join(failures)) if failures else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--odometry", action="store_true",
                      help="time only the odometry of the package beside this script")
    mode.add_argument("--integrate", action="store_true",
                      help="time only B1 (TSDF integrate) of the package beside this script")
    mode.add_argument("--f2m", action="store_true",
                      help="time only frame-to-model tracking (its refinement, ms/frame, "
                           "cli.bench's f2m_fps) of the package beside this script")
    mode.add_argument("--calibration", action="store_true",
                      help="only the two-camera auto-calibration of the package beside this "
                           "script, on the test rig and the bench rig")
    mode.add_argument("--streaming", action="store_true",
                      help="only host streaming's checks (the corridor one way, its revisit, "
                           "the thrash, the loss, frame-to-model, the deferral) of the package "
                           "beside this script")
    mode.add_argument("--aligned", action="store_true",
                      help="only the live camera's color-aligned paths (aligned_phase, then the "
                           "two-camera rig, the recorder, relocalization and the 1080p pass) of "
                           "the package beside this script")
    ap.add_argument("--device", default="cuda",
                    help="with --calibration or --streaming: cuda or cpu")
    ap.add_argument("--scale", type=float, default=None,
                    help="with --calibration: of the 640x576 depth camera (default 1); with "
                         "--streaming: only the corridor run at this scale (default every run)")
    ap.add_argument("--noise", type=float, nargs="+", default=[0.0],
                    help="with --calibration: relative depth noise levels")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(BENCH_CALIB_SEEDS),
                    help="with --calibration: RANSAC (and noise) generator seeds")
    ap.add_argument("--jump-draws", type=int, default=JUMP_DRAWS,
                    help="with --aligned: fresh seeds of the aligned recorder's fallback ladder")
    args = ap.parse_args()
    if args.calibration:
        sys.exit(calibration_main(args.device, args.scale or 1.0, args.noise, args.seeds))
    if args.streaming:
        sys.exit(streaming_main(args.device, args.scale))
    if args.aligned:
        sys.exit(aligned_main(args.jump_draws))
    if args.f2m:
        sys.exit(f2m_main())
    sys.exit(odometry_main() if args.odometry else integrate_main() if args.integrate
             else main())
