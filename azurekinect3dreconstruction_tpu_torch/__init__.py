"""azurekinect3dreconstruction_tpu_torch — the PyTorch/CUDA port of
``azurekinect3dreconstruction_tpu``.

Module paths mirror the JAX package, so each counterpart is easy to find.
The port imports ``torch`` and ``numpy`` only, never ``jax``. Entry points
take a keyword ``device`` that defaults to ``"cuda"`` and raises without a
card (see :mod:`.core.device`): on a CPU tensor the plain PyTorch version of
each kernel runs; on a CUDA tensor the hand-written Hopper kernel under
``csrc/`` runs, or the call raises.

Ported so far: the single-camera SLAM loop
(:class:`.pipelines.mono_odometry_tsdf.MonoOdometryTSDF`, frame to frame or
frame to model, with relocalization) with its two kernels, TSDF worklist
integration and per-level Gauss-Newton odometry; mesh extraction (full and
incremental) and saving; two-camera fusion with its FPFH + RANSAC + ICP
calibration (:class:`.pipelines.dual_fusion.DualCameraFusion`); the
recorder, the offline bundle, the fragment pipeline and the point-cloud
accumulator; the cloud meshers of :mod:`.meshing`; host streaming; the
(cam x blk) sharded volume of :mod:`.parallel.sharded_volume`, which
``DualCameraFusion(sharded=True)`` runs on; and a headless entry point for
each pipeline under :mod:`.cli`.
"""

__version__ = "0.1.0"
