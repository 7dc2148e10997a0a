"""azurekinect3dreconstruction_tpu_torch — the PyTorch/CUDA port of
``azurekinect3dreconstruction_tpu``.

Module paths mirror the JAX package, so each counterpart is easy to find.
The port imports ``torch`` and ``numpy`` only, never ``jax``. Every function
takes its device explicitly (see :mod:`.core.device`): on a CPU tensor the
plain PyTorch version of each kernel runs; on a CUDA tensor the hand-written
Hopper kernel under ``csrc/`` runs, or the call raises.

Ported so far: the single-camera frame-to-frame SLAM loop
(:class:`.pipelines.mono_odometry_tsdf.MonoOdometryTSDF`) with its two
kernels, TSDF worklist integration and per-level Gauss-Newton odometry.
"""

__version__ = "0.1.0"
