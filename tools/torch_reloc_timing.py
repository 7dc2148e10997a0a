"""The relocalizer's attempts by rung, and the frame-to-model model refresh,
timed on one card.

    python tools/torch_reloc_timing.py [--root DIR] [--device cuda|cpu]
                                       [--scale S] [--reps N]

Imports the PyTorch package from ``--root`` (default: this checkout), so
one call can time a parent checkout and this one side by side (``for r in
build/parent . . build/parent; do python tools/torch_reloc_timing.py
--root $r; done``). At ``cli.bench``'s configuration (its 16,384-block pool
of 5 mm voxels in 16^3 blocks, its 64-pose sweep at 640x576 unless
``--scale``), the sweep is fused at its true poses with
``tsdf.integrate_frame``, then:

- ``refresh_ms``: ``extract_sampled_surface_model`` as
  ``MonoOdometryTSDF(tracking="frame_to_model")`` refreshes its model (its
  32,768 points from 256 blocks within ``model_reach``) at sweep pose 31;
- the attempts for the frame of sweep pose 33, which no fusion saw, by what
  their hint makes them run: ``rung0_cold_ms`` (pose 32 as the hint, the
  model extracted first), ``rung0_ms`` (the same from the cached model),
  ``slid_ms`` (pose 32 moved 14 cm along the camera's x: whatever the
  ladder does with a hint off along the surface) and ``global_ms`` (a
  garbage hint 1.3 m off: rung 0 rejected, the descriptor ladder), each
  with the rung that returned, or the reject, and the pose error.

Every time is the median of ``--reps`` calls on the host clock with the
device synchronized around each. A ``Relocalizer.attempt`` without the
color argument (before the slide gate) is called without it. Prints the
card's name and power limit, then one JSON line. Needs no jax.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys
import time


def _gpu_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    pkg = "azurekinect3dreconstruction_tpu_torch"
    bench = importlib.import_module(f"{pkg}.cli.bench")
    mc = importlib.import_module(f"{pkg}.tsdf.marching_cubes")
    tsdf = importlib.import_module(f"{pkg}.tsdf.volume")
    se3 = importlib.import_module(f"{pkg}.core.se3")
    model_reach = importlib.import_module(f"{pkg}.tsdf.streaming").model_reach
    Relocalizer = importlib.import_module(f"{pkg}.tracking.relocalize").Relocalizer
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(4)
    gpu = _gpu_line() if dev.type == "cuda" else "cpu"
    print(f"gpu: {gpu}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        """(last result, median ms of ``--reps`` synchronized calls)."""
        out, ms = None, []
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(ms))

    b = bench.make_inputs(dev, "", scale=args.scale)
    cfg = b.cfg
    vol = tsdf.create(cfg.tsdf, dev)
    for d, c, T in zip(b.depths, b.colors, b.poses):
        vol = tsdf.integrate_frame(vol, d, c, b.rays, T, b.intr, cfg.tsdf)
    sync()
    out = {"root": os.path.abspath(args.root), "n_blocks": int(vol.n_blocks), "gpu": gpu}
    T31 = b.poses[31]
    _, out["refresh_ms"] = timed(lambda: mc.extract_sampled_surface_model(
        vol, cfg.tsdf, 32768, T31, model_reach(cfg), sample_blocks=256))

    probe = 33
    depth, color = b.depths[probe], b.colors[probe]
    truth = b.sweep[probe]
    with_color = "color" in inspect.signature(Relocalizer.attempt).parameters

    def attempt(reloc, hint):
        if with_color:
            return reloc.attempt(vol, depth, color, T_hint=hint)
        return reloc.attempt(vol, depth, T_hint=hint)

    def err(T):
        if T is None:
            return None
        xi = se3.se3_log(torch.as_tensor(np.linalg.inv(truth) @ T)).numpy()
        return [round(float(np.linalg.norm(xi[:3])) * 1e3, 3),
                round(float(np.linalg.norm(xi[3:])) * 1e3, 3)]

    hint = b.sweep[probe - 1]
    slid = hint @ np.array([[1, 0, 0, 0.14], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], float)
    garbage = hint.copy()
    garbage[:3, 3] += [0.9, -0.6, 0.8]
    reloc = Relocalizer(b.intr, cfg, device=dev, rays=b.rays)
    reloc.warmup(vol)
    cold = []
    for _ in range(args.reps):
        reloc._model_cache = None
        sync()
        t0 = time.perf_counter()
        attempt(reloc, hint)
        sync()
        cold.append((time.perf_counter() - t0) * 1e3)
    out["rung0_cold_ms"] = float(np.median(cold))
    for name, h in (("rung0", hint), ("slid", slid), ("global", garbage)):
        hints = reloc.n_hint_success
        T, out[f"{name}_ms"] = timed(lambda: attempt(reloc, h))
        out[name] = {"returned": ("rung 0" if reloc.n_hint_success > hints else "global")
                     if T is not None else reloc.last_reject, "err_mm_mrad": err(T)}
    for k in ("n_texture_rejects", "n_free_space_rejects"):
        out[k] = getattr(reloc, k, None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
