"""Score an estimated camera trajectory against ground truth (ATE / RPE):
the port's counterpart of the JAX package's ``scripts/eval_trajectory.py``.

Files hold one flattened 4x4 pose per line (``viz.savers.ResultSaver``).
The synthetic source saves ground truth beside the estimate, so a full
accuracy check is:

    python -m azurekinect3dreconstruction_tpu_torch.cli.live_mono --source synthetic
    python -m azurekinect3dreconstruction_tpu_torch.cli.eval_trajectory \\
        results/latest_trajectory.txt results/latest_gt_trajectory.txt

Host numpy only (``utils.evaluation``); it needs no card and no torch.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from azurekinect3dreconstruction_tpu_torch.utils.evaluation import ate, rpe


def load_trajectory(path: str):
    """A trajectory file -> a list of 4x4 float64 arrays."""
    arr = np.loadtxt(path)
    return [a.reshape(4, 4) for a in np.atleast_2d(arr)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("estimate", help="estimated trajectory txt")
    ap.add_argument("ground_truth", help="ground-truth trajectory txt")
    ap.add_argument("--delta", type=int, default=1,
                    help="RPE frame gap (default 1 = per-step error)")
    ap.add_argument("--no-align", action="store_true",
                    help="skip the rigid ATE alignment (compare in the shared world frame)")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable JSON line instead")
    args = ap.parse_args(argv)

    est, gt = load_trajectory(args.estimate), load_trajectory(args.ground_truth)
    if len(est) != len(gt):
        sys.exit(f"trajectory lengths differ: estimate {len(est)} vs ground truth {len(gt)} poses")
    a = ate(est, gt, align=not args.no_align)
    r = rpe(est, gt, delta=args.delta)
    if args.json:
        print(json.dumps({"n_poses": len(est), "ate_rmse_m": a["rmse"], "ate_mean_m": a["mean"],
                          "ate_median_m": a["median"], "ate_max_m": a["max"],
                          "final_drift_m": a["final_drift"], "rpe_delta": args.delta,
                          "rpe_trans_rmse_m": r["trans_rmse"],
                          "rpe_rot_rmse_deg": float(np.degrees(r["rot_rmse"]))}))
        return 0
    print(f"poses:        {len(est)}")
    print(f"ATE rmse:     {a['rmse'] * 1000:8.2f} mm   (mean {a['mean'] * 1000:.2f}, median "
          f"{a['median'] * 1000:.2f}, max {a['max'] * 1000:.2f})")
    print(f"final drift:  {a['final_drift'] * 1000:8.2f} mm  (unaligned, last pose)")
    print(f"RPE (d={args.delta}):    {r['trans_rmse'] * 1000:8.2f} mm  "
          f"{np.degrees(r['rot_rmse']):.4f} deg  per step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
