"""Constant-velocity motion prediction for tracking seeds (the counterpart
of the JAX package's ``tracking/motion.py``).

Prediction happens in the SE(3) tangent space: given camera-to-world poses
T[k-1], T[k], the relative motion is M = T[k-1]^-1 @ T[k] and the prediction
is T[k] @ exp(damp * log(M)); damping < 1 keeps seeds conservative. Poses,
log and exp are host float64 throughout (the JAX package rounds the log
and exp through float32).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.core import se3


def _damped_step(M: np.ndarray, damping: float) -> np.ndarray:
    """exp(damping * log(M)) in float64."""
    xi = se3.se3_log(torch.from_numpy(np.asarray(M, np.float64)))
    return se3.se3_exp(xi * damping).numpy()


class MotionModel:
    """Tiny host-side helper tracking the recent trajectory."""

    def __init__(self, damping: float = 0.9, max_history: int = 100):
        self.damping = damping
        self.poses: List[np.ndarray] = []
        self.max_history = max_history

    def update(self, T_world_cam) -> None:
        self.poses.append(np.asarray(T_world_cam, np.float64))
        if len(self.poses) > self.max_history:
            self.poses.pop(0)

    def predict(self) -> np.ndarray:
        """Predicted next camera-to-world pose (identity-motion fallback)."""
        if len(self.poses) == 0:
            return np.eye(4)
        if len(self.poses) == 1:
            return self.poses[-1].copy()
        return self.poses[-1] @ self.predict_relative()

    def predict_relative(self) -> np.ndarray:
        """Predicted frame-to-frame motion (target<-source seed for odometry)."""
        if len(self.poses) < 2:
            return np.eye(4)
        return _damped_step(np.linalg.inv(self.poses[-2]) @ self.poses[-1], self.damping)

    def reset(self) -> None:
        self.poses.clear()
