"""Rig extrinsics persistence: JSON files with the device serials, the
newest matching one loaded by default (a copy of the JAX package's
``calib/extrinsics.py``; the file format is the same, so a file written by
either package loads in the other)."""

from __future__ import annotations

import datetime
import glob
import json
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


class RigCalibration:
    """extrinsics[i] = 4x4 mapping camera-i coordinates into camera-0 (rig)
    coordinates, as float64 numpy arrays."""

    def __init__(self, serials: Sequence[str], extrinsics: Sequence[np.ndarray],
                 meta: Optional[Dict] = None):
        if len(serials) != len(extrinsics):
            raise ValueError("one extrinsic per serial")
        self.serials = list(serials)
        self.extrinsics = [np.asarray(e, np.float64) for e in extrinsics]
        self.meta = meta or {}

    def to_json(self) -> str:
        return json.dumps({
            "serials": self.serials,
            "extrinsics": [e.tolist() for e in self.extrinsics],
            "created": datetime.datetime.now().isoformat(),
            "meta": self.meta,
        }, indent=2)

    def save(self, directory: str = "calibration") -> str:
        os.makedirs(directory, exist_ok=True)
        ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(directory, f"rig_calibration_{ts}.json")
        with open(path, "w") as f:
            f.write(self.to_json())
        log.info("saved rig calibration -> %s", path)
        return path

    @staticmethod
    def from_json(s: str) -> "RigCalibration":
        d = json.loads(s)
        return RigCalibration(d["serials"], [np.asarray(e) for e in d["extrinsics"]],
                              d.get("meta"))

    @staticmethod
    def load_newest(directory: str = "calibration",
                    expected_serials: Optional[Sequence[str]] = None
                    ) -> Optional["RigCalibration"]:
        """The newest calibration file in ``directory`` whose serials match
        ``expected_serials`` (any, when not given); ``None`` if there is none."""
        files = sorted(glob.glob(os.path.join(directory, "rig_calibration_*.json")),
                       key=os.path.getmtime, reverse=True)
        for path in files:
            try:
                with open(path) as f:
                    cal = RigCalibration.from_json(f.read())
            except (json.JSONDecodeError, KeyError) as e:
                log.warning("skipping unreadable calibration %s: %s", path, e)
                continue
            if expected_serials is not None and list(expected_serials) != cal.serials:
                log.warning("calibration %s is for a different rig (serials %s); skipping",
                            os.path.basename(path), cal.serials)
                continue
            log.info("loaded rig calibration %s", os.path.basename(path))
            return cal
        return None
