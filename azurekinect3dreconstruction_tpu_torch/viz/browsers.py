"""Offline reconstruction result browsers (a copy of the JAX package's
``viz/browsers.py``):

- :class:`ReconstructionBrowser` — list saved results by mtime, pick one,
  view ('R' resets the view inside the viewer).
- :func:`load_latest_reconstruction` — the newest .ply under results/ (a
  mesh if the filename contains "mesh").
- :func:`load_latest_mesh` — the newest mesh file (.ply/.obj).

Loading works without Open3D (via viz.savers.read_ply); only interactive
display needs it.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning
from azurekinect3dreconstruction_tpu_torch.viz.o3d_bridge import view_geometry


def list_results(directory: str = "results", patterns=("*.ply", "*.obj")
                 ) -> List[str]:
    files: List[str] = []
    for p in patterns:
        files.extend(glob.glob(os.path.join(directory, p)))
    return sorted(files, key=os.path.getmtime, reverse=True)


def load_latest_reconstruction(directory: str = "results") -> Optional[Tuple[str, str]]:
    """Newest .ply; returns (path, kind) with kind mesh/pointcloud by the
    name-contains-"mesh" rule."""
    files = [f for f in list_results(directory, ("*.ply",))]
    if not files:
        log_warning(f"no .ply results under {directory}")
        return None
    path = files[0]
    kind = "mesh" if "mesh" in os.path.basename(path).lower() else "pointcloud"
    return path, kind


def load_latest_mesh(directory: str = "results") -> Optional[str]:
    files = [f for f in list_results(directory)
             if "mesh" in os.path.basename(f).lower() or f.endswith(".obj")]
    return files[0] if files else None


class ReconstructionBrowser:
    """Interactive result chooser."""

    def __init__(self, directory: str = "results"):
        self.directory = directory

    def list(self) -> List[str]:
        files = list_results(self.directory)
        for i, f in enumerate(files):
            log_info(f"[{i}] {os.path.basename(f)}")
        return files

    def view(self, index: int = 0) -> bool:
        files = list_results(self.directory)
        if not files or index >= len(files):
            log_warning("no such result")
            return False
        return view_geometry(files[index])

    def run_interactive(self) -> None:  # pragma: no cover - needs a user
        files = self.list()
        if not files:
            return
        try:
            choice = int(input("view which result? ") or "0")
        except ValueError:
            choice = 0
        self.view(choice)
