"""Offline result browsers: the port's counterpart of the JAX package's
``scripts/view_results.py``.

    python -m azurekinect3dreconstruction_tpu_torch.cli.view_results \\
        --dir results [--mode latest|mesh|choose] [--list-only] [--html OUT.html]

``--mode latest`` takes the newest .ply (a mesh if its name says so),
``mesh`` the newest mesh (.ply or .obj), ``choose`` lists the results
newest first and asks which. The result opens in Open3D's viewer, or with
``--html`` is written as a self-contained WebGL page
(``viz.html_export``), which needs no display. ``--list-only`` lists and
stops. Host only: needs neither torch's card nor jax.
"""

from __future__ import annotations

import argparse
import os

from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost, TriangleMeshHost
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning
from azurekinect3dreconstruction_tpu_torch.viz.browsers import (
    ReconstructionBrowser,
    load_latest_mesh,
    load_latest_reconstruction,
)
from azurekinect3dreconstruction_tpu_torch.viz.html_export import save_html_viewer
from azurekinect3dreconstruction_tpu_torch.viz.o3d_bridge import view_geometry
from azurekinect3dreconstruction_tpu_torch.viz.savers import read_geometry


def _pick(args):
    """The result to show, or None."""
    if args.mode == "choose":
        browser = ReconstructionBrowser(args.dir)
        files = browser.list()
        if not files or args.list_only:
            return None
        try:
            choice = int(input("view which result? ") or "0")
        except ValueError:
            choice = 0
        if choice >= len(files):
            log_warning("no such result")
            return None
        return files[choice]
    if args.mode == "latest":
        hit = load_latest_reconstruction(args.dir)
        if hit is None:
            return None
        path, kind = hit
        log_info(f"newest result: {path} ({kind})")
        return path
    path = load_latest_mesh(args.dir)
    if path is None:
        log_warning("no mesh results")
        return None
    log_info(f"newest mesh: {path}")
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["choose", "latest", "mesh"], default="latest")
    ap.add_argument("--dir", default="results")
    ap.add_argument("--list-only", action="store_true")
    ap.add_argument("--html", default=None, metavar="OUT.html",
                    help="write the result as a self-contained interactive WebGL page instead "
                         "of opening a window (works headless)")
    args = ap.parse_args(argv)

    path = _pick(args)
    if path is None or args.list_only:
        return 0
    if args.html:
        verts, cols, faces = read_geometry(path)
        geom = (TriangleMeshHost(vertices=verts, triangles=faces, vertex_colors=cols)
                if faces is not None and len(faces)
                else PointCloudHost(points=verts, colors=cols))
        log_info(f"HTML viewer written: "
                 f"{save_html_viewer(args.html, geom, title=os.path.basename(path))}")
        return 0
    view_geometry(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
