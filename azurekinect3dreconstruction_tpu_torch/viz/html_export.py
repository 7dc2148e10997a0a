"""Self-contained HTML/WebGL viewer export: interactive inspection of a
reconstruction with no dependencies (no Open3D, no network, no display);
a copy of the JAX package's ``viz/html_export.py``, byte-equal output.

Writes ONE portable .html file with the geometry embedded (base64
little-endian buffers) and the shared hand-written WebGL renderer
(``viz/webgl_core.py``) with orbit controls, so a scan can be inspected on
any machine with a browser. Keys: R resets the view, L toggles lighting, N
normal shading, P point rendering.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional, Union

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.types import (
    PointCloudHost,
    TriangleMeshHost,
)
from azurekinect3dreconstruction_tpu_torch.viz.webgl_core import CORE_JS, PAGE_CSS

_PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>__CSS__</style>
</head>
<body>
<canvas id="c"></canvas>
<div id="hud"></div>
<script>__CORE__</script>
<script>
"use strict";
const META = __META__;
const B64 = {
  pos: "__POS__",
  col: "__COL__",
  nrm: "__NRM__",
  idx: "__IDX__",
};
function decode(b64, Type) {
  if (!b64) return null;
  const bin = atob(b64);
  const bytes = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) bytes[i] = bin.charCodeAt(i);
  return new Type(bytes.buffer);   // little-endian on every WebGL platform
}
const hud = document.getElementById("hud");
const viewer = makeViewer(document.getElementById("c"), hud, META.title);
if (!META.n_vertices) {
  // empty reconstruction: report it instead of dying on pos.length; the
  // core loop keeps the __frames liveness hook ticking for CI drivers
  hud.textContent = META.title + "\\n(empty geometry)";
} else if (viewer) {
  if (!("mode" in META)) META.mode = B64.idx ? 1 : 0;
  viewer.setGeometry("main", META,
                     decode(B64.pos, Float32Array),
                     decode(B64.col, Uint8Array),
                     decode(B64.nrm, Float32Array),
                     decode(B64.idx, Uint32Array));
}
</script>
</body>
</html>
"""


def _b64(arr: Optional[np.ndarray]) -> str:
    if arr is None:
        return ""
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def decimate_geometry(verts, tris, colors, normals, max_vertices: int):
    """Uniformly stride geometry down to ~max_vertices (whole triangles kept
    for meshes, vertices compacted). Shared by the offline export and the
    live server snapshots."""
    if verts.shape[0] <= max_vertices:
        return verts, tris, colors, normals
    if tris is not None and len(tris):
        stride = -(-tris.shape[0] * 3 // max_vertices)
        tris = tris[::stride]
        used, inv = np.unique(tris.reshape(-1), return_inverse=True)
        tris = inv.reshape(-1, 3).astype(np.uint32)
        verts = verts[used]
        colors = colors[used] if colors is not None else None
        normals = normals[used] if normals is not None else None
    else:
        stride = -(-verts.shape[0] // max_vertices)
        verts = verts[::stride]
        colors = colors[::stride] if colors is not None else None
        normals = normals[::stride] if normals is not None else None
    return verts, tris, colors, normals


def geometry_arrays(geometry: Union[TriangleMeshHost, PointCloudHost],
                    max_vertices: int, want_normals: bool = True):
    """(verts f32, tris u32 | None, colors, normals) host arrays for a mesh
    or cloud, decimated to the vertex budget."""
    if isinstance(geometry, TriangleMeshHost):
        verts = np.asarray(geometry.vertices, np.float32)
        tris = np.asarray(geometry.triangles, np.uint32)
        colors = geometry.vertex_colors
        normals = geometry.vertex_normals
        if want_normals and normals is None and len(verts) and len(tris):
            normals = geometry.compute_vertex_normals().vertex_normals
    else:
        verts = np.asarray(geometry.points, np.float32)
        tris = None
        colors = geometry.colors
        normals = geometry.normals
    return decimate_geometry(verts, tris, colors, normals, max_vertices)


def soup_arrays(geometry, max_vertices: int):
    """(verts, colors) of a triangle SOUP — a mesh whose triangles are just
    arange(3V).reshape(-1, 3), what the incremental extractor emits —
    strided by WHOLE triangles (3 consecutive vertices each; the indexed
    decimator would compact/re-order the soup layout). Returns None when
    the geometry is not a soup. ONE definition shared by the live server's
    wire packer and the .html exporter: a soup's index buffer carries zero
    information (12 bytes/triangle on the wire, ~a third of an exported
    file), so both render it indexless as mode 2."""
    if not isinstance(geometry, TriangleMeshHost) or geometry.triangles is None:
        return None
    t = np.asarray(geometry.triangles)
    if not (t.size and t.size == len(geometry.vertices)
            and t.flat[0] == 0 and t.flat[-1] == t.size - 1
            and np.array_equal(t.reshape(-1),
                               np.arange(t.size, dtype=t.dtype))):
        return None
    verts = np.asarray(geometry.vertices, np.float32)
    colors = geometry.vertex_colors
    if verts.shape[0] > max_vertices:
        stride = -(-verts.shape[0] // max_vertices)
        verts = verts.reshape(-1, 3, 3)[::stride].reshape(-1, 3)
        if colors is not None:
            colors = np.asarray(colors).reshape(-1, 3, 3)[::stride]
            colors = colors.reshape(-1, 3)
    return verts, colors


def colors_u8(colors) -> Optional[np.ndarray]:
    if colors is None:
        return None
    c = np.asarray(colors)
    return (np.clip(c, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8) \
        if c.dtype != np.uint8 else c


def bounds_meta(verts: np.ndarray):
    lo = verts.min(axis=0) if len(verts) else np.zeros(3, np.float32)
    hi = verts.max(axis=0) if len(verts) else np.zeros(3, np.float32)
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - lo) * 0.5) or 1.0
    return [float(x) for x in center], radius


def save_html_viewer(path: str,
                     geometry: Union[TriangleMeshHost, PointCloudHost],
                     title: str = "Reconstruction",
                     max_vertices: int = 2_000_000) -> str:
    """Write a single self-contained interactive .html viewer for a mesh or
    point cloud. Returns the path written.

    Geometry above ``max_vertices`` is uniformly strided down so the file
    stays loadable (base64 is ~4/3 of the raw buffer size).
    """
    soup = soup_arrays(geometry, max_vertices)
    if soup is not None:
        (verts, colors), tris, normals, mode = soup, None, None, 2
    else:
        verts, tris, colors, normals = geometry_arrays(geometry, max_vertices)
        mode = 1 if (tris is not None and tris.size) else 0
        if mode == 0:
            tris = None
    col_u8 = colors_u8(colors)
    center, radius = bounds_meta(verts)

    meta = {
        "title": title,
        "mode": mode,
        "n_vertices": int(verts.shape[0]),
        "n_indices": int(tris.size) if tris is not None else 0,
        "center": center,
        "radius": radius,
    }
    html = (_PAGE
            .replace("__CSS__", PAGE_CSS)
            .replace("__CORE__", CORE_JS)
            .replace("__TITLE__", title)
            .replace("__META__", json.dumps(meta))
            .replace("__POS__", _b64(verts))
            .replace("__COL__", _b64(col_u8))
            .replace("__NRM__", _b64(np.asarray(normals, np.float32)
                                     if normals is not None else None))
            .replace("__IDX__", _b64(tris)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
