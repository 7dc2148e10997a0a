"""Geometry persistence: PLY / OBJ / trajectory files.

A copy of the JAX package's ``viz/savers.py`` on numpy: binary
little-endian (default) or ASCII PLY point clouds and meshes, OBJ meshes,
their readers, PNG mesh previews (``viz.render``), and the timestamped +
``latest_*`` dual-save convention of :class:`ResultSaver`. Binary PLY goes
through the C++ runtime (``io.native``) when its library loads, as in the
JAX package, else through the pure-Python path, which writes the same bytes
(``tests/test_torch_native.py``); ``io.native`` logs the fallback once.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence, Tuple

import numpy as np

from azurekinect3dreconstruction_tpu_torch.core.types import PointCloudHost, TriangleMeshHost


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def write_ply_point_cloud(path: str, cloud: PointCloudHost, binary: bool = True) -> None:
    if binary:
        # the C++ writer (native/kinrt.cpp) when its library loads
        from azurekinect3dreconstruction_tpu_torch.io import native

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if native.write_ply_points_native(path, np.asarray(cloud.points, np.float32),
                                          cloud.colors, cloud.normals):
            return
    pts = np.asarray(cloud.points, np.float32)
    n = pts.shape[0]
    has_color = cloud.colors is not None
    has_normal = cloud.normals is not None
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_normal:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_normal:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if has_color:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if has_normal:
        nr = np.asarray(cloud.normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = nr[:, 0], nr[:, 1], nr[:, 2]
    if has_color:
        c = np.clip(np.asarray(cloud.colors) * 255.0, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(rec.tobytes())
        else:
            for row in rec:
                f.write((" ".join(str(x) for x in row) + "\n").encode())


def write_ply_mesh(path: str, mesh: TriangleMeshHost, binary: bool = True) -> None:
    if binary and mesh.vertex_normals is None:
        from azurekinect3dreconstruction_tpu_torch.io import native

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if native.write_ply_mesh_native(path, np.asarray(mesh.vertices, np.float32),
                                        np.asarray(mesh.triangles, np.int32),
                                        mesh.vertex_colors):
            return
    v = np.asarray(mesh.vertices, np.float32)
    t = np.asarray(mesh.triangles, np.int32)
    has_color = mesh.vertex_colors is not None
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {v.shape[0]}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {t.shape[0]}",
               "property list uchar int vertex_indices", "end_header"]

    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_color:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.zeros(v.shape[0], dtype=fields)
    rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
    if has_color:
        c = np.clip(np.asarray(mesh.vertex_colors) * 255.0, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]
    face = np.zeros(t.shape[0], dtype=[("n", "u1"), ("i", "<i4", (3,))])
    face["n"] = 3
    face["i"] = t

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(rec.tobytes())
            f.write(face.tobytes())
        else:
            for row in rec:
                f.write((" ".join(str(x) for x in row) + "\n").encode())
            for row in face:
                f.write((f"3 {row['i'][0]} {row['i'][1]} {row['i'][2]}\n").encode())


def write_obj_mesh(path: str, mesh: TriangleMeshHost) -> None:
    """OBJ export (the reference writes meshes as .obj at CreateMesh.py:444)."""
    v = np.asarray(mesh.vertices, np.float32)
    t = np.asarray(mesh.triangles, np.int32) + 1  # OBJ is 1-indexed
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = []
    if mesh.vertex_colors is not None:
        c = np.asarray(mesh.vertex_colors, np.float32)
        for p, cc in zip(v, c):
            lines.append(f"v {p[0]} {p[1]} {p[2]} {cc[0]} {cc[1]} {cc[2]}")
    else:
        for p in v:
            lines.append(f"v {p[0]} {p[1]} {p[2]}")
    for f3 in t:
        lines.append(f"f {f3[0]} {f3[1]} {f3[2]}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_ply(path: str):
    """Minimal PLY reader (binary/ascii) for round-trip tests and the offline
    result browsers. Returns (vertices, colors_or_None, faces_or_None)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    binary = any("binary_little_endian" in l for l in header)
    elems = []  # (name, count, [(prop, type)])
    cur = None
    for l in header:
        parts = l.split()
        if not parts:
            continue
        if parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elems.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur[2].append(("__list__", (parts[2], parts[3], parts[4])))
            else:
                cur[2].append((parts[-1], parts[1]))
    tmap = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1",
            "uint8": "u1", "int": "<i4", "int32": "<i4"}
    verts = cols = faces = None
    off = head_end
    body_lines = None
    if not binary:
        body_lines = data[head_end:].decode().splitlines()
        li = 0
    for name, count, props in elems:
        if name == "vertex":
            fields = [(p, tmap[t]) for p, t in props]
            if binary:
                rec = np.frombuffer(data, dtype=fields, count=count, offset=off)
                off += rec.itemsize * count
            else:
                rows = [body_lines[li + i].split() for i in range(count)]
                li += count
                rec = np.zeros(count, dtype=fields)
                for j, (p, t) in enumerate(fields):
                    col = np.array([r[j] for r in rows])
                    rec[p] = col.astype(np.float64 if "f" in t else np.int64)
            verts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
            if "red" in rec.dtype.names:
                cols = np.stack([rec["red"], rec["green"], rec["blue"]], -1).astype(np.float32) / 255.0
        elif name == "face":
            if binary:
                faces = np.zeros((count, 3), np.int32)
                for i in range(count):
                    n = data[off]
                    off += 1
                    idx = np.frombuffer(data, dtype="<i4", count=n, offset=off)
                    off += 4 * n
                    faces[i] = idx[:3]
            else:
                faces = np.array(
                    [body_lines[li + i].split()[1:4] for i in range(count)], np.int32
                )
                li += count
    return verts, cols, faces


def read_obj(path: str):
    """Minimal OBJ reader (v [r g b] / f lines, the write_obj_mesh format;
    faces with v/vt/vn syntax are accepted, extra face vertices are fanned).
    Returns (vertices, colors_or_None, faces_or_None) like :func:`read_ply`.
    """
    verts, cols, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    cols.append([float(x) for x in parts[4:7]])
            elif parts[0] == "f":
                # OBJ indices are 1-based; NEGATIVE refs are relative to the
                # vertices parsed SO FAR (legal per spec, emitted by several
                # exporters) — resolve them here, or numpy fancy-indexing
                # would silently wrap them from the end of the final array
                raw = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in raw]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    c = np.asarray(cols, np.float32) if len(cols) == len(verts) and cols else None
    t = np.asarray(faces, np.int32) if faces else None
    return v, c, t


def read_geometry(path: str):
    """Extension-dispatched mesh/cloud load: .ply via read_ply, .obj via
    read_obj. Raises ValueError for anything else (instead of garbage-
    parsing)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return read_ply(path)
    if ext == ".obj":
        return read_obj(path)
    raise ValueError(f"unsupported geometry format: {path!r} (ply/obj only)")


class ResultSaver:
    """Timestamped + ``latest_*`` dual-save convention over an output dir."""

    def __init__(self, output_dir: str = "results"):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def _paths(self, kind: str, ext: str) -> Tuple[str, str]:
        ts = _timestamp()
        return (
            os.path.join(self.output_dir, f"{kind}_{ts}.{ext}"),
            os.path.join(self.output_dir, f"latest_{kind}.{ext}"),
        )

    def save_point_cloud(self, cloud: PointCloudHost, kind: str = "pointcloud") -> str:
        p, latest = self._paths(kind, "ply")
        write_ply_point_cloud(p, cloud)
        write_ply_point_cloud(latest, cloud)
        return p

    def save_mesh(self, mesh: TriangleMeshHost, kind: str = "mesh", obj: bool = False) -> str:
        ext = "obj" if obj else "ply"
        p, latest = self._paths(kind, ext)
        (write_obj_mesh if obj else write_ply_mesh)(p, mesh)
        (write_obj_mesh if obj else write_ply_mesh)(latest, mesh)
        return p

    def save_trajectory(self, poses: Sequence[np.ndarray], kind: str = "trajectory") -> str:
        """4x4 pose list -> text file, one flattened 4x4 per block (matches
        the reference's np.savetxt trajectory dumps)."""
        p, latest = self._paths(kind, "txt")
        arr = np.stack([np.asarray(T).reshape(16) for T in poses])
        np.savetxt(p, arr)
        np.savetxt(latest, arr)
        return p

    def save_preview(self, mesh: TriangleMeshHost, kind: str = "preview") -> str:
        """Shaded PNG preview of a mesh (``viz.render``: no GL, no Open3D),
        dual-saved like every other artifact."""
        from azurekinect3dreconstruction_tpu_torch.viz.render import save_mesh_preview

        p, latest = self._paths(kind, "png")
        save_mesh_preview(mesh, p)
        save_mesh_preview(mesh, latest)
        return p

    @staticmethod
    def load_trajectory(path: str):
        arr = np.loadtxt(path)
        if arr.ndim == 1:
            arr = arr[None]
        return [a.reshape(4, 4) for a in arr]
