"""Marching-cubes case tables, generated — not transcribed.

A copy of the JAX package's ``tsdf/mc_tables.py`` (numpy only; that module
cannot be imported without jax). ``tests/test_torch_mesh.py`` holds the
tables equal.

Rather than hand-typing the classic 256x16 triangle table (and inheriting its
typo risk), we derive it constructively at import time:

1. Corner k of the unit cube sits at ((k>>0)&1, (k>>1)&1, (k>>2)&1); the 12
   edges are the corner pairs differing in exactly one bit.
2. For each of the 256 inside/outside configurations, the cut edges are those
   whose endpoints differ. On every cube face, cut edges are paired by the
   marching-squares rule with the ambiguous (4-cut) case resolved by a fixed,
   face-symmetric convention: **each inside corner gets its own cap**. Since
   the rule depends only on the shared face's corner signs, adjacent cubes
   always agree -> the global surface is watertight and manifold.
3. Pairings chain cut edges into closed loops; each loop is fan-triangulated.
4. Winding is fixed per triangle so normals point toward the *positive*
   (outside/free-space) region, by checking against the trilinear field
   gradient at the triangle centroid.

Max 5 triangles per cell (asserted during generation). Outputs:
- TRI_TABLE: int32[256, 15] edge indices, -1 padded
- TRI_COUNT: int32[256]
- EDGE_ENDPOINTS: int32[12, 2] corner indices per edge
- CORNER_OFFSETS: int32[8, 3]
"""

from __future__ import annotations

import numpy as np

CORNER_OFFSETS = np.array([[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)],
                          dtype=np.int32)

EDGE_ENDPOINTS = np.array(
    [(a, b) for a in range(8) for b in range(a + 1, 8) if bin(a ^ b).count("1") == 1],
    dtype=np.int32,
)  # 12 edges

_EDGE_INDEX = {(int(a), int(b)): i for i, (a, b) in enumerate(EDGE_ENDPOINTS)}


def _edge_id(a: int, b: int) -> int:
    return _EDGE_INDEX[(min(a, b), max(a, b))]


def _faces():
    """6 faces as (axis, side, [4 corners in cyclic order])."""
    out = []
    for axis in range(3):
        for side in range(2):
            corners = [k for k in range(8) if (k >> axis) & 1 == side]
            # order the 4 corners cyclically around the face
            u_axis, v_axis = [a for a in range(3) if a != axis]
            def key(k):
                return ((k >> u_axis) & 1, (k >> v_axis) & 1)
            c = sorted(corners, key=key)  # (0,0),(0,1),(1,0),(1,1)
            cyc = [c[0], c[1], c[3], c[2]]
            out.append((axis, side, cyc))
    return out


_FACES = _faces()


def _face_pairings(config: int):
    """For each face, pair up its cut edges; returns list of (edge, edge)."""
    inside = [(config >> k) & 1 for k in range(8)]
    pairs = []
    for _, _, cyc in _FACES:
        # face edges in cyclic order: (c0,c1),(c1,c2),(c2,c3),(c3,c0)
        fedges = [(cyc[i], cyc[(i + 1) % 4]) for i in range(4)]
        cut = [i for i, (a, b) in enumerate(fedges) if inside[a] != inside[b]]
        if not cut:
            continue
        if len(cut) == 2:
            e0 = _edge_id(*fedges[cut[0]])
            e1 = _edge_id(*fedges[cut[1]])
            pairs.append((e0, e1))
        elif len(cut) == 4:
            # alternating case: corners alternate in/out around the face.
            # Convention: each INSIDE corner is capped by the two cut edges
            # adjacent to it.
            for ci in range(4):
                if inside[cyc[ci]]:
                    ea = _edge_id(*fedges[(ci - 1) % 4])
                    eb = _edge_id(*fedges[ci])
                    pairs.append((ea, eb))
        else:  # pragma: no cover - impossible by parity
            raise AssertionError("odd number of cut edges on a face")
    return pairs


def _loops_from_pairs(pairs):
    """Chain edge pairings (each cut edge appears in exactly 2 pairs) into
    closed loops of edge ids."""
    adj = {}
    for a, b in pairs:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    for e, ns in adj.items():
        assert len(ns) == 2, f"edge {e} has {len(ns)} connections"
    loops = []
    unvisited = set(adj)
    while unvisited:
        start = min(unvisited)
        loop = [start]
        unvisited.discard(start)
        prev, cur = None, start
        while True:
            n0, n1 = adj[cur]
            nxt = n1 if n0 == prev else n0
            if nxt == start:
                break
            loop.append(nxt)
            unvisited.discard(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


def _edge_point(e: int, inside):
    """Midpoint of edge e (t=0.5 suffices for orientation checks)."""
    a, b = EDGE_ENDPOINTS[e]
    return 0.5 * (CORNER_OFFSETS[a] + CORNER_OFFSETS[b])


def _field_and_grad(p, inside):
    """Trilinear field (+1 outside / -1 inside) and gradient at point p."""
    vals = np.array([1.0 - 2.0 * inside[k] for k in range(8)])  # inside -> -1
    x, y, z = p
    f = 0.0
    g = np.zeros(3)
    for k in range(8):
        ox, oy, oz = CORNER_OFFSETS[k]
        wx = x if ox else (1 - x)
        wy = y if oy else (1 - y)
        wz = z if oz else (1 - z)
        sx = 1.0 if ox else -1.0
        sy = 1.0 if oy else -1.0
        sz = 1.0 if oz else -1.0
        f += vals[k] * wx * wy * wz
        g += vals[k] * np.array([sx * wy * wz, wx * sy * wz, wx * wy * sz])
    return f, g


def _triangulate(config: int):
    inside = [(config >> k) & 1 for k in range(8)]
    pairs = _face_pairings(config)
    if not pairs:
        return []
    loops = _loops_from_pairs(pairs)
    tris = []
    for loop in loops:
        pts = [_edge_point(e, inside) for e in loop]
        for i in range(1, len(loop) - 1):
            tri = [loop[0], loop[i], loop[i + 1]]
            # orient: normal should align with field gradient (toward outside)
            p0, p1, p2 = pts[0], pts[i], pts[i + 1]
            n = np.cross(p1 - p0, p2 - p0)
            centroid = (p0 + p1 + p2) / 3.0
            _, grad = _field_and_grad(centroid, inside)
            if np.dot(n, grad) < 0:
                tri = [tri[0], tri[2], tri[1]]
            tris.append(tri)
    return tris


def _build_tables():
    tri_table = np.full((256, 15), -1, dtype=np.int32)
    tri_count = np.zeros((256,), dtype=np.int32)
    for cfg in range(256):
        tris = _triangulate(cfg)
        assert len(tris) <= 5, f"config {cfg}: {len(tris)} triangles"
        tri_count[cfg] = len(tris)
        flat = [e for t in tris for e in t]
        tri_table[cfg, : len(flat)] = flat
    return tri_table, tri_count


TRI_TABLE, TRI_COUNT = _build_tables()
MAX_TRIS_PER_CELL = int(TRI_COUNT.max())
