"""Marching cubes over the block-hashed TSDF volume, in plain PyTorch.

The counterpart of the JAX package's ``tsdf/marching_cubes.py``: the same
triangles, in the same order, with the same budgets, thinning strides and
overflow flags. No TPU kernel sits on this path (the JAX version is plain
jnp), so neither does a CUDA one here. Three steps:

1. **survey** — for each block row, an ``(R+1)^3`` padded cube of every
   corner field (validity, tsdf value, quantized color) assembled from the
   row and the boundary planes of its 7 ``(0/1)^3`` neighbor blocks. A
   cell's 8-bit case reads its 8 corners from the cube; invalid, empty and
   full cells fold to case 0 (inert).
2. **group selection** — cells group into 64-cell runs that are contiguous
   in the flat z-minor ``(cap, R^3)`` layout (cell ``x*R^2 + y*R + z``).
   The active groups keep row order (pool order on the mesh path, block-key
   order in the sampled model's compact rows); the mesh path takes the
   first ``max_cells // 64``, the sampler every stride-th.
3. **count -> exclusive scan -> emit** — per selected cell, ``TRI_COUNT``;
   the scan gives each cell's first triangle; output triangle ``j`` (global
   triangle ``j * stride``) finds its cell by a sorted search of the
   inclusive scan and reads its edges from ``TRI_TABLE`` in table order.

The output is a triangle soup, vertex-major ``(vertex, xyz, triangle)`` as
in the JAX package; :func:`extract_mesh` reorders it on the host, and
:func:`weld_vertices` shares vertices when an indexed mesh is needed.

Rounding: corner colors are quantized to ``round(c * 255)`` before they
are interpolated, and a vertex color is ``fma(frac, cb - ca, ca) * (1/255)``
with ``1/255`` the float32 reciprocal: what the JAX package's compiled stage
computes on the CPU (it contracts the multiply-add and turns the division by
the constant 255 into a multiply; see ``core.fmath``). A vertex coordinate
``(cell + 0.5 + a + frac * (b - a)) * voxel`` has an exact product (``b - a``
is -1, 0 or 1), so it rounds the same either way. Vertices and colors agree
with the JAX package to the bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.config import TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.fmath import fma, rcp32
from azurekinect3dreconstruction_tpu_torch.core.types import TriangleMesh, TriangleMeshHost
from azurekinect3dreconstruction_tpu_torch.tsdf import hash as vhash
from azurekinect3dreconstruction_tpu_torch.tsdf import mc_tables as mt
from azurekinect3dreconstruction_tpu_torch.tsdf.volume import TSDFVolume

EXTRACT_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
GROUP = 64  # cells per group (contiguous in the flat z-minor block layout)


def pow2_bucket(n: int, cap: int = 0, lo: int = 64) -> int:
    """Round ``n`` up a power-of-two ladder starting at ``lo``, clamped to
    ``cap`` when given."""
    b = lo
    while b < n:
        b *= 2
    return min(b, cap) if cap else b


def snap_extract_blocks(n_alive: int, pool_size: int) -> int:
    """Alive-prefix length snapped to the EXTRACT_SIZES ladder, clamped to
    the pool."""
    E = next((e for e in EXTRACT_SIZES if e >= n_alive), pool_size)
    return min(E, pool_size)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(TRI_TABLE (256, 15), TRI_COUNT (256,), EDGE_ENDPOINTS (12, 2),
    CORNER_OFFSETS (8, 3)) as int64 tensors on ``device``."""
    return tuple(torch.from_numpy(np.asarray(a, np.int64)).to(device)
                 for a in (mt.TRI_TABLE, mt.TRI_COUNT, mt.EDGE_ENDPOINTS, mt.CORNER_OFFSETS))


def _neighbor_slots(vol: TSDFVolume, block_coords):
    """(E, 8) pool slots of the 8 (0/1)^3 neighbor blocks (self = code 0)."""
    corners = _tables(block_coords.device)[3].to(torch.int32)
    keys = vhash.pack_key(block_coords[:, None, :] + corners[None])
    return vhash.lookup(vol.table, keys)


def _padded(local, nbr, fill):
    """(E, R, R, R) per-row field -> (E, R+1, R+1, R+1): the row's own
    values, then on each + face, edge and corner the boundary plane of the
    neighbor row ``nbr[:, code]`` (``fill`` where it is absent, -1)."""
    E, R = local.shape[0], local.shape[1]
    out = local.new_full((E, R + 1, R + 1, R + 1), fill)
    out[:, :R, :R, :R] = local
    for code in range(1, 8):
        off = mt.CORNER_OFFSETS[code]
        dst = tuple(slice(R, R + 1) if o else slice(0, R) for o in off)
        src = tuple(slice(0, 1) if o else slice(0, R) for o in off)
        s = nbr[:, code]
        plane = local[(slice(None),) + src][torch.clamp_min(s, 0).long()]
        out[(slice(None),) + dst] = torch.where((s >= 0)[:, None, None, None], plane, fill)
    return out


class _Survey(NamedTuple):
    case: torch.Tensor  # (E, R^3) int64 MC case per cell, 0 = inert
    tpad: torch.Tensor  # (E, R+1, R+1, R+1) f32 corner tsdf values
    cpad: Optional[torch.Tensor]  # (E, R+1, R+1, R+1) int32 packed u8 corner RGB
    coords: torch.Tensor  # (E, 3) int32 block coords of the rows


def _survey(vol: TSDFVolume, cfg: TSDFConfig, extract_blocks: Optional[int] = None,
            emit_mask=None, sel=None, nbr_sel=None, colors: bool = True) -> _Survey:
    """Stage 1. Prefix form: rows are pool slots ``[0, E)`` and neighbors
    come from the hash (absent beyond the prefix). Compact form: rows are
    the pool slots ``sel`` (-1 = padding) and ``nbr_sel`` (E, 8) names each
    row's neighbors as compact row indices (-1 = absent). ``emit_mask``
    (per row) keeps corner values of every row but lets only masked rows
    emit."""
    R = cfg.block_resolution
    N = vol.tsdf.shape[0]
    dev = vol.tsdf.device
    if sel is not None:
        E = sel.shape[0]
        alive = sel >= 0
        slot = torch.where(alive, sel, 0).long()
        t, w, c = vol.tsdf[slot], vol.weight[slot], vol.color[slot]
        coords = vol.block_coords[slot]
        nbr = nbr_sel
    else:
        E = min(extract_blocks or N, N)
        t, w, c = vol.tsdf[:E], vol.weight[:E], vol.color[:E]
        coords = vol.block_coords[:E]
        alive = torch.arange(E, device=dev) < vol.n_blocks
        nbr = _neighbor_slots(vol, coords)
        # neighbors beyond the prefix count as absent
        nbr = torch.where(nbr < E, nbr, -1)
    nbr = torch.where(alive[:, None], nbr, -1)
    shape = (E, R, R, R)
    vpad = _padded(((w > 0.0) & alive[:, None]).view(shape), nbr, False)
    tpad = _padded(t.reshape(shape), nbr, 0.0)
    cpad = None
    if colors:
        q = torch.round(c * 255.0).to(torch.int32)  # (E, 3, R^3), each in [0, 255]
        cpad = _padded(((q[:, 0] << 16) | (q[:, 1] << 8) | q[:, 2]).view(shape), nbr, 0)
    inside = (tpad < 0.0) & vpad
    case = torch.zeros(shape, dtype=torch.int64, device=dev)
    all_valid = torch.ones(shape, dtype=torch.bool, device=dev)
    for k, (dx, dy, dz) in enumerate(mt.CORNER_OFFSETS):
        view = (slice(None), slice(dx, dx + R), slice(dy, dy + R), slice(dz, dz + R))
        case |= inside[view].to(torch.int64) << k
        all_valid &= vpad[view]
    # mixed corner signs <=> triangles: every case but 0 and 255
    case = torch.where(all_valid & (case != 255), case, 0).reshape(E, R ** 3)
    if emit_mask is not None:
        case = torch.where(emit_mask[:E, None], case, 0)
    return _Survey(case, tpad, cpad, coords)


def _active_groups(case):
    """(E, R^3) cases -> (E * R^3 / 64,) bool: groups with a geometry cell."""
    return (case.view(-1, min(GROUP, case.shape[1])) != 0).any(dim=1)


def _select_groups(case, max_bricks: int, subsample: bool):
    """Stage 2: the group worklist (max_bricks,) of flat group ids in pool
    order (-1 = empty) and the group overflow flag.

    ``subsample``: when the active groups exceed the budget, keep every
    stride-th (stride a device scalar) instead of the first ``max_bricks``,
    so the sample thins uniformly and groups never overflow."""
    active = _active_groups(case)
    G = active.shape[0]
    border = torch.cumsum(active.to(torch.int64), 0) - 1
    n_bricks = border[-1] + 1
    if subsample:
        bstride = torch.clamp_min((n_bricks + max_bricks - 1) // max_bricks, 1)
        pick = active & (border % bstride == 0)
        pos = torch.cumsum(pick.to(torch.int64), 0) - 1
        dst = torch.where(pick & (pos < max_bricks), pos, max_bricks)
        overflow = torch.zeros((), dtype=torch.bool, device=case.device)
    else:
        dst = torch.where(active & (border < max_bricks), border, max_bricks)
        overflow = n_bricks > max_bricks
    wl = torch.full((max_bricks + 1,), -1, dtype=torch.int64, device=case.device)
    wl.scatter_(0, dst, torch.arange(G, device=case.device))  # row max_bricks: the drop
    return wl[:max_bricks], overflow


def _emit(sv: _Survey, cfg: TSDFConfig, max_cells: int, max_tris: int,
          subsample: bool = False, return_cells: bool = False):
    """Stage 3. Returns (vertices (3, 3, max_tris), colors (same, or None
    without ``sv.cpad``), num_tris, overflow); slots past ``num_tris`` are
    zero. ``return_cells`` appends each triangle's integer global cell
    coordinates, (3, max_tris) int32, -9999 past ``num_tris``.

    ``subsample`` (the sampler): groups thin by stride (see
    :func:`_select_groups`) and output slot ``j`` holds global triangle
    ``j * s`` with ``s = ceil(total / max_tris)``, so a triangle budget
    thins uniformly instead of truncating in pool order."""
    R = cfg.block_resolution
    C3 = R ** 3
    B3 = min(GROUP, C3)
    dev = sv.case.device
    tri_table, tri_count, edges, _ = _tables(dev)
    max_bricks = max(max_cells // B3, 1)
    wl, overflow1 = _select_groups(sv.case, max_bricks, subsample)
    live = wl >= 0
    cell = (torch.where(live, wl, 0)[:, None] * B3
            + torch.arange(B3, device=dev)[None]).reshape(-1)  # flat (E*R^3) cell ids
    case = torch.where(live[:, None].expand(-1, B3).reshape(-1), sv.case.view(-1)[cell], 0)
    ntri = tri_count[case]
    offs_inc = torch.cumsum(ntri, 0)
    total = offs_inc[-1]
    if subsample:
        s = torch.clamp_min((total + max_tris - 1) // max_tris, 1)
    else:
        s = torch.ones((), dtype=torch.int64, device=dev)
    g = torch.arange(max_tris, device=dev) * s  # global index of each output slot
    c_t = torch.clamp_max(torch.searchsorted(offs_inc, g, right=True), cell.shape[0] - 1)
    k_t = g - (offs_inc - ntri)[c_t]  # triangle index within its cell
    num_tris = torch.clamp_max((total + s - 1) // s, max_tris)
    overflow = (total > max_tris * s) | overflow1
    tmask = g < total

    cid = cell[c_t]
    row, lin = cid // C3, cid % C3
    xyz = torch.stack([lin // (R * R), (lin // R) % R, lin % R])  # (3, T) in-block cell
    cell_i = sv.coords[row].T.to(torch.int64) * R + xyz
    cell_f = cell_i.to(torch.float32)
    case_t = case[c_t]
    R1 = R + 1
    base = row * R1 ** 3 + xyz[0] * R1 * R1 + xyz[1] * R1 + xyz[2]
    tflat = sv.tpad.reshape(-1)
    cflat = None if sv.cpad is None else sv.cpad.reshape(-1)

    def corner(c):
        """(3, T) unit offset of corner id c and its flat padded index."""
        o = torch.stack([c & 1, (c >> 1) & 1, (c >> 2) & 1])
        return o, base + o[0] * R1 * R1 + o[1] * R1 + o[2]

    inv255 = rcp32(255.0)
    verts, cols = [], []
    for v in range(3):
        ev = torch.clamp(tri_table[case_t, torch.clamp(3 * k_t + v, 0, 14)], 0, 11)
        oa, ia = corner(edges[ev, 0])
        ob, ib = corner(edges[ev, 1])
        va, vb = tflat[ia], tflat[ib]
        denom = va - vb
        frac = torch.clamp(va / torch.where(denom.abs() > 1e-12, denom, 1e-12), 0.0, 1.0)
        p = cell_f + 0.5 + oa.to(torch.float32) + frac * (ob - oa).to(torch.float32)
        verts.append(torch.where(tmask, p * cfg.voxel_size, 0.0))
        if cflat is not None:
            pa, pb = cflat[ia], cflat[ib]
            ch = lambda p, sh: ((p >> sh) & 255).to(torch.float32)
            col = torch.stack([fma(frac, ch(pb, sh) - ch(pa, sh), ch(pa, sh))
                               for sh in (16, 8, 0)])
            cols.append(torch.where(tmask, col * inv255, 0.0))
    out = (torch.stack(verts), torch.stack(cols) if cols else None,
           num_tris.to(torch.int32), overflow)
    if return_cells:
        out += (torch.where(tmask, cell_i, -9999).to(torch.int32),)
    return out


def extract_mesh_arrays(vol: TSDFVolume, cfg: TSDFConfig, max_cells: int = 65536,
                        max_tris: int = 131072, extract_blocks: Optional[int] = None,
                        emit_mask=None, sel=None, nbr_sel=None,
                        subsample_bricks: bool = False, return_cells: bool = False):
    """Device-side extraction. Returns (vertices (3, 3, max_tris), colors,
    num_tris, overflow) — all tensors on the volume's device, nothing waits
    on the host. ``extract_blocks`` bounds the alive prefix scanned;
    ``max_cells`` budgets the cells of the group worklist (``max_cells //
    64`` groups); ``emit_mask`` / ``sel`` / ``nbr_sel``: see
    :func:`_survey`; ``subsample_bricks`` / ``return_cells``: see
    :func:`_emit`."""
    sv = _survey(vol, cfg, extract_blocks, emit_mask, sel, nbr_sel)
    return _emit(sv, cfg, max_cells, max_tris, subsample_bricks, return_cells)


def exact_budgets(sv: _Survey, cfg: TSDFConfig, max_cells: int = 0, max_tris: int = 1):
    """(max_cells, max_tris) that hold every active group and triangle of a
    survey: its exact counts, read from the device in one transfer, raised
    to the floors given. An emission at these budgets cannot overflow."""
    n_groups, n_tris = torch.stack([_active_groups(sv.case).sum(),
                                    _tables(sv.case.device)[1][sv.case].sum()]).tolist()
    return (max(max_cells, n_groups * min(GROUP, cfg.block_resolution ** 3)),
            max(max_tris, n_tris))


def extract_mesh(vol: TSDFVolume, cfg: TSDFConfig, max_cells: int = 65536,
                 max_tris: int = 131072, auto_grow: bool = True) -> TriangleMesh:
    """Extract a triangle-soup mesh into host arrays.

    With ``auto_grow`` the budgets grow to fit the mesh — the JAX package
    doubles them and extracts again until nothing overflows; here they are
    sized from exact counts (active groups, triangles) read from the device
    once, so the emission runs once and holds no padding. Without it, a
    budget too small truncates in emission order and sets ``overflow``.
    Either way the soup holds the live triangles only, which
    :meth:`TriangleMesh.compact` hands over as they are."""
    N = vol.tsdf.shape[0]
    E = snap_extract_blocks(int(vol.n_blocks), N)
    sv = _survey(vol, cfg, extract_blocks=E)
    if auto_grow:
        max_cells, max_tris = exact_budgets(sv, cfg, max_cells)
    verts_t, vcols_t, num_tris, overflow = _emit(sv, cfg, max_cells, max_tris)
    nt = int(num_tris)

    def soup(a):
        """(vertex, xyz, tri) -> (tri, vertex, xyz) -> (3 nt, 3), on the host."""
        return a[:, :, :nt].permute(2, 0, 1).reshape(-1, 3).cpu().numpy()

    return TriangleMesh(
        vertices=soup(verts_t),
        triangles=np.arange(nt * 3, dtype=np.int32).reshape(-1, 3),
        num_vertices=np.int32(nt * 3),
        num_triangles=np.int32(nt),
        vertex_colors=soup(vcols_t),
        overflow=bool(overflow),
    )


def build_compact_selection(find, n_live: int, sel_slots, emit_slots, coords, Es: int, *,
                            pack):
    """Host numpy arguments for the compact form of :func:`extract_mesh_arrays`.

    ``find`` maps packed keys to pool slots (-1 where absent), and ``pack``
    is the key packing its index was built with; ``sel_slots``: the unique
    pool slots to select (the emitting blocks and their alive positive-corner
    neighbors, which supply corner values); ``emit_slots``: the subset that
    emits triangles; ``coords``: (n_live, 3) alive block coords; ``Es``: the
    selection's padded length. Returns (sel (Es,), nbr_sel (Es, 8), emit
    (Es,)), -1 / False in the padding."""
    ns = len(sel_slots)
    pool2c = np.full(n_live, -1, np.int32)
    pool2c[sel_slots] = np.arange(ns, dtype=np.int32)
    corners = np.asarray(mt.CORNER_OFFSETS)
    nsl = find(pack(coords[sel_slots][:, None, :] + corners[None]).reshape(-1))
    nbr_c = np.where(nsl >= 0, pool2c[np.maximum(nsl, 0)], -1).reshape(ns, 8).astype(np.int32)
    sel = np.full(Es, -1, np.int32)
    sel[:ns] = sel_slots
    nbr_pad = np.full((Es, 8), -1, np.int32)
    nbr_pad[:ns] = nbr_c
    emit = np.zeros(Es, bool)
    emit[:ns] = np.isin(sel_slots, emit_slots, assume_unique=True)
    return sel, nbr_pad, emit


def weld_vertices(mesh: TriangleMeshHost, decimals: int = 6) -> TriangleMeshHost:
    """Host-side vertex welding: triangle soup -> indexed mesh."""
    keys = np.round(mesh.vertices, decimals)
    _, index, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    tris = inverse.reshape(-1)[mesh.triangles]
    return TriangleMeshHost(
        vertices=mesh.vertices[index],
        triangles=tris.astype(np.int32),
        vertex_colors=None if mesh.vertex_colors is None else mesh.vertex_colors[index],
    )


def count_active_bricks(vol: TSDFVolume, cfg: TSDFConfig, extract_blocks: int):
    """Number of 64-cell groups the mesh path would compact (a device
    scalar): callers fit ``max_cells`` to the scene with it."""
    return _active_groups(_survey(vol, cfg, extract_blocks, colors=False).case).sum()


# ---------------------------------------------------------------------------
# surface samplers (the frame-to-model tracking model)
# ---------------------------------------------------------------------------


def _stride_pick(v, n_tris, mtris: int):
    """(3, 3, 4*mtris) vertex planes -> every stride-th triangle, stride in
    {1, 2, 4} by the emission size: ((3*mtris, 3) points, kept mask)."""
    nt = n_tris.to(torch.int64)
    stride = torch.where(nt <= mtris, 1, torch.where(nt <= 2 * mtris, 2, 4))
    idx = torch.clamp_max(torch.arange(mtris, device=v.device) * stride, v.shape[2] - 1)
    pts = v[:, :, idx].permute(2, 0, 1).reshape(-1, 3)
    n_keep = torch.clamp_max((nt + stride - 1) // stride, mtris)
    return pts, torch.arange(3 * mtris, device=v.device) < 3 * n_keep


def extract_surface_samples(vol: TSDFVolume, cfg: TSDFConfig, n_points: int,
                            max_cells: int = 64 * 8192, return_colors: bool = False):
    """Budget-bounded surface point samples: marching-cubes vertices
    extracted at 4x the budget and stride-subsampled by the emission size.
    Returns (points (3*(n_points//3), 3), mask, overflow), the last a device
    flag; ``return_colors`` appends the vertices' colors (same shape as the
    points). Reads the block count from the device once."""
    E = snap_extract_blocks(int(vol.n_blocks), vol.tsdf.shape[0])
    return extract_surface_samples_device(vol, cfg, n_points, E, max_cells,
                                          return_colors=return_colors)


def extract_surface_samples_device(vol: TSDFVolume, cfg: TSDFConfig, n_points: int,
                                   extract_blocks: int, max_cells: int = 64 * 8192,
                                   emit_mask=None, return_colors: bool = False):
    """:func:`extract_surface_samples` with the extraction prefix given by
    the caller: nothing waits on the host."""
    mtris = max(n_points // 3, 1)
    sv = _survey(vol, cfg, extract_blocks, emit_mask, colors=return_colors)
    v, c, n_tris, ovf = _emit(sv, cfg, max_cells, 4 * mtris)
    pts, mask = _stride_pick(v, n_tris, mtris)
    if return_colors:
        return pts, mask, ovf, _stride_pick(c, n_tris, mtris)[0]
    return pts, mask, ovf


def sample_block_selection(vol: TSDFVolume, T_world_cam, reach, block_size: float,
                           B: int, S: int):
    """View-local block sample in the compact form :func:`_survey` takes:
    a stride-pick of up to ``B`` alive blocks whose centers lie within
    ``reach`` of the camera (emitting rows), then up to ``S`` of their alive
    +corner neighbors that were not picked (corner-value suppliers). Both
    are ranked and emitted in block-key order (``hash.pack_key``), never in
    slot order: a pool that holds the same blocks in other slots (a
    compacted or reloaded stream) gives the same rows, so the same model.
    Fixed shapes, one sort over the pool's rows and a device-side stride:
    nothing waits on the host. Returns (sel (B+S,), nbr_sel (B+S, 8), emit
    (B+S,), supplier overflow flag)."""
    dev = vol.block_coords.device
    cap = vol.block_coords.shape[0]
    alive = torch.arange(cap, device=dev) < vol.n_blocks
    centers = (vol.block_coords.to(torch.float32) + 0.5) * np.float32(block_size).item()
    d = torch.linalg.vector_norm(centers - T_world_cam[:3, 3].to(torch.float32), dim=1)
    near = alive & (d <= reach)
    # the alive slots in key order, the dead ones after them (packed keys
    # are below 2^30)
    key = torch.where(alive, vhash.pack_key(vol.block_coords), torch.iinfo(torch.int32).max)
    order = torch.sort(key, stable=True).indices
    near_o = near[order]
    cnt = near_o.to(torch.int64).sum()
    stride = torch.clamp_min((cnt + B - 1) // B, 1)
    rank = torch.cumsum(near_o.to(torch.int64), 0) - 1
    pick = near_o & (rank % stride == 0)
    pos = torch.cumsum(pick.to(torch.int64), 0) - 1
    dst = torch.where(pick & (pos < B), pos, B)
    selB = torch.full((B + 1,), -1, dtype=torch.int64, device=dev).scatter_(0, dst, order)[:B]
    live = selB >= 0
    slot = torch.where(live, selB, 0)
    nbr_pool = _neighbor_slots(vol, vol.block_coords[slot]).to(torch.int64)  # (B, 8)
    nbr_ok = (nbr_pool >= 0) & live[:, None]
    picked = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    picked[torch.where(live, selB, cap)] = True
    sup = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
    sup[torch.where(nbr_ok[:, 1:], nbr_pool[:, 1:], cap).reshape(-1)] = True
    sup_o = (sup[:cap] & ~picked[:cap])[order]
    n_sup = sup_o.to(torch.int64).sum()
    spos = torch.cumsum(sup_o.to(torch.int64), 0) - 1
    sdst = torch.where(sup_o & (spos < S), spos, S)
    selS = torch.full((S + 1,), -1, dtype=torch.int64, device=dev).scatter_(0, sdst, order)[:S]
    sel = torch.cat([selB, selS])
    # pool slot -> compact row (-1 where not selected); dead rows write [cap]
    pool2c = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    pool2c[torch.where(sel >= 0, sel, cap)] = torch.arange(B + S, device=dev)
    nbrB = torch.where(nbr_ok, pool2c[torch.clamp(nbr_pool, 0, cap)], -1)
    nbr_sel = torch.cat([nbrB, torch.full((S, 8), -1, dtype=torch.int64, device=dev)])
    emit = torch.cat([live, torch.zeros((S,), dtype=torch.bool, device=dev)])
    return sel, nbr_sel, emit, n_sup > S


def extract_sampled_surface_model(vol: TSDFVolume, cfg: TSDFConfig, n_points: int,
                                  T_world_cam, reach: float, sample_blocks: int = 256,
                                  bricks_per_block: int = 8,
                                  supplier_rows: Optional[int] = None,
                                  return_colors: bool = False):
    """The frame-to-model tracking model: a surface sample whose cost scales
    with the sample, not the scene, and that waits on nothing. Stride-pick
    ``sample_blocks`` near blocks (:func:`sample_block_selection`), extract
    only their cells with a ``sample_blocks * bricks_per_block`` group
    budget (group stride on overflow), and stride the triangles down to
    ``n_points // 3``. Returns (points (3*(n_points//3), 3), mask,
    overflow), the flag set when the supplier rows (default 3 per sampled
    block) overflowed; ``return_colors`` appends the vertices' colors. The
    blocks, groups and triangles are all thinned in block-key order, so the
    model depends on the pool's blocks, not on their slots."""
    S = 3 * sample_blocks if supplier_rows is None else supplier_rows
    mtris = max(n_points // 3, 1)
    sel, nbr_sel, emit, sel_ovf = sample_block_selection(
        vol, T_world_cam, reach, cfg.block_size, sample_blocks, S)
    sv = _survey(vol, cfg, emit_mask=emit, sel=sel, nbr_sel=nbr_sel, colors=return_colors)
    v, c, n_tris, ovf = _emit(sv, cfg, sample_blocks * bricks_per_block * GROUP, mtris,
                              subsample=True)
    pts = v.permute(2, 0, 1).reshape(-1, 3)
    mask = torch.arange(3 * mtris, device=pts.device) < 3 * n_tris.to(torch.int64)
    if return_colors:
        return pts, mask, ovf | sel_ovf, c.permute(2, 0, 1).reshape(-1, 3)
    return pts, mask, ovf | sel_ovf
