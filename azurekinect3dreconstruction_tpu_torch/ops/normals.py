"""Normals of an organized point map (the counterpart of the JAX package's
``ops/normals.organized_normals``)."""

from __future__ import annotations

import torch


def organized_normals(points, max_edge: float = 0.1):
    """(H, W, 3) organized camera-space points -> (H, W, 3) unit normals
    oriented toward the camera.

    Central differences of the 4-neighborhood (``roll``, which wraps); a
    normal is zero where a neighbor is invalid, a stencil edge is longer
    than ``max_edge`` (a depth discontinuity) or the cross product
    vanishes, and on the one-pixel image border."""
    p = points
    valid = p[..., 2] > 0
    du = torch.roll(p, -1, dims=1) - torch.roll(p, 1, dims=1)
    dv = torch.roll(p, -1, dims=0) - torch.roll(p, 1, dims=0)
    n = torch.linalg.cross(du, dv)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp_min(norm, 1e-12)
    ok = (valid & torch.roll(valid, -1, dims=1) & torch.roll(valid, 1, dims=1)
          & torch.roll(valid, -1, dims=0) & torch.roll(valid, 1, dims=0)
          & (torch.linalg.vector_norm(du, dim=-1) < max_edge)
          & (torch.linalg.vector_norm(dv, dim=-1) < max_edge)
          & (norm[..., 0] > 1e-12))
    flip = (n * p).sum(dim=-1) > 0
    n = torch.where(flip[..., None], -n, n)
    n = torch.where(ok[..., None], n, 0.0)
    n[0], n[-1], n[:, 0], n[:, -1] = 0.0, 0.0, 0.0, 0.0
    return n
