"""Image-space ops for odometry: intensity, pyramids, Sobel gradients.

Edge-clamped shift-add stencils in float32, with the JAX package's operation
order, so results agree exactly (or to the last ulp where a compiler fuses a
multiply-add).
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def rgb_to_intensity(rgb):
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _edge_pad(img, ph: int, pw: int):
    """Replicate-pad a 2-D tensor by ``ph`` rows and ``pw`` columns each side."""
    h, w = img.shape
    rows = torch.clamp(torch.arange(-ph, h + ph, device=img.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-pw, w + pw, device=img.device), 0, w - 1)
    return img[rows][:, cols]


def _gauss_blur(img):
    """Separable 5-tap binomial blur (1 4 6 4 1)/16, edge-clamped."""
    x = _edge_pad(img, 2, 0)
    x = ((x[:-4] + x[4:]) + 4.0 * (x[1:-3] + x[3:-1]) + 6.0 * x[2:-2]) / 16.0
    x = _edge_pad(x, 0, 2)
    return ((x[:, :-4] + x[:, 4:]) + 4.0 * (x[:, 1:-3] + x[:, 3:-1])
            + 6.0 * x[:, 2:-2]) / 16.0


def downsample2(img):
    """Blur + 2x decimation (intensity images)."""
    return _gauss_blur(img)[::2, ::2].contiguous()


def downsample2_depth(depth):
    """Depth-aware 2x decimation: plain subsampling (no blending across
    depth discontinuities — blurring depth invents phantom surfaces)."""
    return depth[::2, ::2].contiguous()


def build_pyramid(intensity, depth, levels: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(intensity, depth)] from finest (level 0) to coarsest."""
    out = [(intensity, depth)]
    for _ in range(levels - 1):
        intensity = downsample2(intensity)
        depth = downsample2_depth(depth)
        out.append((intensity, depth))
    return out


def sobel_gradients(img):
    """(dI/du, dI/dv) with Sobel/8 on an edge-clamped image."""
    p = _edge_pad(img, 1, 1)
    sv = p[:-2] + 2.0 * p[1:-1] + p[2:]  # (H, W+2) row-smoothed
    gx = (sv[:, 2:] - sv[:, :-2]) / 8.0
    su = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]  # (H+2, W) col-smoothed
    gy = (su[2:] - su[:-2]) / 8.0
    return gx, gy
