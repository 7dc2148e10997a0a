"""Image-space ops: BGRA to RGB and the vertical flip of the sources;
intensity, pyramids and Sobel gradients for odometry; and the
depth-gradient display colors of two-camera fusion.

Edge-clamped shift-add stencils in float32, with the JAX package's operation
order, so results agree exactly (or to the last ulp where a compiler fuses a
multiply-add).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from azurekinect3dreconstruction_tpu_torch.core.fmath import div


def bgra_to_rgb(img):
    """uint8 BGRA (H, W, 4) -> float32 RGB in [0, 1]."""
    img = torch.as_tensor(img)
    return img[..., [2, 1, 0]].to(torch.float32) / 255.0


def flip_ud(img):
    """Vertical flip (the row order reversed)."""
    return torch.flip(torch.as_tensor(img), dims=(0,))


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


def depth_gradient_colors(depth, near: float = 0.5, far: float = 3.0, mode: str = "turbo"):
    """Depth (H, W) -> RGB (H, W, 3) for display: a gray ramp, or a compact
    turbo-like ramp (blue -> cyan -> green -> yellow -> red); invalid depth
    is black in the turbo mode."""
    t = torch.clamp(div(depth - near, far - near), 0.0, 1.0)
    if mode == "gray":
        return torch.stack([1.0 - t] * 3, dim=-1)
    r = torch.clamp(1.5 - torch.abs(4.0 * t - 3.0), 0.0, 1.0)
    g = torch.clamp(1.5 - torch.abs(4.0 * t - 2.0), 0.0, 1.0)
    b = torch.clamp(1.5 - torch.abs(4.0 * t - 1.0), 0.0, 1.0)
    return torch.where((depth > 0)[..., None], torch.stack([r, g, b], dim=-1), 0.0)


def sobel_gradients(img):
    """(dI/du, dI/dv) with Sobel/8 on an edge-clamped image."""
    p = _edge_pad(img, 1, 1)
    sv = p[:-2] + 2.0 * p[1:-1] + p[2:]  # (H, W+2) row-smoothed
    gx = (sv[:, 2:] - sv[:, :-2]) / 8.0
    su = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]  # (H+2, W) col-smoothed
    gy = (su[2:] - su[:-2]) / 8.0
    return gx, gy
