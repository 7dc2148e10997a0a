"""Depth -> color-camera registration: the k4a ``transformed_depth``
(the counterpart of the JAX package's ``ops/depth_to_color.py``).

The depth image is back-projected through the depth camera's ray table,
moved into the color camera by the calibration's extrinsic, projected with
the color intrinsics and z-buffered by a scatter-min (the nearest surface
wins, the SDK's occlusion rule). A minimum does not depend on the order of
the updates, so the result is the same on every device. ``fill_holes``
passes of a 3x3 valid-neighbor minimum close the single-pixel gaps that
forward splatting leaves.
"""

from __future__ import annotations

import torch

from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import CameraCalibration
from azurekinect3dreconstruction_tpu_torch.core.fmath import fma
from azurekinect3dreconstruction_tpu_torch.ops.backproject import backproject_depth

_INF = 1e9


def transformed_depth(depth, rays, calib: CameraCalibration, fill_holes: int = 1,
                      splat: int = 1):
    """(Hd, Wd) depth [m] -> (Hc, Wc) depth [m] seen from the color camera,
    0 where nothing projects.

    ``rays``: the depth camera's ray table (``core.camera.pixel_rays``,
    with its distortion). ``splat`` widens each sample to a splat x splat
    pixel footprint; ``fill_holes`` 3x3 min-fill passes follow."""
    ci = calib.color
    dev = depth.device
    T = torch.as_tensor(calib.color_from_depth, dtype=torch.float32).to(dev)
    flat = backproject_depth(depth, rays).reshape(-1, 3)
    valid = flat[:, 2] > 0
    p = se3.transform_points(T, flat)
    z = p[:, 2]
    zs = torch.clamp_min(z, 1e-6)
    ui = torch.round(fma(p[:, 0] / zs, ci.fx, ci.cx)).to(torch.int64)
    vi = torch.round(fma(p[:, 1] / zs, ci.fy, ci.cy)).to(torch.int64)

    n = ci.height * ci.width
    out = torch.full((n + 1,), _INF, dtype=torch.float32, device=dev)
    for dy in range(splat):
        for dx in range(splat):
            uu, vv = ui + dx, vi + dy
            ok = valid & (z > 0) & (uu >= 0) & (vv >= 0) & (uu < ci.width) & (vv < ci.height)
            out.scatter_reduce_(0, torch.where(ok, vv * ci.width + uu, n),
                                torch.where(ok, z, _INF), "amin")
    img = out[:n].reshape(ci.height, ci.width)
    for _ in range(fill_holes):  # 3x3 valid-neighbor minimum, applied to holes only
        pad = torch.nn.functional.pad(img, (1, 1, 1, 1), value=_INF)
        nmin = torch.stack([pad[i:i + ci.height, j:j + ci.width]
                            for i in range(3) for j in range(3)]).amin(dim=0)
        img = torch.where(img >= _INF, nmin, img)
    return torch.where(img >= _INF, 0.0, img)
