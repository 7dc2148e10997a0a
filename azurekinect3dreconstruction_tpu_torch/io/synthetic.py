"""Synthetic RGB-D scene renderer (analytic ray casting): the hardware-free
frame source of the tests and of ``chip_smoke.py``.

Scenes are unions of spheres, boxes and planes with an albedo; rendering
returns depth along camera z and a lambertian color, and :meth:`capture`
quantizes them to the Azure Kinect raw formats (u16 mm depth, u8 RGB). The
renderer runs on whichever device it is given; the arithmetic follows the
JAX package's renderer op for op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.core import se3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays

_BIG = 1e9


@dataclasses.dataclass(frozen=True)
class Sphere:
    center: Tuple[float, float, float]
    radius: float
    albedo: Tuple[float, float, float] = (0.8, 0.3, 0.2)


@dataclasses.dataclass(frozen=True)
class Plane:
    # point-normal form; visible from the normal side
    point: Tuple[float, float, float]
    normal: Tuple[float, float, float]
    albedo: Tuple[float, float, float] = (0.5, 0.5, 0.55)
    checker: float = 0.0  # if >0, checkerboard albedo with this period (meters)


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box viewed from OUTSIDE (slab-method entry hit)."""

    center: Tuple[float, float, float]
    half_extents: Tuple[float, float, float]
    albedo: Tuple[float, float, float] = (0.7, 0.6, 0.3)


@dataclasses.dataclass(frozen=True)
class Scene:
    spheres: Tuple[Sphere, ...] = ()
    planes: Tuple[Plane, ...] = ()
    boxes: Tuple[Box, ...] = ()

    @staticmethod
    def default() -> "Scene":
        """Spheres on a checkered floor in front of a checkered wall."""
        return Scene(
            spheres=(
                Sphere((0.0, 0.1, 1.2), 0.3, (0.85, 0.25, 0.2)),
                Sphere((-0.45, 0.25, 1.6), 0.2, (0.2, 0.55, 0.85)),
                Sphere((0.5, 0.3, 1.9), 0.25, (0.25, 0.8, 0.3)),
            ),
            planes=(
                Plane((0.0, 0.5, 0.0), (0.0, -1.0, 0.0), (0.6, 0.6, 0.6), checker=0.25),
                Plane((0.0, 0.0, 2.6), (0.0, 0.0, -1.0), (0.75, 0.7, 0.6), checker=0.4),
            ),
        )

    @staticmethod
    def cluttered() -> "Scene":
        """Boxes of distinct sizes among the default props. Their edges and
        corners give geometric features (FPFH) something to describe, where
        every point of a sphere or a plane looks alike: the scene for
        feature-based global registration (the recorder's fallback,
        relocalization, cloud accumulation)."""
        return Scene(
            spheres=(
                Sphere((0.45, 0.28, 1.75), 0.22, (0.25, 0.8, 0.3)),
            ),
            planes=(
                Plane((0.0, 0.5, 0.0), (0.0, -1.0, 0.0), (0.6, 0.6, 0.6), checker=0.25),
                Plane((0.0, 0.0, 2.6), (0.0, 0.0, -1.0), (0.75, 0.7, 0.6), checker=0.4),
            ),
            boxes=(
                Box((-0.05, 0.32, 1.25), (0.22, 0.18, 0.16), (0.85, 0.3, 0.2)),
                Box((-0.5, 0.38, 1.6), (0.1, 0.12, 0.3), (0.2, 0.5, 0.85)),
                Box((0.18, 0.44, 1.05), (0.09, 0.06, 0.07), (0.9, 0.75, 0.25)),
                Box((-0.28, 0.12, 1.85), (0.16, 0.38, 0.1), (0.55, 0.35, 0.75)),
            ),
        )


def _vec(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _intersect_sphere(origin, dirs, sphere: Sphere):
    oc = origin - _vec(sphere.center, dirs)
    b = torch.sum(dirs * oc, dim=-1)
    cc = torch.sum(oc * oc) - sphere.radius ** 2
    disc = b * b - cc * torch.sum(dirs * dirs, dim=-1)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a2 = torch.sum(dirs * dirs, dim=-1)
    t = (-b - sq) / a2
    t2 = (-b + sq) / a2
    t = torch.where(t > 1e-4, t, t2)
    return torch.where((disc > 0.0) & (t > 1e-4), t, _BIG)


def _intersect_box(origin, dirs, box: Box):
    """Slab-method entry intersection; returns (t, normal)."""
    c = _vec(box.center, dirs)
    h = _vec(box.half_extents, dirs)
    safe = torch.where(torch.abs(dirs) > 1e-9, dirs, 1e-9)
    inv = 1.0 / safe
    t0 = (c - h - origin) * inv
    t1 = (c + h - origin) * inv
    tmin = torch.minimum(t0, t1)
    t_near = tmin.amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_near <= t_far) & (t_near > 1e-4)
    onehot = torch.nn.functional.one_hot(tmin.argmax(dim=-1), 3).to(torch.float32)
    sgn = torch.sign(torch.sum(onehot * safe, dim=-1, keepdim=True))
    return torch.where(hit, t_near, _BIG), -sgn * onehot


def _intersect_plane(origin, dirs, plane: Plane):
    n = _vec(plane.normal, dirs)
    p = _vec(plane.point, dirs)
    denom = torch.sum(dirs * n, dim=-1)
    t = torch.sum((p - origin) * n) / torch.where(torch.abs(denom) > 1e-9, denom, 1e-9)
    return torch.where((torch.abs(denom) > 1e-9) & (t > 1e-4), t, _BIG)


def _render(scene: Scene, intr: Intrinsics, T_world_cam, max_depth: float):
    rays = pixel_rays(intr, T_world_cam.device)  # (H, W, 2)
    dirs_cam = torch.cat([rays, torch.ones_like(rays[..., :1])], dim=-1)
    R = T_world_cam[:3, :3]
    origin = T_world_cam[:3, 3]
    dirs = dirs_cam @ R.T  # world-frame ray directions (z-scaled: |dz_cam|=1)

    best_t = torch.full(dirs.shape[:2], _BIG, dtype=torch.float32, device=dirs.device)
    albedo = torch.zeros(dirs.shape[:2] + (3,), dtype=torch.float32, device=dirs.device)
    normal = torch.zeros_like(albedo)

    for s in scene.spheres:
        t = _intersect_sphere(origin, dirs, s)
        hit = t < best_t
        pt = origin + t[..., None] * dirs
        n = (pt - _vec(s.center, dirs)) / s.radius
        best_t = torch.where(hit, t, best_t)
        albedo = torch.where(hit[..., None], _vec(s.albedo, dirs), albedo)
        normal = torch.where(hit[..., None], n, normal)

    for b in scene.boxes:
        t, n = _intersect_box(origin, dirs, b)
        hit = t < best_t
        best_t = torch.where(hit, t, best_t)
        albedo = torch.where(hit[..., None], _vec(b.albedo, dirs), albedo)
        normal = torch.where(hit[..., None], n, normal)

    for p in scene.planes:
        t = _intersect_plane(origin, dirs, p)
        hit = t < best_t
        pt = origin + t[..., None] * dirs
        a = _vec(p.albedo, dirs) * torch.ones_like(albedo)
        if p.checker > 0.0:
            n_np = np.asarray(p.normal, dtype=np.float64)
            u_ax = np.eye(3)[int(np.argmin(np.abs(n_np)))]
            u_ax = u_ax - n_np * (u_ax @ n_np)
            u_ax /= np.linalg.norm(u_ax)
            v_ax = np.cross(n_np, u_ax)
            uu = pt @ _vec(u_ax.tolist(), dirs)
            vv = pt @ _vec(v_ax.tolist(), dirs)
            par = torch.remainder(torch.floor(uu / p.checker) + torch.floor(vv / p.checker), 2.0)
            a = a * (0.55 + 0.45 * par[..., None])
        best_t = torch.where(hit, t, best_t)
        albedo = torch.where(hit[..., None], a, albedo)
        normal = torch.where(hit[..., None], _vec(p.normal, dirs) * torch.ones_like(normal),
                             normal)

    # depth along camera z: dirs has unit camera-z, so z_cam = t
    valid = best_t < max_depth
    z = torch.where(valid, best_t, 0.0)
    # fixed-world-light lambertian shading: view-independent intensity
    light = _vec([0.35, -0.6, -0.72], dirs)
    light = light / torch.linalg.vector_norm(light)
    lam = torch.clamp(torch.abs(torch.sum(normal * light, dim=-1)), 0.0, 1.0)
    color = torch.clamp(albedo * (0.25 + 0.75 * lam[..., None]), 0.0, 1.0)
    return z, torch.where(valid[..., None], color, 0.0)


class SyntheticCamera:
    """Renders the scene from arbitrary poses on ``device``; mimics a k4a
    device's raw output.

    ``depth_noise > 0`` adds relative gaussian depth noise drawn from
    ``generator``, which must then be given (a ``torch.Generator`` on
    ``device``)."""

    def __init__(self, scene: Optional[Scene] = None,
                 intrinsics: Optional[Intrinsics] = None, max_depth: float = 5.0,
                 depth_noise: float = 0.0, generator: Optional[torch.Generator] = None,
                 *, device):
        if depth_noise > 0.0 and generator is None:
            raise ValueError("depth_noise > 0 needs an explicit torch.Generator")
        self.scene = scene or Scene.default()
        self.intrinsics = intrinsics or Intrinsics.azure_kinect_depth_nfov()
        self.max_depth = max_depth
        self.depth_noise = depth_noise
        self.generator = generator
        self.device = torch.device(device)

    def render(self, T_world_cam=None):
        """Float render: (depth_m f32 (H,W), color f32 (H,W,3)) on the device."""
        T = torch.eye(4) if T_world_cam is None else torch.as_tensor(
            np.asarray(T_world_cam, np.float32))
        z, color = _render(self.scene, self.intrinsics,
                           T.to(device=self.device, dtype=torch.float32), self.max_depth)
        if self.depth_noise > 0.0:
            noise = torch.randn(z.shape, generator=self.generator, device=self.device)
            z = torch.where(z > 0, z + self.depth_noise * noise * z, 0.0)
        return z, color

    def capture(self, T_world_cam=None):
        """Raw-format render on the host: (u16 depth in mm, u8 RGB) numpy."""
        z, color = self.render(T_world_cam)
        depth_mm = torch.round(z * 1000.0).cpu().numpy().astype(np.uint16)
        rgb = torch.round(color * 255.0).cpu().numpy().astype(np.uint8)
        return depth_mm, rgb


def orbit_trajectory(n: int, radius: float = 0.4, center=(0.0, 0.1, 1.4),
                     angle_span: float = 0.8, height_wobble: float = 0.05):
    """Camera poses orbiting + looking at ``center`` — a plausible handheld scan.

    Returns a list of 4x4 float64 camera-to-world numpy matrices.
    """
    center = np.asarray(center, dtype=np.float64)
    poses = []
    for i in range(n):
        a = (i / max(n - 1, 1) - 0.5) * angle_span
        eye = center + np.array(
            [radius * np.sin(a), height_wobble * np.sin(2.5 * a) - 0.05,
             -radius * np.cos(a) - 0.9]
        )
        z_axis = center - eye
        z_axis = z_axis / np.linalg.norm(z_axis)
        up = np.array([0.0, -1.0, 0.0])
        x_axis = np.cross(up, z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x_axis, y_axis, z_axis, eye
        poses.append(T)
    return poses


def small_motion(i: int, scale: float = 1.0):
    """A small SE(3) perturbation for frame-to-frame odometry tests: a
    twist drawn uniformly in +-0.01 * ``scale`` (m and rad) from
    ``RandomState(100 + i)``, as the JAX package's ``small_motion`` draws
    it; a 4x4 float32 numpy matrix."""
    rng = np.random.RandomState(100 + i)
    xi = np.concatenate([rng.uniform(-0.01, 0.01, 3) * scale,
                         rng.uniform(-0.01, 0.01, 3) * scale])
    return se3.se3_exp(torch.as_tensor(xi, dtype=torch.float32)).numpy()
