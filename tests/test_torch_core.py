"""The port's core and frame ops against the JAX package: SE(3), ray table,
raw decode, pyramid and Sobel stencils, spatial hash, synthetic renderer,
config JSON, trajectory metrics, device selection, and a jax-free import."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu import config as jcfg
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
from azurekinect3dreconstruction_tpu.core.camera import pixel_rays as jpixel_rays
from azurekinect3dreconstruction_tpu.core.types import RGBDFrame as JRGBDFrame
from azurekinect3dreconstruction_tpu.io.synthetic import Scene as JScene
from azurekinect3dreconstruction_tpu.io.synthetic import SyntheticCamera as JCamera
from azurekinect3dreconstruction_tpu.io.synthetic import orbit_trajectory as jorbit
from azurekinect3dreconstruction_tpu.ops import image as jimage
from azurekinect3dreconstruction_tpu.pipelines.mono_odometry_tsdf import (
    decode_raw_frame as jdecode,
)
from azurekinect3dreconstruction_tpu.tsdf import hash as jhash
from azurekinect3dreconstruction_tpu.utils import evaluation as jeval
from azurekinect3dreconstruction_tpu_torch import config as tcfg
from azurekinect3dreconstruction_tpu_torch import interop
from azurekinect3dreconstruction_tpu_torch.core import se3 as tse3
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics, pixel_rays
from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.core.types import RGBDFrame, decode_raw_frame
from azurekinect3dreconstruction_tpu_torch.io.synthetic import (
    Scene,
    SyntheticCamera,
    orbit_trajectory,
)
from azurekinect3dreconstruction_tpu_torch.ops import image as timage
from azurekinect3dreconstruction_tpu_torch.tsdf import hash as thash
from azurekinect3dreconstruction_tpu_torch.utils import evaluation as teval

torch.set_num_threads(1)

INTR = Intrinsics.azure_kinect_depth_nfov().scaled(0.25)  # conftest's quarter-res camera
JINTR = JIntrinsics.azure_kinect_depth_nfov().scaled(0.25)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def raw_frame():
    d, c = JCamera(intrinsics=JINTR).capture(jorbit(3, radius=0.2, angle_span=0.3)[2])
    return d, c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_se3_matches_jax(seed):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([rng.uniform(-0.3, 0.3, 3), rng.uniform(-1.0, 1.0, 3)]).astype(np.float32)
    if seed == 2:
        xi[3:] *= 1e-4  # series branch of exp/log
    T_j = _n(jse3.se3_exp(jnp.asarray(xi)))
    T_t = tse3.se3_exp(_t(xi))
    np.testing.assert_allclose(T_t.numpy(), T_j, atol=1e-6)
    np.testing.assert_allclose(tse3.se3_log(_t(T_j)).numpy(), _n(jse3.se3_log(T_j)), atol=1e-5)
    # XLA contracts the 3x3 product differently: 1 ulp
    np.testing.assert_allclose(tse3.inverse(_t(T_j)).numpy(), _n(jse3.inverse(T_j)), atol=1e-7)
    T2 = _n(jse3.se3_exp(jnp.asarray(xi[::-1].copy())))
    np.testing.assert_allclose(tse3.compose_renormalized(_t(T_j), _t(T2)).numpy(),
                               _n(jse3.compose_renormalized(T_j, T2)), atol=1e-6)
    pts = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tse3.transform_points(_t(T_j), _t(pts)).numpy(),
                               _n(jse3.transform_points(T_j, pts)), atol=1e-6)


def test_intrinsics_and_pixel_rays_match_jax():
    full = Intrinsics.azure_kinect_depth_nfov()
    assert dataclasses.asdict(full.scaled(0.25)) == dataclasses.asdict(JINTR)
    assert hash(INTR) == hash(INTR.scaled(1.0))
    assert interop.intrinsics_from(JINTR) == INTR
    np.testing.assert_array_equal(pixel_rays(INTR, "cpu").numpy(), _n(jpixel_rays(JINTR)))


def test_decode_raw_frame_matches_jax_bitwise(raw_frame):
    d_raw, c_raw = raw_frame
    args = (1.0 / 1000.0, 0.1, 3.0)
    d_j, c_j, i_j = (_n(x) for x in jdecode(d_raw, c_raw, *args))
    d_t, c_t, i_t = decode_raw_frame(_t(d_raw), _t(c_raw), *args)
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    f_j = JRGBDFrame.from_raw(d_raw, c_raw)
    f_t = RGBDFrame.from_raw(_t(d_raw), _t(c_raw))
    for a, b in ((f_t.depth, f_j.depth), (f_t.color, f_j.color),
                 (f_t.intensity, f_j.intensity)):
        np.testing.assert_array_equal(a.numpy(), _n(b))


def test_pyramid_and_sobel_match_jax(raw_frame):
    d_raw, c_raw = raw_frame
    _, _, inten = jdecode(d_raw, c_raw, 1e-3, 0.1, 3.0)
    depth = _n(jdecode(d_raw, c_raw, 1e-3, 0.1, 3.0)[0])
    pj = jimage.build_pyramid(inten, jnp.asarray(depth), 3)
    pt = timage.build_pyramid(_t(inten), _t(depth), 3)
    for (ij, dj), (it, dt) in zip(pj, pt):
        np.testing.assert_allclose(it.numpy(), _n(ij), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(dt.numpy(), _n(dj))
        for gj, gt in zip(jimage.sobel_gradients(ij), timage.sobel_gradients(it)):
            np.testing.assert_allclose(gt.numpy(), _n(gj), atol=1e-6, rtol=0)
    rgb = np.random.RandomState(0).uniform(0, 1, (8, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(timage.rgb_to_intensity(_t(rgb)).numpy(),
                               _n(jimage.rgb_to_intensity(rgb)), atol=1e-7)


def test_hash_insert_lookup_match_jax():
    rng = np.random.RandomState(1)
    coords = rng.randint(-40, 40, (600, 3)).astype(np.int32)
    keys = _n(jhash.pack_key(coords))
    np.testing.assert_array_equal(thash.pack_key(_t(coords)).numpy(), keys)
    np.testing.assert_array_equal(thash.unpack_key(_t(keys)).numpy(), coords)
    mix_in = np.concatenate([keys, [-1, 0, 2 ** 31 - 1]]).astype(np.int32)
    np.testing.assert_array_equal(thash._mix(_t(mix_in)).numpy(),
                                  _n(jhash._mix(mix_in)).astype(np.int64))
    # two batches with repeats; the second also overflows a small pool
    batches = [np.concatenate([keys[:300], keys[:50]]), np.concatenate([keys[250:], [-1] * 8])]
    for limit in (2000, 500):
        tj, tt = jhash.HashTable.empty(2048), thash.HashTable.empty(2048, "cpu")
        cj, ct = jnp.int32(0), torch.zeros((), dtype=torch.int32)
        for b in batches:
            b = b.astype(np.int32)
            tj, cj, vj, oj = jhash.insert(tj, cj, b, limit)
            tt, ct, vt, ot = thash.insert(tt, ct, _t(b), limit)
            assert int(ct) == int(cj) and bool(ot) == bool(oj)
            assert ((vt.numpy() >= 0) == (_n(vj) >= 0)).all()
        assert set(tt.keys.numpy()[tt.keys.numpy() >= 0]) == set(_n(tj.keys)[_n(tj.keys) >= 0])
        # a slot is a stable answer per key, and absent keys miss
        q = np.concatenate([keys, _n(jhash.pack_key(np.full((5, 3), 100)))]).astype(np.int32)
        got = thash.lookup(tt, _t(q)).numpy()
        again = thash.insert(tt, ct, _t(q[:600]), limit)[2].numpy()
        np.testing.assert_array_equal(got[:600][got[:600] >= 0], again[got[:600] >= 0])
        assert (got[600:] == thash.MISS).all()
        assert ((got >= 0) == (_n(jhash.lookup(tj, q)) >= 0)).all()


@pytest.mark.parametrize("pose", [0, 1])
def test_synthetic_render_matches_jax(pose):
    T = np.eye(4) if pose == 0 else jorbit(5, radius=0.3, angle_span=1.0)[4]
    np.testing.assert_array_equal(orbit_trajectory(5, radius=0.3, angle_span=1.0)[4],
                                  jorbit(5, radius=0.3, angle_span=1.0)[4])
    zj, cj = JCamera(intrinsics=JINTR).render(np.asarray(T, np.float32))
    zt, ct = SyntheticCamera(intrinsics=INTR, device="cpu").render(T)
    # <= 1e-5 except at sphere silhouettes: a grazing ray's discriminant is
    # ~0, and its sqrt turns a 1-ulp difference into up to ~1e-4
    for a, b in ((zt.numpy(), _n(zj)), (ct.numpy(), _n(cj))):
        err = np.abs(a - b)
        assert (err <= 1e-5).mean() >= 0.998, (err > 1e-5).sum()
        assert err.max() <= 3e-4, err.max()


def test_cluttered_scene_render_matches_jax():
    """``Scene.cluttered()`` equals the JAX package's scene, and renders as
    it does at an orbit pose, to the bounds of the default scene's render."""
    assert dataclasses.asdict(Scene.cluttered()) == dataclasses.asdict(JScene.cluttered())
    T = jorbit(5, radius=0.3, angle_span=1.0)[3]
    zj, cj = JCamera(scene=JScene.cluttered(), intrinsics=JINTR).render(np.asarray(T, np.float32))
    zt, ct = SyntheticCamera(scene=Scene.cluttered(), intrinsics=INTR, device="cpu").render(T)
    zd, _ = SyntheticCamera(intrinsics=INTR, device="cpu").render(T)
    assert not torch.equal(zt, zd)  # the boxes are in view
    for a, b in ((zt.numpy(), _n(zj)), (ct.numpy(), _n(cj))):
        err = np.abs(a - b)
        assert (err <= 1e-5).mean() >= 0.998, (err > 1e-5).sum()
        assert err.max() <= 3e-4, err.max()


def test_rgbd_frame_valid_matches_jax(raw_frame):
    """``RGBDFrame.valid`` on a frame with holes (zeroed depth and depth
    beyond the truncation) equals the JAX package's."""
    d_raw, c_raw = raw_frame
    d_raw = np.array(d_raw)
    d_raw[10:30, 20:60] = 0
    d_raw[50:60, :] = 4000  # past depth_trunc 3.0 m
    f_j = JRGBDFrame.from_raw(d_raw, c_raw)
    f_t = RGBDFrame.from_raw(_t(d_raw), _t(c_raw))
    assert f_t.valid.dtype == torch.bool
    np.testing.assert_array_equal(f_t.valid.numpy(), _n(f_j.valid))
    assert 0 < int(f_t.valid.sum()) < f_t.valid.numel() - 1000


def test_synthetic_noise_needs_a_generator():
    with pytest.raises(ValueError):
        SyntheticCamera(intrinsics=INTR, depth_noise=0.01, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cam = SyntheticCamera(intrinsics=INTR, depth_noise=0.01, generator=gen, device="cpu")
    z0, _ = SyntheticCamera(intrinsics=INTR, device="cpu").render()
    z1, _ = cam.render()
    assert ((z1 > 0) == (z0 > 0)).all() and not torch.equal(z0, z1)


def test_pipeline_config_json_round_trip():
    jc = jcfg.PipelineConfig(odometry=jcfg.OdometryConfig(pyramid_iters=(4, 3, 2)),
                             tsdf=jcfg.TSDFConfig(voxel_size=0.01, block_capacity=1024,
                                                  hash_capacity=4096))
    tc = tcfg.PipelineConfig.from_json(jc.to_json())
    assert tc.to_json() == jc.to_json()
    assert jcfg.PipelineConfig.from_json(tc.to_json()) == jc
    assert interop.pipeline_config_from(jc) == tc
    assert tcfg.PipelineConfig().to_json() == jcfg.PipelineConfig().to_json()
    with pytest.raises(ValueError):
        tcfg.TSDFConfig(hash_capacity=1000)


def test_evaluation_copy_matches_jax():
    poses = jorbit(8, radius=0.3)
    noisy = [T + np.random.RandomState(i).normal(0, 1e-3, (4, 4)) * np.r_[1, 1, 1, 0][:, None]
             for i, T in enumerate(poses)]
    assert teval.ate(noisy, poses) == jeval.ate(noisy, poses)
    assert teval.rpe(noisy, poses, delta=2) == jeval.rpe(noisy, poses, delta=2)


def test_resolve_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit: building the kernels raises; nothing falls back."""
    from azurekinect3dreconstruction_tpu_torch.ops.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert not list((tmp_path / "kernels").glob("*.so"))


def test_port_imports_without_jax():
    """With jax made unimportable, every module of the port imports."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import azurekinect3dreconstruction_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
        "               if sys.modules[k] is not None)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
