"""The port's checkerboard calibration against the JAX package's: the
pattern generator and the synthetic board renderer (equal arrays), the
numpy corner detector (equal corners, to the bit), and intrinsics and the
stereo extrinsic on tests/test_io_calib.py's 10 synthetic views (within
1e-9 of JAX's, and within that test's bounds of the truth), through OpenCV
where it imports and through the numpy fallback; the synthetic rig's truth
of ``cli.calibrate_rig`` within a float32 ulp of the JAX script's."""

import jax.numpy as jnp
import numpy as np
import pytest

from azurekinect3dreconstruction_tpu.calib import checkerboard as jcb
from azurekinect3dreconstruction_tpu.calib import checkerboard_np as jcbn
from azurekinect3dreconstruction_tpu.core import se3 as jse3
from azurekinect3dreconstruction_tpu_torch.calib import checkerboard as cb
from azurekinect3dreconstruction_tpu_torch.calib import checkerboard_np as cbn
from azurekinect3dreconstruction_tpu_torch.cli import calibrate_rig

K = np.array([[520.0, 0, 320], [0, 520, 240], [0, 0, 1]])
XI_T10 = [0.1, 0.01, 0.0, 0.0, 0.08, 0.0]
CALIB_TOL = 1e-9


def _jexp(xi):
    return np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)


@pytest.fixture(scope="module")
def views():
    """tests/test_io_calib.py's rig and its 10 board-view pairs, rendered by
    JAX: (T10, views0, views1)."""
    rng = np.random.RandomState(0)
    T10 = _jexp(XI_T10)
    views0, views1 = [], []
    for i in range(10):
        xi = np.concatenate([[0.04 * i - 0.15, 0.015 * i - 0.06, 0.55 + 0.04 * i],
                             rng.uniform(-0.22, 0.22, 3)])
        T0 = _jexp(xi)
        views0.append(jcb.render_board_view(K, T0))
        views1.append(jcb.render_board_view(K, np.linalg.inv(T10) @ T0))
    return T10, views0, views1


@pytest.mark.parametrize("cols, rows, square, margin", [(10, 7, 100, 50), (9, 6, 40, 40),
                                                        (5, 4, 7, 3)])
def test_generate_checkerboard_matches_jax(cols, rows, square, margin):
    np.testing.assert_array_equal(cb.generate_checkerboard(cols, rows, square, margin),
                                  jcb.generate_checkerboard(cols, rows, square, margin))


def test_render_board_view_matches_jax(views):
    T10, views0, _ = views
    rng = np.random.RandomState(0)
    for i in range(3):
        xi = np.concatenate([[0.04 * i - 0.15, 0.015 * i - 0.06, 0.55 + 0.04 * i],
                             rng.uniform(-0.22, 0.22, 3)])
        np.testing.assert_array_equal(cb.render_board_view(K, _jexp(xi)), views0[i])


def test_find_corners_np_matches_jax_to_the_bit(views):
    """The numpy detector on JAX's rendered views: the same 54 corners, or
    None where JAX finds none."""
    _, views0, views1 = views
    found = 0
    for img in views0[:5] + views1[:5]:
        want, got = jcbn.find_corners_np(img, (9, 6)), cbn.find_corners_np(img, (9, 6))
        if want is None:
            assert got is None
            continue
        found += 1
        assert got.dtype == want.dtype and got.shape == (54, 2)
        np.testing.assert_array_equal(got, want)
    assert found >= 8
    board = jcb.generate_checkerboard(cols=10, rows=7, square_px=40)
    np.testing.assert_array_equal(cbn.find_corners_np(board, (9, 6)),
                                  jcbn.find_corners_np(board, (9, 6)))


@pytest.mark.parametrize("opencv", [True, False])
def test_calibration_matches_jax_and_the_truth(views, monkeypatch, opencv):
    """Intrinsics of both cameras and the stereo extrinsic within 1e-9 of
    JAX's; the extrinsic within tests/test_io_calib.py's bounds (4 cm, 3
    deg) of the truth, and through OpenCV, whose path that test takes, its
    intrinsic bounds too (rms < 1.5 px, fx within 20 px; the numpy fallback
    of both packages lands 22.7 px off in fx on these views). OpenCV runs
    on one thread: its threaded solver differs from call to call by ~1e-7.
    ``opencv=False`` hides OpenCV from both packages, so both take their
    numpy fallback."""
    if opencv:
        cv2 = pytest.importorskip("cv2", reason="OpenCV is not installed (the numpy case runs)")
        n_threads = cv2.getNumThreads()
        cv2.setNumThreads(1)
    else:
        monkeypatch.setattr(jcb, "_cv2", lambda: None)
        monkeypatch.setattr(cb, "_cv2", lambda: None)
    T10, views0, views1 = views
    outs = {}
    try:
        for name, mod in (("jax", jcb), ("port", cb)):
            i0 = mod.calibrate_intrinsics(views0, pattern=(9, 6), square_size=0.025)
            i1 = mod.calibrate_intrinsics(views1, pattern=(9, 6), square_size=0.025)
            st = mod.calibrate_stereo(views0, views1, i0[0], i0[1], i1[0], i1[1],
                                      pattern=(9, 6), square_size=0.025)
            outs[name] = (i0, i1, st)
    finally:
        if opencv:
            cv2.setNumThreads(n_threads)
    for (iw, ig) in zip(outs["jax"][:2], outs["port"][:2]):
        (kw, dw, rw), (kg, dg, rg) = iw, ig
        np.testing.assert_allclose([kg.fx, kg.fy, kg.cx, kg.cy], [kw.fx, kw.fy, kw.cx, kw.cy],
                                   rtol=0, atol=CALIB_TOL)
        assert (kg.width, kg.height) == (kw.width, kw.height)
        np.testing.assert_allclose(
            [dg.k1, dg.k2, dg.p1, dg.p2, dg.k3, dg.k4, dg.k5, dg.k6],
            [dw.k1, dw.k2, dw.p1, dw.p2, dw.k3, dw.k4, dw.k5, dw.k6], rtol=0, atol=CALIB_TOL)
        assert abs(rg - rw) <= CALIB_TOL
        assert rg < 1.5
        if opencv:
            assert abs(kg.fx - 520) < 20
    (Tw, rms_w), (Tg, rms_g) = outs["jax"][2], outs["port"][2]
    np.testing.assert_allclose(Tg, Tw, rtol=0, atol=CALIB_TOL)
    assert abs(rms_g - rms_w) <= CALIB_TOL
    assert np.linalg.norm(Tg[:3, 3] - T10[:3, 3]) < 0.04
    cos = (np.trace(Tg[:3, :3].T @ T10[:3, :3]) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 3.0


def test_synthetic_rig_truth_matches_the_jax_script():
    """``cli.calibrate_rig``'s synthetic rig: the port's float32 ``se3_exp``
    cast to float64 gives the JAX script's T10 and board poses within one
    float32 ulp of 1 (PyTorch's float32 sin and cos differ from XLA's by an
    ulp on some inputs, so not to the bit)."""
    ulp = float(np.spacing(np.float32(1.0)))
    np.testing.assert_allclose(calibrate_rig._exp64(calibrate_rig.SYNTH_T10_XI),
                               _jexp(list(calibrate_rig.SYNTH_T10_XI)), rtol=0, atol=ulp)
    rng = np.random.RandomState(0)
    for i in range(8):
        xi = np.concatenate([[0.04 * i - 0.15, 0.015 * i - 0.06, 0.55 + 0.04 * i],
                             rng.uniform(-0.22, 0.22, 3)])
        np.testing.assert_allclose(calibrate_rig._exp64(xi), _jexp(xi), rtol=0, atol=ulp)
