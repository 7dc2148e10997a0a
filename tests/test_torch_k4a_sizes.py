"""The camera sources' frame sizes with a stand-in ``pyk4a``: the live
source (``io.k4a_live.K4ALiveSource``) and the MKV replay
(``io.mkv.MkvReplaySource``) give their intrinsics the sizes of the frames
they yield (the configured color resolution and depth mode, or the
recording's), and ``cli.dual_fusion``'s k4a branch gives each camera its
own color intrinsics. The JAX package's sources still write 1280x720 into
the color intrinsics whatever the mode, a recorded difference.

The stand-in module is installed on ``sys.modules`` for each test only
(``monkeypatch``); it models the parts of pyk4a the sources call: the
``Config`` dataclass and its enums, ``PyK4A`` with a per-mode
``Calibration``, and ``PyK4APlayback`` with its configuration dict and
captures."""

import dataclasses
import enum
import sys
import types

import numpy as np
import pytest

from azurekinect3dreconstruction_tpu.io import k4a_live as jk4a_live
from azurekinect3dreconstruction_tpu.io import mkv as jmkv
from azurekinect3dreconstruction_tpu_torch.cli import dual_fusion as cli_dual
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.io import k4a_live, mkv

COLOR_SIZES = {"RES_720P": (1280, 720), "RES_1080P": (1920, 1080), "RES_1440P": (2560, 1440),
               "RES_1536P": (2048, 1536), "RES_2160P": (3840, 2160), "RES_3072P": (4096, 3072)}
DEPTH_SIZES = {"NFOV_2X2BINNED": (320, 288), "NFOV_UNBINNED": (640, 576),
               "WFOV_2X2BINNED": (512, 512), "WFOV_UNBINNED": (1024, 1024)}


def _stand_in_pyk4a(n_devices: int = 2, recording=None, probe_fails: bool = False):
    """A module with pyk4a's interface: device ``i``'s color focal length is
    ``0.47 * width + 6 * i`` pixels (two units differ); a recording is a
    dict with ``configuration`` and ``frames`` (a list of (color, depth,
    transformed_depth))."""
    m = types.ModuleType("pyk4a")
    m.ColorResolution = enum.IntEnum("ColorResolution", ["OFF"] + list(COLOR_SIZES), start=0)
    m.DepthMode = enum.IntEnum("DepthMode", ["OFF"] + list(DEPTH_SIZES) + ["PASSIVE_IR"],
                               start=0)
    m.FPS = enum.IntEnum("FPS", ["FPS_5", "FPS_15", "FPS_30"], start=0)
    m.ImageFormat = enum.IntEnum("ImageFormat", ["COLOR_MJPG", "COLOR_NV12", "COLOR_YUY2",
                                                 "COLOR_BGRA32", "DEPTH16"], start=0)

    @dataclasses.dataclass
    class Config:
        color_resolution: int = m.ColorResolution.RES_720P
        depth_mode: int = m.DepthMode.NFOV_UNBINNED
        camera_fps: int = m.FPS.FPS_30
        synchronized_images_only: bool = False

    class Calibration:
        def __init__(self, color_size, depth_size, device_id=0):
            self.sizes, self.device_id = (depth_size, color_size), device_id

        def get_camera_matrix(self, camera):
            if probe_fails:
                raise RuntimeError("no calibration")
            w, h = self.sizes[camera]
            f = 0.47 * w + 6.0 * self.device_id * (camera == 1)
            return np.array([[f, 0, w / 2 - 2.5], [0, f * 1.001, h / 2 + 1.5], [0, 0, 1]])

    class Capture:
        def __init__(self, color_size, depth_size, fmt="COLOR_BGRA32"):
            (cw, ch), (dw, dh) = color_size, depth_size
            self.color = np.full((ch, cw, 4), 7, np.uint8)
            if fmt == "COLOR_MJPG":
                import cv2

                self.color = cv2.imencode(".jpg", self.color[..., :3])[1].reshape(-1)
            self.depth = np.full((dh, dw), 1000, np.uint16)
            self.transformed_depth = np.full((ch, cw), 1000, np.uint16)

    class PyK4A:
        def __init__(self, config=None, device_id=0):
            if device_id >= n_devices:
                raise RuntimeError(f"no device {device_id}")
            self.config = config or Config()
            self.device_id, self.serial = device_id, f"00{device_id}"

        def start(self):
            pass

        def stop(self):
            pass

        def _sizes(self):
            return (COLOR_SIZES[self.config.color_resolution.name],
                    DEPTH_SIZES[self.config.depth_mode.name])

        @property
        def calibration(self):
            return Calibration(*self._sizes(), self.device_id)

        def get_capture(self):
            return Capture(*self._sizes())

    class PyK4APlayback:
        def __init__(self, path):
            self.path, self._next = path, 0
            self.configuration = dict(recording["configuration"])

        def open(self):
            pass

        def close(self):
            pass

        @property
        def calibration(self):
            return Calibration(*recording["sizes"])

        def get_next_capture(self):
            if self._next >= recording["frames"]:
                raise EOFError
            self._next += 1
            fmt = self.configuration.get("color_format", m.ImageFormat.COLOR_BGRA32).name
            return Capture(*recording["sizes"], fmt)

    m.Config, m.PyK4A, m.PyK4APlayback = Config, PyK4A, PyK4APlayback
    return m


@pytest.mark.parametrize("color_resolution,depth_mode", [
    ("RES_720P", "NFOV_UNBINNED"), ("RES_1080P", "NFOV_UNBINNED"),
    ("RES_1536P", "WFOV_2X2BINNED"), ("RES_1080P", "NFOV_2X2BINNED")])
def test_live_source_reports_its_modes_sizes(monkeypatch, color_resolution, depth_mode):
    """``K4ALiveSource`` at a color resolution and depth mode: the color and
    depth intrinsics carry the modes' sizes and the stand-in's per-mode
    matrices, and a capture's color-aligned frames have the color size."""
    fake = _stand_in_pyk4a()
    monkeypatch.setitem(sys.modules, "pyk4a", fake)
    src = k4a_live.K4ALiveSource(color_resolution=color_resolution, depth_mode=depth_mode)
    (cw, ch), (dw, dh) = COLOR_SIZES[color_resolution], DEPTH_SIZES[depth_mode]
    c, d = src.calibration.color, src.calibration.depth
    assert (c.width, c.height, d.width, d.height) == (cw, ch, dw, dh)
    assert c.fx == pytest.approx(0.47 * cw) and c.cx == pytest.approx(cw / 2 - 2.5)
    assert d.fx == pytest.approx(0.47 * dw)
    depth, color = src.capture()
    assert depth.shape == (ch, cw) and color.shape == (ch, cw, 3)


def test_live_source_fallback_takes_the_real_size(monkeypatch):
    """When the calibration probe fails, the width * 1.03 guess is made at
    the configured size: 1920x1080 at RES_1080P (the nominal depth model at
    NFOV_UNBINNED)."""
    monkeypatch.setitem(sys.modules, "pyk4a", _stand_in_pyk4a(probe_fails=True))
    src = k4a_live.K4ALiveSource(color_resolution="RES_1080P")
    assert src.calibration.color == Intrinsics.fallback_from_size(1920, 1080)
    assert src.calibration.depth == Intrinsics.azure_kinect_depth_nfov()
    src = k4a_live.K4ALiveSource(color_resolution="RES_720P", depth_mode="WFOV_UNBINNED")
    assert src.calibration.depth == Intrinsics.fallback_from_size(1024, 1024)


def test_live_source_takes_the_modes_the_device_started_with(monkeypatch):
    """The init ladder's last rung starts the device with pyk4a's default
    ``Config()``: the sizes are those of the modes it started with, not of
    the ones asked for."""
    fake = _stand_in_pyk4a()
    real_init = fake.PyK4A.__init__

    def init(self, config=None, device_id=0):
        if config is not None and config.color_resolution != fake.ColorResolution.RES_720P:
            raise RuntimeError("mode not supported")
        real_init(self, config, device_id)

    monkeypatch.setattr(fake.PyK4A, "__init__", init)
    monkeypatch.setitem(sys.modules, "pyk4a", fake)
    src = k4a_live.K4ALiveSource(color_resolution="RES_1080P")
    assert (src.calibration.color.width, src.calibration.color.height) == (1280, 720)


def test_jax_live_source_writes_720p_whatever_the_mode(monkeypatch):
    """The recorded difference: the JAX package's source at RES_1080P still
    reports 1280x720 color and 640x576 depth intrinsics while its frames
    are 1920x1080."""
    monkeypatch.setitem(sys.modules, "pyk4a", _stand_in_pyk4a())
    src = jk4a_live.K4ALiveSource(color_resolution="RES_1080P", depth_mode="WFOV_2X2BINNED")
    c, d = src.calibration.color, src.calibration.depth
    assert (c.width, c.height, d.width, d.height) == (1280, 720, 640, 576)
    assert src.capture()[0].shape == (1080, 1920)


def _recording(color="RES_1080P", depth="NFOV_UNBINNED", fmt="COLOR_BGRA32", modes=True):
    fake = _stand_in_pyk4a(recording={})
    conf = {"color_format": fake.ImageFormat[fmt]}
    if modes:
        conf.update(color_resolution=fake.ColorResolution[color],
                    depth_mode=fake.DepthMode[depth])
    rec = {"configuration": conf, "sizes": (COLOR_SIZES[color], DEPTH_SIZES[depth]), "frames": 3}
    return _stand_in_pyk4a(recording=rec)


@pytest.mark.parametrize("modes", [True, False], ids=["configuration", "first_capture"])
def test_mkv_source_reports_the_recordings_sizes(monkeypatch, tmp_path, modes):
    """A 1080p recording (k4arecorder's default color resolution): the
    intrinsics are 1920x1080 color and 640x576 depth, from the recording's
    configuration, or from its first capture when the configuration does
    not name the modes; every capture is still yielded, at that size."""
    monkeypatch.setitem(sys.modules, "pyk4a", _recording(modes=modes))
    src = mkv.MkvReplaySource(str(tmp_path / "take.mkv"))
    c, d = src.calibration.color, src.calibration.depth
    assert (c.width, c.height, d.width, d.height) == (1920, 1080, 640, 576)
    assert c.fx == pytest.approx(0.47 * 1920)
    frames = list(src.frames())
    assert len(frames) == 3
    assert all(dd.shape == (1080, 1920) and cc.shape == (1080, 1920, 3) for dd, cc in frames)


def test_mkv_source_decodes_mjpeg_color(monkeypatch, tmp_path):
    """An MJPEG color track (the configuration is a dict, as pyk4a gives
    it) is decoded to RGB at the recording's size."""
    pytest.importorskip("cv2")
    monkeypatch.setitem(sys.modules, "pyk4a", _recording(color="RES_720P", fmt="COLOR_MJPG"))
    frames = list(mkv.MkvReplaySource(str(tmp_path / "take.mkv")).frames())
    assert len(frames) == 3 and all(cc.shape == (720, 1280, 3) for _, cc in frames)


def test_jax_mkv_source_writes_720p_whatever_the_recording(monkeypatch, tmp_path):
    """The recorded difference: the JAX package's MKV source reports 1280x720
    color intrinsics for a 1080p recording."""
    monkeypatch.setitem(sys.modules, "pyk4a", _recording())
    src = jmkv.MkvReplaySource(str(tmp_path / "take.mkv"))
    assert (src.calibration.color.width, src.calibration.color.height) == (1280, 720)


def test_dual_fusion_gives_each_camera_its_own_intrinsics(monkeypatch):
    """``cli.dual_fusion --source k4a``: the pair's intrinsics are each
    camera's own color intrinsics (device 1's focal length 6 px off device
    0's), and the pipeline is built with both."""
    monkeypatch.setitem(sys.modules, "pyk4a", _stand_in_pyk4a())
    args = types.SimpleNamespace(frames=1)
    _, intrs = cli_dual.k4a_pair_frames(args)
    assert intrs[0].width == intrs[1].width == 1280
    assert intrs[1].fx == pytest.approx(intrs[0].fx + 6.0)

    built = []

    class Built(Exception):
        pass

    def fake_fusion(intrinsics, *a, **k):
        built.append(tuple(intrinsics))
        raise Built

    monkeypatch.setattr(cli_dual, "DualCameraFusion", fake_fusion)
    with pytest.raises(Built):
        cli_dual.main(["--source", "k4a", "--frames", "1", "--device", "cpu", "--headless"])
    assert built == [intrs]
