"""The port's capture threads, synchronized rig and frame feeder
(``io/streams.py``), the camera and file sources' gating (``io/mkv.py``,
``io/k4a_live.py``, ``cli/common.make_source``), and the helpers the
sources use: the mirrors of tests/test_io_calib.py's tests of the same
pieces, plus the port's own.

The capture tests wait on conditions with a deadline, not on fixed sleeps.
The JAX package is imported only inside the parity test of the helpers,
so that the card-only tests (marked ``cuda``) also run where jax is not
installed: ``python -m pytest --noconftest -m cuda tests/test_torch_streams.py``.
"""

import argparse
import threading
import time

import numpy as np
import pytest
import torch

from azurekinect3dreconstruction_tpu_torch.cli.common import make_source
from azurekinect3dreconstruction_tpu_torch.config import PipelineConfig, TSDFConfig
from azurekinect3dreconstruction_tpu_torch.core.camera import Intrinsics
from azurekinect3dreconstruction_tpu_torch.io import k4a_live, mkv
from azurekinect3dreconstruction_tpu_torch.io.streams import (
    CaptureThread,
    DeviceFeeder,
    MultiCameraRig,
    prefetch_to_device,
)
from azurekinect3dreconstruction_tpu_torch.io.synthetic import SyntheticCamera, orbit_trajectory
from azurekinect3dreconstruction_tpu_torch.pipelines.mono_odometry_tsdf import MonoOdometryTSDF

DEADLINE_S = 5.0


def _wait_for(cond, deadline=DEADLINE_S) -> bool:
    """Poll ``cond`` until it holds or ``deadline`` seconds pass."""
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.002)
    return cond()


def test_capture_thread_latest_wins():
    """A full queue drops new frames; the consumer always sees the newest."""
    counter = {"n": 0}

    def fake_capture():
        counter["n"] += 1
        return (counter["n"],)

    t = CaptureThread(fake_capture, maxsize=3)
    t.start()
    try:
        assert _wait_for(lambda: t.frames_dropped > 0), "a bounded queue must drop when full"
        f1 = t.get_latest_frame()
        assert f1 is not None
        assert _wait_for(lambda: t.queue.full())
        f2 = t.get_latest_frame()
    finally:
        t.stop()
    assert not t.is_alive()
    assert f2[0] > f1[0], "the consumer must always see the newest frame"


def test_capture_thread_retries_after_an_error():
    """A capture error is retried after the backoff; the thread keeps going."""
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("usb hiccup")
        return (calls["n"],)

    t = CaptureThread(flaky, retry_backoff=0.01)
    t.start()
    try:
        assert _wait_for(lambda: t.frames_captured > 0)
        assert t.get_latest_frame(timeout=DEADLINE_S)[0] >= 2
    finally:
        t.stop()
    assert not t.is_alive()


def test_multicamera_rig_synchronized():
    def mk(cam):
        def f():
            time.sleep(0.001)
            return (cam, time.time())
        return f

    rig = MultiCameraRig([mk(0), mk(1)])
    rig.start()
    try:
        frames = rig.get_synchronized_frames(timeout=DEADLINE_S)
    finally:
        rig.stop()
    assert frames is not None and len(frames) == 2
    assert frames[0][0] == 0 and frames[1][0] == 1
    assert not any(t.is_alive() for t in rig.threads)


def test_multicamera_rig_starved_camera_gives_none():
    """All or nothing: one silent camera means no frame set."""
    started = threading.Event()

    def live():
        started.set()
        time.sleep(0.001)
        return (0,)

    rig = MultiCameraRig([live, lambda: None])
    rig.start()
    try:
        assert started.wait(DEADLINE_S)
        assert rig.get_synchronized_frames(retries=2, timeout=0.02) is None
    finally:
        rig.stop()


def test_device_feeder_double_buffer():
    """Only the ``depth`` newest frames stay in flight."""
    f = DeviceFeeder(depth=2, device="cpu")
    for i in range(4):
        f.put(np.full((4, 4), i, np.float32))
    assert len(f) == 2
    a = f.get()
    assert float(a[0][0, 0]) == 2.0 and isinstance(a[0], torch.Tensor)
    assert float(f.get()[0][0, 0]) == 3.0 and f.get() is None and len(f) == 0


def test_device_feeder_rejects_a_depth_of_0_and_a_missing_card():
    with pytest.raises(ValueError):
        DeviceFeeder(depth=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            DeviceFeeder()  # the default device is the card


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_yields_every_frame_in_order(depth):
    """Every frame comes out once, in order, as CPU tensors equal to the
    host arrays (u16 depth and u8 color keep their types)."""
    rng = np.random.default_rng(depth)
    frames = [(rng.integers(0, 4000, (6, 8), dtype=np.uint16),
               rng.integers(0, 255, (6, 8, 3), dtype=np.uint8)) for _ in range(7)]
    out = list(prefetch_to_device(iter(frames), depth=depth, device="cpu"))
    assert len(out) == len(frames)
    for (d, c), (dt, ct) in zip(frames, out):
        assert dt.dtype == torch.uint16 and ct.dtype == torch.uint8
        np.testing.assert_array_equal(dt.numpy(), d)
        np.testing.assert_array_equal(ct.numpy(), c)


def test_prefetch_keeps_nested_pairs():
    """The dual loop's ``((d0, c0), (d1, c1))`` pairs keep their structure;
    leaves that are not arrays pass through."""
    pairs = [((np.full((2, 2), i, np.uint16), np.full((2, 2, 3), i, np.uint8)),
              (np.full((2, 2), 10 + i, np.uint16), np.full((2, 2, 3), 10 + i, np.uint8)))
             for i in range(4)]
    out = list(prefetch_to_device(iter(pairs), device="cpu"))
    assert len(out) == 4
    for i, ((d0, c0), (d1, c1)) in enumerate(out):
        assert int(d0[0, 0]) == i and int(c0[0, 0, 0]) == i
        assert int(d1[0, 0]) == 10 + i and int(c1[1, 1, 2]) == 10 + i
    f = DeviceFeeder(device="cpu")
    f.put(np.zeros(3), ("tag", 7), [np.ones(2)])
    a, (tag, n), [b] = f.get()
    assert tag == "tag" and n == 7 and isinstance(a, torch.Tensor) and float(b.sum()) == 2.0


def test_k4a_gating():
    """pyk4a is not installed here: the adapter degrades, it does not crash."""
    assert k4a_live.is_available() is False
    assert k4a_live.detect_cameras() == [] and k4a_live.rig_serials() == []
    with pytest.raises(RuntimeError, match="pyk4a"):
        k4a_live.K4ALiveSource()


def test_mkv_replay_gating():
    assert mkv.is_available() is False
    with pytest.raises(RuntimeError, match="pyk4a"):
        mkv.MkvReplaySource("/nonexistent.mkv")


@pytest.mark.parametrize("spec", ["mkv:/nonexistent.mkv", "k4a", "k4a:1", "kinect"])
def test_make_source_exits_with_a_clear_error(spec):
    """Without pyk4a the camera and file sources exit naming it; an unknown
    source names the choices."""
    args = argparse.Namespace(source=spec, frames=2, scale=1.0, device="cpu")
    with pytest.raises(SystemExit, match="pyk4a" if spec != "kinect" else "mkv:<file>"):
        make_source(args)


def test_source_helpers_match_jax():
    """``Intrinsics.primesense_default`` / ``fallback_from_size``,
    ``ops.image.bgra_to_rgb`` / ``flip_ud`` and ``io.synthetic.small_motion``
    against the JAX package's: equal, ``small_motion`` within 1e-6 (one
    float32 twist through two ``se3_exp``s)."""
    import dataclasses

    from azurekinect3dreconstruction_tpu.core.camera import Intrinsics as JIntrinsics
    from azurekinect3dreconstruction_tpu.io.synthetic import small_motion as jsmall_motion
    from azurekinect3dreconstruction_tpu.ops import image as jimage

    from azurekinect3dreconstruction_tpu_torch.io.synthetic import small_motion
    from azurekinect3dreconstruction_tpu_torch.ops import image

    assert dataclasses.astuple(Intrinsics.primesense_default()) == dataclasses.astuple(
        JIntrinsics.primesense_default())
    assert dataclasses.astuple(Intrinsics.fallback_from_size(1280, 720)) == dataclasses.astuple(
        JIntrinsics.fallback_from_size(1280, 720))
    bgra = np.random.default_rng(0).integers(0, 255, (5, 7, 4), dtype=np.uint8)
    np.testing.assert_array_equal(image.bgra_to_rgb(bgra).numpy(),
                                  np.asarray(jimage.bgra_to_rgb(bgra)))
    np.testing.assert_array_equal(image.flip_ud(bgra).numpy(), np.asarray(jimage.flip_ud(bgra)))
    for i in range(4):
        np.testing.assert_allclose(small_motion(i, 2.0), np.asarray(jsmall_motion(i, 2.0)),
                                   rtol=0, atol=1e-6)


# -- on the card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_feeder_ring_reuses_staging_without_tearing(card):
    """64 frames, each a distinct fill, through a 2-deep feeder while the
    consumer's stream is kept busy: every frame arrives whole and in order,
    and the staging ring holds 2 pinned sets that are reused."""
    frames = [(np.full((576, 640), i, np.uint16), np.full((576, 640, 3), i % 251, np.uint8))
              for i in range(64)]
    feeder = DeviceFeeder(depth=2, device=card)
    busy = torch.randn(2048, 2048, device=card)
    seen, staging = [], set()

    def consume(frame):
        nonlocal busy
        d, c = frame
        busy = busy @ busy / 2048.0  # the consumer's stream stays busy while the next uploads
        d, c = d.to(torch.int32), c.to(torch.int32)  # no u16 reductions on the card
        seen.append(torch.stack([d.min(), d.max(), c.min(), c.max()]).cpu().tolist())

    for fr in frames:  # prefetch_to_device's loop
        feeder.put(*fr)
        staging.update(b.data_ptr() for slot in feeder._staging if slot for b in slot[0])
        if len(feeder) >= 2:
            consume(feeder.get())
    while len(feeder):
        consume(feeder.get())
    torch.cuda.synchronize()
    assert seen == [[i, i, i % 251, i % 251] for i in range(64)]
    assert len(staging) == 4  # 2 slots x (depth, color)


@pytest.mark.cuda
def test_prefetched_mono_loop_equals_the_unfed_loop(card):
    """``MonoOdometryTSDF`` fed through the feeder gives the trajectory of
    the same loop fed host arrays, to the bit (a torn or early-read frame
    would move a pose)."""
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.5)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=0.01, sdf_trunc=0.04, block_resolution=8,
                                         block_capacity=4096, hash_capacity=16384))
    cam = SyntheticCamera(intrinsics=intr, device=card)
    frames = [cam.capture(T) for T in orbit_trajectory(12, radius=0.3, angle_span=0.6)]
    plain = MonoOdometryTSDF(intr, cfg, device=card, worklist_size=2048)
    for d, c in frames:
        plain.process_frame(d, c)
    fed = MonoOdometryTSDF(intr, cfg, device=card, worklist_size=2048)
    for d, c in prefetch_to_device(iter(frames), device=card):
        fed.process_frame(d, c)
    assert np.array_equal(np.stack(fed.trajectory), np.stack(plain.trajectory))
    assert fed.odometry_failures == 0


@pytest.mark.cuda
def test_prefetched_mono_loop_never_synchronizes(card):
    """After its first frame, ``MonoOdometryTSDF`` fed through
    ``prefetch_to_device`` makes no synchronizing call:
    ``torch.cuda.set_sync_debug_mode("error")`` raises on one. (The feeder's
    wait on a staging set still being copied from is an event wait, which
    the mode does not report.)"""
    intr = Intrinsics.azure_kinect_depth_nfov().scaled(0.5)
    cfg = PipelineConfig(tsdf=TSDFConfig(voxel_size=0.01, sdf_trunc=0.04, block_resolution=8,
                                         block_capacity=4096, hash_capacity=16384))
    cam = SyntheticCamera(intrinsics=intr, device=card)
    frames = [cam.capture(T) for T in orbit_trajectory(12, radius=0.3, angle_span=0.6)]
    pipe = MonoOdometryTSDF(intr, cfg, device=card, worklist_size=2048)
    fed = prefetch_to_device(iter(frames), device=card)
    pipe.process_frame(*next(fed))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for d, c in fed:
            pipe.process_frame(d, c)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(pipe.trajectory) == len(frames) + 1 and pipe.odometry_failures == 0
