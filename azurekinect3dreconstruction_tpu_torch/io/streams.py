"""Host-parallel capture and the double-buffered host-to-device frame
feeder (the counterpart of the JAX package's ``io/streams.py``).

``CaptureThread`` and ``MultiCameraRig`` are host only: one daemon thread a
camera pulls frames into a bounded latest-wins queue (a full queue drops
the new frame; the consumer drains to the newest), a capture error retries
after a backoff, the rig hands out all-or-nothing frame sets with retries,
and ``install_sigint_handler`` stops the threads on Ctrl-C.

``DeviceFeeder`` uploads frame k+1 while the consumer computes on frame k.
On a card it keeps a ring of page-locked staging buffers, one set per
in-flight frame, reused from frame to frame, and issues ``non_blocking``
copies on a copy stream of its own; the consumer's stream waits on the
copy's event before it reads. On the CPU the arrays pass through as
tensors, without pinning.
"""

from __future__ import annotations

import collections
import queue
import signal
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from azurekinect3dreconstruction_tpu_torch.core.device import resolve_device
from azurekinect3dreconstruction_tpu_torch.utils.telemetry import log_info, log_warning


class CaptureThread(threading.Thread):
    """Daemon thread pulling frames from any callable source into a bounded
    latest-wins queue."""

    def __init__(self, capture_fn: Callable[[], Optional[tuple]], camera_id: int = 0,
                 maxsize: int = 5, retry_backoff: float = 1.0):
        super().__init__(daemon=True, name=f"capture-{camera_id}")
        self.capture_fn = capture_fn
        self.camera_id = camera_id
        self.queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.retry_backoff = retry_backoff
        self._running = threading.Event()
        self._running.set()
        self.frames_captured = 0
        self.frames_dropped = 0

    def run(self) -> None:
        while self._running.is_set():
            try:
                frame = self.capture_fn()
            except Exception as e:  # a capture failure: retry after the backoff
                log_warning(f"camera {self.camera_id}: capture error {e}; retrying")
                time.sleep(self.retry_backoff)
                continue
            if frame is None:
                time.sleep(0.001)
                continue
            self.frames_captured += 1
            try:
                self.queue.put_nowait(frame)
            except queue.Full:
                self.frames_dropped += 1  # the consumer keeps latest-wins

    def get_latest_frame(self, timeout: float = 0.0):
        """Drain the queue and return the newest frame (None if empty)."""
        try:
            frame = self.queue.get(timeout=timeout) if timeout else self.queue.get_nowait()
        except queue.Empty:
            return None
        while True:
            try:
                frame = self.queue.get_nowait()
            except queue.Empty:
                return frame

    def stop(self, join_timeout: float = 1.0) -> None:
        self._running.clear()
        self.join(timeout=join_timeout)


class MultiCameraRig:
    """Synchronized capture across cameras: all-or-nothing frame sets with
    retries."""

    def __init__(self, capture_fns: Sequence[Callable[[], Optional[tuple]]], maxsize: int = 5):
        self.threads = [CaptureThread(fn, i, maxsize) for i, fn in enumerate(capture_fns)]

    def start(self) -> None:
        for t in self.threads:
            t.start()
        log_info(f"started {len(self.threads)} capture thread(s)")

    def get_synchronized_frames(self, retries: int = 5, timeout: float = 0.2):
        """Latest frame from every camera, or None if any camera starves."""
        for _ in range(retries):
            frames = [t.get_latest_frame(timeout=timeout) for t in self.threads]
            if all(f is not None for f in frames):
                return frames
        return None

    def stop(self) -> None:
        for t in self.threads:
            t.stop()

    def install_sigint_handler(self, on_shutdown: Optional[Callable] = None) -> None:
        """Graceful Ctrl-C: stop the capture threads, run ``on_shutdown``,
        then raise ``KeyboardInterrupt``."""

        def handler(signum, frame):
            log_info("shutting down (SIGINT)")
            self.stop()
            if on_shutdown:
                on_shutdown()
            raise KeyboardInterrupt

        signal.signal(signal.SIGINT, handler)


def _flatten(tree, leaves: list):
    """Append the leaves of nested tuples and lists to ``leaves``; return
    the structure (a leaf is ``None``)."""
    if isinstance(tree, (tuple, list)):
        return type(tree), [_flatten(x, leaves) for x in tree]
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, children = spec
    return kind(_unflatten(c, leaves) for c in children)


class DeviceFeeder:
    """Host-to-device pipeline ``depth`` frames deep: :meth:`put` issues
    frame k+1's upload while the consumer computes on frame k. A ``put``
    past ``depth`` frames in flight drops the oldest.

    On a card (``device`` ``"cuda"``, the default; ``RuntimeError`` without
    one) each host array of a frame is copied into page-locked staging
    memory, one set per in-flight frame, reused round the ring, and then to
    the card with a ``non_blocking`` copy on the feeder's copy stream, whose
    event is recorded after the frame's copies. A staging set is written
    only after its previous copy's event has completed, so no copy reads a
    half-written frame. :meth:`get` makes the caller's current stream wait
    on the frame's event before anything reads it, and records the frame's
    tensors (allocated on the copy stream) on the caller's stream, so the
    caching allocator keeps their memory until that stream is done with
    them. Tensors already on the card pass through. Nothing waits on the
    device but a ``put`` whose staging set is still being copied from.

    On the CPU the arrays pass through as tensors (``torch.from_numpy``:
    no copy, no pinning). Frames may be nested tuples or lists of arrays
    (the dual loop's ``((d0, c0), (d1, c1))``); other leaves pass through."""

    def __init__(self, depth: int = 2, device="cuda"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self.depth = depth
        self._buf = collections.deque()  # (structure, leaves, uploaded leaf indices, event)
        self._n_put = 0
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
            self._staging = [None] * depth  # per slot: ([pinned buffer or None], event)

    def put(self, *arrays) -> None:
        leaves = []
        spec = _flatten(tuple(arrays), leaves)
        if self.device.type != "cuda":
            out = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
                   else a for a in leaves]
            self._buf.append((spec, out, (), None))
        else:
            self._buf.append((spec, *self._upload(leaves)))
        while len(self._buf) > self.depth:
            self._buf.popleft()

    def _upload(self, leaves):
        """Stage and copy one frame's host arrays on the copy stream:
        (leaves on the card, indices of the uploaded ones, copy event)."""
        k = self._n_put % self.depth
        self._n_put += 1
        if self._staging[k] is not None:
            self._staging[k][1].synchronize()  # the slot's last copy has landed
            bufs = self._staging[k][0]
        else:
            bufs = []
        bufs = bufs + [None] * (len(leaves) - len(bufs))
        out, uploaded = [], []
        with torch.cuda.stream(self._stream):
            for j, a in enumerate(leaves):
                if not isinstance(a, (np.ndarray, torch.Tensor)) or (
                        isinstance(a, torch.Tensor) and a.is_cuda):
                    out.append(a)
                    continue
                h = a.numpy() if isinstance(a, torch.Tensor) else a
                if (bufs[j] is None or tuple(bufs[j].shape) != h.shape
                        or bufs[j].numpy().dtype != h.dtype):
                    bufs[j] = torch.from_numpy(np.empty(h.shape, h.dtype)).pin_memory()
                np.copyto(bufs[j].numpy(), h)
                out.append(bufs[j].to(self.device, non_blocking=True))
                uploaded.append(j)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._staging[k] = (bufs[:len(leaves)], ev)
        return out, tuple(uploaded), ev

    def get(self) -> Optional[tuple]:
        """The oldest in-flight frame, in the structure it was put, ready
        for the caller's current stream (None when nothing is in flight)."""
        if not self._buf:
            return None
        spec, leaves, uploaded, ev = self._buf.popleft()
        if ev is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ev)
            for j in uploaded:
                leaves[j].record_stream(consumer)
        return _unflatten(spec, iter(leaves))

    def __len__(self) -> int:
        return len(self._buf)


def prefetch_to_device(frames, depth: int = 2, device="cuda"):
    """Wrap a frame iterator with ``depth``-deep host-to-device uploads
    (:class:`DeviceFeeder`): frame k+1's upload is issued before frame k is
    yielded, so the upload overlaps the consumer's compute. Yields each
    frame in order, in the structure the iterator gave it, as tensors on
    ``device``; every pipeline takes them as they are."""
    feeder = DeviceFeeder(depth=depth, device=device)
    for arrays in frames:
        feeder.put(*arrays)
        if len(feeder) >= depth:
            yield feeder.get()
    while len(feeder):
        yield feeder.get()
