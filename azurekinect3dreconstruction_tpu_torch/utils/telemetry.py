"""Runtime telemetry: frame rate, event counters, gauges and stage timers,
reported at most once per interval, and the ``[INFO]`` / ``[WARNING]`` /
``[ERROR]`` log prefixes the pipelines print with (the counterpart of the
JAX package's ``utils/telemetry.py``)."""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Optional


def log_info(msg: str) -> None:
    print(f"[INFO] {msg}")


def log_warning(msg: str) -> None:
    print(f"[WARNING] {msg}")


def log_error(msg: str) -> None:
    print(f"[ERROR] {msg}")


class Telemetry:
    """Windowed FPS + counters + timers, reported at most once per
    ``report_interval`` seconds through ``sink``."""

    def __init__(self, report_interval: float = 1.0,
                 sink: Optional[Callable[[str], None]] = None, window: int = 120):
        self.report_interval = report_interval
        self.sink = sink or print
        self._frame_times = collections.deque(maxlen=window)
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._timers: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._gauges: Dict[str, float] = {}
        self._last_report = time.perf_counter()
        self.frame_count = 0

    def tick_frame(self) -> None:
        self._frame_times.append(time.perf_counter())
        self.frame_count += 1

    def count(self, name: str, inc: int = 1) -> None:
        self._counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def time_block(self, name: str):
        """``with telemetry.time_block("keyframe"): ...`` records the block's
        host wall time. Work the block enqueues on a card and does not wait
        for is not in it: on a card it measures what the host spends."""
        return _Timer(self, name)

    def record_time(self, name: str, seconds: float) -> None:
        self._timers[name].append(seconds)

    @property
    def fps(self) -> float:
        if len(self._frame_times) < 2:
            return 0.0
        dt = self._frame_times[-1] - self._frame_times[0]
        return (len(self._frame_times) - 1) / dt if dt > 0 else 0.0

    @property
    def counters(self) -> Dict[str, int]:
        """A copy of the event counters."""
        return dict(self._counters)

    def mean_time_ms(self, name: str) -> float:
        t = self._timers.get(name)
        return 1000.0 * sum(t) / len(t) if t else 0.0

    def maybe_report(self, extra: str = "") -> Optional[str]:
        now = time.perf_counter()
        if now - self._last_report < self.report_interval:
            return None
        self._last_report = now
        parts = [f"fps {self.fps:5.1f}", f"frames {self.frame_count}"]
        parts += [f"{k} {v}" for k, v in sorted(self._counters.items())]
        parts += [f"{k} {self.mean_time_ms(k):.1f}ms" for k in sorted(self._timers)]
        parts += [f"{k} {v:.3g}" for k, v in sorted(self._gauges.items())]
        if extra:
            parts.append(extra)
        line = "[INFO] " + " | ".join(parts)
        self.sink(line)
        return line


class _Timer:
    def __init__(self, telemetry: Telemetry, name: str):
        self.telemetry = telemetry
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.telemetry.record_time(self.name, time.perf_counter() - self.t0)
        return False
