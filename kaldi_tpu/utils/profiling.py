"""Tracing/profiling: wall-clock timers, cumulative per-op profile,
NaN/Inf guards, xprof trace capture.

(ref: SURVEY.md §5 — base/timer.h:31 Timer; the CUDA layer's
 CuDevice::AccuProfile/PrintProfile cumulative per-op seconds
 (cudamatrix/cu-device.cc:376-400); decode binaries log per-utterance
 likelihood-per-frame and RTF. Equivalents here: the same host-side
 counters + jax.profiler traces for device-side timelines.)
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Timer:
    """(ref: base/timer.h:31)"""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


class AccuProfiler:
    """Cumulative per-key seconds + counts (ref: CuDevice::AccuProfile)."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def track(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[key] += time.perf_counter() - t0
            self.counts[key] += 1

    def accu(self, key: str, seconds: float):
        self.seconds[key] += seconds
        self.counts[key] += 1

    def report(self, top: int = 20) -> str:
        """(ref: CuDevice::PrintProfile — top-N by cumulative time)."""
        rows = sorted(self.seconds.items(), key=lambda kv: -kv[1])[:top]
        total = sum(self.seconds.values())
        lines = [f"----- profile: total {total:.3f}s -----"]
        for k, s in rows:
            lines.append(f"{k:<40s} {s:9.3f}s  x{self.counts[k]}")
        return "\n".join(lines)


PROFILER = AccuProfiler()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace viewable in xprof/tensorboard."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def check_finite(tree, name: str = "tree"):
    """NaN/Inf guard for pytrees (ref: SURVEY.md §5 race-detection row —
    jax.debug/checkify-style guards on our own programs)."""
    import jax
    import numpy as np
    bad = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        a = np.asarray(leaf)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            bad.append(jax.tree_util.keystr(path))
    if bad:
        raise FloatingPointError(f"{name}: non-finite values at {bad}")
    return tree
