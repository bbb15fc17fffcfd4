"""Profiler traces and their reduction to device metrics.

The reference's only GPU timing is a TimerQuery around the atmosphere pass
(src/Render/Objects/TimerQuery.cs, src/Render/AtmosphericScatterer.cs:65);
frame rate lives in the window title.  Here:

  * :func:`trace` — context manager around ``jax.profiler`` producing a
    trace directory (op-level device timeline, TensorBoard/xprof-loadable);
  * :func:`device_activity` — the device's busy time, idle share and
    largest gaps over a traced window, plus the kernels that took the time;
  * :func:`require_gpu` and :func:`card_line` — what every measurement
    script checks first and prints beside its numbers.
"""

from __future__ import annotations

import contextlib
import glob
import os
import subprocess
import sys


def require_gpu(program: str):
    """The first JAX device if it is a GPU; otherwise print why to stderr
    and exit non-zero.  Measurement scripts call this first: a number taken
    on the CPU is never reported under a device metric."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"{program}: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        raise SystemExit(2)
    return dev


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block: ``with profiling.trace(d): run()``."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def _union(intervals):
    """Merge [start, end) intervals; returns the merged, sorted list."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_activity(log_dir: str, top: int = 8, min_gap_us: float = 20.0):
    """Reduce the newest ``.xplane.pb`` under ``log_dir`` to device metrics.

    Device planes are those named ``/device:GPU:<n>``.  Busy time is the
    union of their events' intervals over the window from the first event's
    start to the last event's end; idle share is 1 - busy / window.
    Returns a dict with ``window_ms``, ``busy_ms``, ``idle_share``,
    ``n_events``, ``n_gaps`` (gaps longer than ``min_gap_us``),
    ``largest_gaps_us`` and ``top_kernels`` [(name, total ms, count)]."""
    import jax

    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    intervals = []
    per_kernel = {}
    names = [plane.name for plane in data.planes]
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                s, d = ev.start_ns, ev.duration_ns
                intervals.append((s, s + d))
                tot, cnt = per_kernel.get(ev.name, (0.0, 0))
                per_kernel[ev.name] = (tot + d, cnt + 1)
    if not intervals:
        raise ValueError(f"no device events in {paths[-1]} (planes: "
                         f"{names})")
    merged = _union(intervals)
    window = merged[-1][1] - merged[0][0]
    busy = sum(e - s for s, e in merged)
    gaps = [b[0] - a[1] for a, b in zip(merged, merged[1:])]
    gaps = sorted((g for g in gaps if g > min_gap_us * 1e3), reverse=True)
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "n_events": len(intervals),
        "n_gaps": len(gaps),
        "largest_gaps_us": [g / 1e3 for g in gaps[:top]],
        "top_kernels": [(name[:80], tot / 1e6, cnt)
                        for name, (tot, cnt) in kernels],
    }
