"""Profiling helpers (SURVEY.md §5: the reference's only performance
tooling is criterion wall-clock benches; the equivalents here are
``jax.profiler`` device traces plus throughput summaries).

``profile_fit`` wraps a fit in a profiler trace viewable in
TensorBoard/XProf or parseable from the emitted ``*.trace.json.gz``.
``fit_with_timing`` reports the numbers BASELINE.md tracks: wall time,
iterations to tolerance, and grad-loop samples/s/chip.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import time
from typing import Optional

import jax

from ..config import PicardConfig
from ..solver import Picard


def profile_fit(x, config: Optional[PicardConfig] = None, mesh=None,
                trace_dir: str = "/tmp/picard_trace"):
    """Run ``Picard.fit`` under a jax.profiler trace; returns the result.

    The caller should have warmed the compile cache (run the same shapes
    once before) so the trace shows steady-state device time rather
    than compilation.
    """
    with jax.profiler.trace(trace_dir):
        result = Picard.fit(x, config, mesh=mesh)
        jax.block_until_ready(result.sources)
    return result


_DEVICE_PROCESS = {"gpu": "/device:GPU", "cpu": "/host:CPU"}


def _default_device_substr() -> str:
    import jax

    platform = jax.devices()[0].platform
    if platform not in _DEVICE_PROCESS:
        raise ValueError(f"no trace layout known for platform {platform!r}")
    return _DEVICE_PROCESS[platform]


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def device_trace_summary(trace_dir: str, device_substr: Optional[str] = None,
                         top_k: int = 12) -> dict:
    """Aggregate on-device op time from a ``jax.profiler.trace`` dump.

    Parses the newest ``plugins/profile/*/<host>.trace.json.gz`` under
    ``trace_dir`` and keeps complete ("X") events of the processes
    whose name contains ``device_substr`` — by default the first JAX
    device's: "/device:GPU" (one thread per CUDA stream, events named
    by kernel: XLA fusions, cuBLAS gemms, ``picard_fused_step``) or,
    on the CPU backend, "/host:CPU" (whose "python" thread is the
    host-side caller, not device work, and is skipped). Returns::

        {"total_us": float,      # summed event durations
         "busy_us": float,       # union of the event intervals
         "window_us": float,     # first event start to last event end
         "idle_share": float,    # 1 - busy / window
         "by_op": {name: us},    # per-op totals, descending, top_k
         "trace_path": str}

    ``total_us`` exceeds ``busy_us`` when streams overlap (a copy
    beside a kernel); the idle share is measured on the union.
    """
    if device_substr is None:
        device_substr = _default_device_substr()
    dumps = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.trace.json.gz")))
    if not dumps:
        raise FileNotFoundError(f"no trace dumps under {trace_dir}")
    path = dumps[-1]
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])

    device_pids = set()
    thread_names: dict = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        if ev.get("name") == "process_name":
            pname = str(ev.get("args", {}).get("name", ""))
            if device_substr.lower() in pname.lower():
                device_pids.add(ev.get("pid"))
        elif ev.get("name") == "thread_name":
            thread_names[(ev.get("pid"), ev.get("tid"))] = str(
                ev.get("args", {}).get("name", ""))

    by_op: dict = {}
    intervals = []
    total = 0.0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("pid") not in device_pids:
            continue
        if thread_names.get((ev.get("pid"), ev.get("tid"))) == "python":
            continue
        dur = float(ev.get("dur", 0.0))
        start = float(ev.get("ts", 0.0))
        total += dur
        intervals.append((start, start + dur))
        name = ev.get("name", "?")
        by_op[name] = by_op.get(name, 0.0) + dur
    busy = _union_us(intervals)
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)
              if intervals else 0.0)
    by_op = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:top_k])
    return {
        "total_us": total,
        "busy_us": busy,
        "window_us": window,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "by_op": by_op,
        "trace_path": path,
    }


def fit_with_timing(x, config: Optional[PicardConfig] = None, mesh=None,
                    reps: int = 3) -> dict:
    """Fit ``reps`` times (after one warm-up) and report throughput.

    Returns a dict with the fitted result plus ``wall_s`` (best of
    reps), ``iterations``, ``samples_per_s`` (T * iterations / wall —
    the grad-loop rate BASELINE.md's headline metric uses, attributing
    the whole wall time to the optimizer loop, i.e. a lower bound) and
    ``samples_per_s_per_chip``.
    """
    result = Picard.fit(x, config, mesh=mesh)
    jax.block_until_ready(result.sources)

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = Picard.fit(x, config, mesh=mesh)
        jax.block_until_ready(result.sources)
        best = min(best, time.perf_counter() - t0)

    t = x.shape[1]
    n_chips = mesh.devices.size if mesh is not None else 1
    sps = t * max(result.n_iterations, 1) / best
    return {
        "result": result,
        "wall_s": best,
        "iterations": result.n_iterations,
        "converged": result.converged,
        "samples_per_s": sps,
        "samples_per_s_per_chip": sps / n_chips,
        "n_chips": n_chips,
    }
