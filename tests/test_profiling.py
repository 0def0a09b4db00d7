"""Profiling utilities (utils/profiling.py).

Device busy time, idle share and per-kernel time all flow through
``device_trace_summary``, so the parser is a measurement path and
needs its own coverage: against a real jax.profiler dump on the CPU
backend, and against a fixture in the schema of a GPU dump (one thread
per CUDA stream under "/device:GPU:0").
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from picard_ica_tpu.utils.profiling import device_trace_summary, fit_with_timing


def test_device_trace_summary_parses_cpu_trace(tmp_path):
    x = jnp.asarray(np.random.default_rng(0).standard_normal((128, 128)))
    f = jax.jit(lambda a: jnp.tanh(a @ a.T).sum())
    jax.block_until_ready(f(x))  # compile outside the trace
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(f(x))
    s = device_trace_summary(str(tmp_path), device_substr="CPU")
    assert s["total_us"] > 0.0
    assert s["by_op"]  # at least one aggregated op
    assert all(v > 0 for v in s["by_op"].values())
    # per-op totals are a partition of the total (truncation to top_k
    # can only drop mass, never add it)
    assert sum(s["by_op"].values()) <= s["total_us"] + 1e-6


def test_device_trace_summary_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        device_trace_summary(str(tmp_path / "nope"))


def test_device_trace_summary_skips_module_aggregate_track(tmp_path):
    """A GPU dump puts kernels on one thread per CUDA stream of the
    "/device:GPU:0" process, and host-side spans (the "python" caller
    track, aggregate jit spans) on "/host:CPU". Only device events may
    count; overlapping streams count once in the busy time. Synthetic
    fixture in the schema of a real H100 dump."""
    import gzip
    import json
    import os

    events = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 1, "tid": 13, "name": "thread_name",
         "args": {"name": "Stream #13(MemcpyD2D,Compute,Memset,MemcpyD2H)"}},
        {"ph": "M", "pid": 1, "tid": 14, "name": "thread_name",
         "args": {"name": "Stream #14(MemcpyH2D)"}},
        {"ph": "M", "pid": 701, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 701, "tid": 9, "name": "thread_name",
         "args": {"name": "python"}},
        # Two kernels of 60 + 20 us with a 20 us gap, and a copy on a
        # second stream overlapping the first kernel by 10 us.
        {"ph": "X", "pid": 1, "tid": 13, "name": "picard_fused_step",
         "ts": 0, "dur": 60.0},
        {"ph": "X", "pid": 1, "tid": 13, "name": "loop_add_fusion",
         "ts": 80, "dur": 20.0},
        {"ph": "X", "pid": 1, "tid": 14, "name": "MemcpyH2D",
         "ts": 50, "dur": 10.0},
        # Host-side wall span that must never count as device time.
        {"ph": "X", "pid": 701, "tid": 9, "name": "jit_f", "ts": 0,
         "dur": 5000.0},
    ]
    d = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    os.makedirs(d)
    with gzip.open(d / "vm.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)

    s = device_trace_summary(str(tmp_path), device_substr="/device:GPU")
    assert s["total_us"] == pytest.approx(90.0)
    assert s["busy_us"] == pytest.approx(80.0)
    assert s["window_us"] == pytest.approx(100.0)
    assert s["idle_share"] == pytest.approx(0.2)
    assert s["by_op"] == {"picard_fused_step": pytest.approx(60.0),
                          "loop_add_fusion": pytest.approx(20.0),
                          "MemcpyH2D": pytest.approx(10.0)}
    # The default device comes from jax.devices()[0]: the CPU backend
    # here, whose process holds no event of this fixture.
    assert device_trace_summary(str(tmp_path))["total_us"] == 0.0


def test_fit_with_timing_reports_throughput():
    from picard_ica_tpu import PicardConfig
    from picard_ica_tpu.utils import generate_test_data

    _, _, x = generate_test_data(4, 20_000, 3)
    out = fit_with_timing(x, PicardConfig(random_state=0, tol=1e-5), reps=1)
    assert out["converged"]
    assert out["samples_per_s"] > 0
    assert out["n_chips"] == 1
