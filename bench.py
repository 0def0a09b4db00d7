"""Benchmark: grad-loop throughput of the Picard core loop on the GPU.

Prints exactly one JSON line on stdout when it measured something:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "platform": "gpu", "device_kind": "...", "device_count": N,
   "n": N, "t": N, "iterations": N}

Methodology: generate the benchmark mixture ON DEVICE (the reference
harness's distributions, benches/benchmarks.rs:8-35: Laplace sources
and the bit-exact reference LCG mixing block — see
utils.datagen.generate_bench_data_device), whiten on device, then time
the jitted core optimizer to convergence (compiled and warmed before
the window) and report ``T * n_iterations / wall_time`` — grad-loop
samples/s/chip, the BASELINE.json headline metric. Each iteration
includes the moment pass, L-BFGS direction, and matrix-exponential line
search (reference hot loop: core.rs:211-391). The data pass takes the
route the solver takes (solver._kernel_route).

The reference publishes no absolute numbers (BASELINE.md), so
``vs_baseline`` is the speedup over a NumPy f64 CPU execution of the
same per-iteration data-axis work measured in the same run — a
stand-in for the reference's BLAS-backed CPU hot loop.

Exit status: 0 only when a measurement on the GPU completed. The run
exits non-zero, printing no JSON line, when it finds no GPU or measured
nothing. ``PICARD_BENCH_PLATFORM=cpu`` is the one override: it runs
the same pipeline on the CPU backend for rehearsals and tests, and its
record says ``"platform": "cpu"``.

Robustness: a SIGTERM or the self-deadline emits the best measurement
taken so far in this run (a seed measurement at a smaller T comes
first, and the record names the T it measured), and a heartbeat logs
silent phases on stderr.

Config: Picard-O + extended + tanh at N=64, T=4M (BASELINE.json
configs 2/3 scale).

Environment hooks (all default off):
  PICARD_BENCH_PLATFORM      run on this JAX platform instead of
                             requiring the GPU (e.g. "cpu")
  PICARD_BENCH_TEST_STALL_S  sleep this long before the first device
                             op (stall injection for the tests)
  PICARD_BENCH_DEADLINE_S    override the 570 s self-deadline
  PICARD_BENCH_BUDGET_S      override the 520 s measurement budget
  PICARD_BENCH_N/T/SEED_T/REPS   shrink the config to toy scale
  PICARD_BENCH_SEED          datagen stream seed (default 42)
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback

import numpy as np

N_COMPONENTS = int(os.environ.get("PICARD_BENCH_N", "64"))
# 4M samples: ~1 GB of f32 data, a realistic long recording (an hour
# of 64-channel EEG at 1 kHz); converges to tol=1e-7 in ~30 iterations.
N_SAMPLES = int(os.environ.get("PICARD_BENCH_T", "4000000"))
# The early seed measurement's sample count.
SEED_SAMPLES = int(os.environ.get("PICARD_BENCH_SEED_T", "1000000"))
TOL = 1e-7  # the reference tolerance: achievable in f32 thanks to the
# delta-based line search + partial sums with tree reduction
MAX_ITER = 100
REPS = int(os.environ.get("PICARD_BENCH_REPS", "3"))
METRIC = "grad_loop_samples_per_sec_per_chip"

_T0 = time.time()
_BUDGET_S = float(os.environ.get("PICARD_BENCH_BUDGET_S", "520"))
_DEADLINE_S = float(os.environ.get("PICARD_BENCH_DEADLINE_S", "570"))
_BEST: dict = {}
_DEVICE: dict = {}

# [timestamp of last log line, text of last non-heartbeat line] — the
# heartbeat thread reads this to attribute silent phases.
_LAST_LOG = [time.time(), "startup"]


def _log(msg: str) -> None:
    _LAST_LOG[0] = time.time()
    if not msg.startswith("heartbeat"):
        _LAST_LOG[1] = msg.split("\n", 1)[0][:120]
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


_EMITTED = False
_EMIT_LOCK = threading.Lock()


def _emit() -> int:
    """Print the result JSON — at most once per process — and return
    the exit status: 0 with a record of an in-run measurement, 1 when
    nothing was measured (no line is printed then). The lock + flag
    keep the 'at most one JSON line' contract when the deadline thread
    fires concurrently with a normal exit."""
    global _EMITTED
    with _EMIT_LOCK:
        if _EMITTED:
            return 0 if _BEST else 1
        _EMITTED = True
        if not _BEST:
            _log("no measurement completed; no record")
            return 1
        rec = {
            "metric": METRIC,
            "value": _BEST["sps"],
            "unit": "samples/s/chip",
            "vs_baseline": _BEST["sps"] / _BEST["cpu_sps"]
            if _BEST.get("cpu_sps") else None,
            **_DEVICE,
            "n": _BEST["n"],
            "t": _BEST["t"],
            "iterations": _BEST["iters"],
        }
        print(json.dumps(rec), flush=True)
        return 0


def _emit_and_exit(reason: str):  # pragma: no cover - timeout paths
    """Shared exit path for SIGTERM and the self-deadline thread."""
    _log(f"{reason}; emitting the best measurement of this run")
    os._exit(_emit())


def _start_deadline_timer() -> "threading.Timer":
    """A daemon timer, so that the deadline fires even while the main
    thread blocks inside a runtime call that holds no Python frame."""
    timer = threading.Timer(
        _DEADLINE_S, _emit_and_exit,
        args=(f"{_DEADLINE_S:.0f}s self-deadline reached",),
    )
    timer.daemon = True
    timer.start()
    return timer


def _start_heartbeat() -> threading.Event:
    """Log every ~15 s while no other line has printed. Returns a stop
    event owned by this run (a shared flag would leak threads between
    in-process test runs)."""
    stop = threading.Event()

    def beat():
        while not stop.wait(5.0):
            quiet = time.time() - _LAST_LOG[0]
            if quiet >= 15.0:
                _log(f"heartbeat: still in '{_LAST_LOG[1]}' "
                     f"({quiet:.0f}s since last line)")
    threading.Thread(target=beat, daemon=True).start()
    return stop


def _jax():
    """Import jax, applying the platform override before any backend
    initializes."""
    import jax

    plat = os.environ.get("PICARD_BENCH_PLATFORM")
    if plat and not getattr(_jax, "_platform_set", False):
        jax.config.update("jax_platforms", plat)
        _jax._platform_set = True
    return jax


def _open_device() -> None:
    """Open the device and record what it is; refuse anything but the
    GPU unless the platform override asks for another backend."""
    stall = float(os.environ.get("PICARD_BENCH_TEST_STALL_S", "0") or 0.0)
    if stall:  # test-only stall injection (docstring at top)
        _log(f"device-open: injected test stall of {stall:.0f}s")
        time.sleep(stall)
    jax = _jax()
    dev = jax.devices()[0]
    wanted = os.environ.get("PICARD_BENCH_PLATFORM") or "gpu"
    if dev.platform != wanted:
        raise RuntimeError(
            f"bench.py measures the GPU; found {dev.platform} "
            f"({dev.device_kind}). Set PICARD_BENCH_PLATFORM=cpu only "
            f"for a CPU rehearsal."
        )
    _DEVICE.update(platform=dev.platform, device_kind=dev.device_kind,
                   device_count=len(jax.devices()))
    _log(f"device: {_DEVICE}")


def _choose_full_t(remaining_s: float) -> int | None:
    """Budget-aware shrink: pick the full-config T from the measurement
    budget left after the seed run. None = keep the seed measurement."""
    if remaining_s >= 240:
        return N_SAMPLES
    if remaining_s >= 120:
        return min(N_SAMPLES, 2_000_000)
    if remaining_s >= 60:
        return min(N_SAMPLES, 1_000_000)
    return None


def _measure_config(n: int, t: int, reps: int, tag: str = "") -> tuple:
    """datagen → whiten → core compile+warm → timed reps at (n, t).

    Updates the module-level best-so-far record ``_BEST`` with each
    timed rep (compilation stays outside every timed window)."""
    jax = _jax()
    import jax.numpy as jnp

    from picard_ica_tpu.models.core import CoreOptions, run_core_jit
    from picard_ica_tpu.ops.densities import Tanh
    from picard_ica_tpu.ops.whitening import center_whiten
    from picard_ica_tpu.solver import _kernel_route
    from picard_ica_tpu.utils.datagen import generate_bench_data_device

    seed = int(os.environ.get("PICARD_BENCH_SEED", "42"))
    t0 = time.time()
    _log(f"{tag}datagen: generating {n}x{t} Laplace mixture on device "
         f"(seed {seed})")
    x = generate_bench_data_device(n, t, seed=seed)
    jax.block_until_ready(x)
    _log(f"{tag}datagen: done in {time.time() - t0:.1f}s")
    t0 = time.time()
    xw, _, _ = center_whiten(x, n)
    jax.block_until_ready(xw)
    _log(f"{tag}center+whiten done in {time.time() - t0:.1f}s")
    del x

    opts = CoreOptions(
        density=Tanh(), ortho=True, extended=True, has_cov=True, m=7, ls_tries=10,
        use_pallas=_kernel_route(n, jnp.float32), kernel_precision="auto",
    )
    cov = jnp.eye(n, dtype=jnp.float32)

    def run():
        return run_core_jit(xw, cov, TOL, 0.01, MAX_ITER, opts)

    t0 = time.time()
    result = run()
    jax.block_until_ready(result)  # compile + warm
    _log(f"{tag}core compile+warm run done in {time.time() - t0:.1f}s "
         f"(kernel={opts.use_pallas}, {int(result.n_iterations)} iters, "
         f"stage_exits={[int(v) for v in result.stage_exits]}, "
         f"stage_ls_calls={[int(v) for v in result.stage_ls_calls]})")
    if not bool(result.converged):
        _log(f"warning: did not reach tol={TOL} "
             f"(gnorm={float(result.gradient_norm):.2e})")

    best_sps, best_iters = 0.0, 0
    for rep in range(reps):
        if time.time() - _T0 > _BUDGET_S:
            _log(f"budget {_BUDGET_S:.0f}s reached after {rep} reps; stopping")
            break
        t0 = time.perf_counter()
        result = run()
        jax.block_until_ready(result)
        elapsed = time.perf_counter() - t0
        iters = int(result.n_iterations)
        sps = t * iters / elapsed
        _log(f"{tag}rep {rep}: {sps:.3e} samples/s ({iters} iters, {elapsed:.3f}s)")
        if sps > best_sps:
            best_sps, best_iters = sps, iters
        # A full-size measurement replaces the seed's, whatever its rate.
        if t > _BEST.get("t", 0) or sps > _BEST.get("sps", 0.0):
            _BEST.update(sps=sps, iters=iters, n=n, t=t)
    return best_sps, best_iters


def _cpu_numpy_samples_per_sec() -> float:
    """NumPy f64 mirror of one grad-loop iteration's data-axis work:
    score+derivative, gradient moment, E[psi'], plus one line-search
    try (rotate + log-lik) — the ops the reference executes per
    iteration on CPU BLAS (core.rs:215-227, 124-127)."""
    n, t = N_COMPONENTS, min(N_SAMPLES, 200_000)  # keep CPU timing sane
    rng = np.random.default_rng(0)
    y = rng.standard_normal((n, t))
    tm = np.eye(n) + 0.01 * rng.standard_normal((n, n))

    def one_iter(y):
        psi = np.tanh(y)
        psi_d = 1.0 - psi * psi
        g = psi @ y.T / t
        pm = psi_d.mean(axis=1)
        y_new = tm @ y
        abs_y = np.abs(y_new)
        ll = abs_y + np.log1p(np.exp(-2.0 * abs_y))
        return g, pm, ll.mean(axis=1)

    one_iter(y)  # warm
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        one_iter(y)
    elapsed = time.perf_counter() - t0
    return t * reps / elapsed


def main() -> int:
    global _EMITTED
    _EMITTED = False  # re-arm: one JSON line per measurement run
    deadline = _start_deadline_timer()
    heartbeat_stop = _start_heartbeat()
    try:
        _open_device()
        from picard_ica_tpu.utils.compile_cache import enable_compile_cache

        _log(f"compile cache: {enable_compile_cache()}")
        # Seed measurement at a smaller T first, so a run cut by the
        # deadline still has a record of its own.
        seed_t = min(SEED_SAMPLES, N_SAMPLES)
        sps, iters = _measure_config(N_COMPONENTS, seed_t, reps=1, tag="seed-")
        _log(f"seed measurement: {sps:.3e} samples/s ({iters} iters at T={seed_t})")
        remaining = _BUDGET_S - (time.time() - _T0)
        full_t = _choose_full_t(remaining)
        if full_t is None:
            _log(f"{remaining:.0f}s of budget left; keeping the seed measurement")
        else:
            if full_t < N_SAMPLES:
                _log(f"{remaining:.0f}s of budget left; shrinking full config "
                     f"to T={full_t}")
            _measure_config(N_COMPONENTS, full_t, reps=REPS, tag="")
    except Exception:
        _log("measurement failed:\n" + traceback.format_exc())

    if _BEST:
        _log("running NumPy f64 CPU baseline")
        _BEST["cpu_sps"] = _cpu_numpy_samples_per_sec()
        _log(
            f"{_DEVICE.get('device_kind')}: {_BEST['sps']:.3e} samples/s/chip "
            f"({_BEST['iters']} iters to tol={TOL} at T={_BEST['t']}) | "
            f"numpy-f64 cpu: {_BEST['cpu_sps']:.3e} samples/s"
        )
    deadline.cancel()
    heartbeat_stop.set()
    return _emit()


if __name__ == "__main__":
    signal.signal(
        signal.SIGTERM, lambda signum, frame: _emit_and_exit(f"signal {signum}")
    )
    sys.exit(main())
