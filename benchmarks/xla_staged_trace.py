"""Device evidence for staged precision on the XLA path.

The solver routes N > 64 to the XLA path, which runs the same
bf16 -> bf16x3 -> f32 tier schedule as the fused kernel
(ops/precision, models/core._precision_stages). This harness measures,
on the card:

  1. **Per-call tier cost** of the XLA fused step (delta + plain) at
     each precision, from jax.profiler device traces.
  2. **End-to-end fit wall** at N=384/512: kernel_precision="f32"
     (a single exact stage) vs "auto" (staged), same data, same tol.
  3. **Conformance** (--conformance): the staged fit's fixed point vs
     the f64 C++ oracle on the same whitened data at N=384 x 100k
     (Amari < 1e-3 — BASELINE.md accuracy target). Reference anchor:
     core.rs:211-276 (the hot contractions being tiered).

Usage:
    python benchmarks/xla_staged_trace.py [--configs 384:1000000 ...]
        [--reps 2] [--json OUT] [--conformance] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_T0 = time.time()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _measure(fn, args, reps: int) -> float:
    """Per-call device busy time (ms) of ``fn(*args)`` from a profiler
    trace of ``reps`` calls (compiled and warmed outside the trace)."""
    import tempfile

    import jax

    from picard_ica_tpu.utils.profiling import device_trace_summary

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
        summary = device_trace_summary(td)
    return summary["busy_us"] / 1e3 / reps


def _opts(precision: str, plain: bool = False, **kw):
    from picard_ica_tpu.models.core import CoreOptions
    from picard_ica_tpu.ops.densities import Tanh

    defaults = dict(
        density=Tanh(), ortho=True, extended=True, has_cov=True,
        m=7, ls_tries=10, use_pallas=False, kernel_precision=precision,
        plain_ls=plain,
    )
    defaults.update(kw)
    return CoreOptions(**defaults)


def _log(msg: str) -> None:
    print(f"[trace +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _device_normal(n: int, t: int):
    """Standard-normal X generated ON DEVICE (rbg PRNG), not on the host
    and transferred (same rationale as
    utils.datagen.generate_bench_data_device)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _gen():
        key = jax.random.key(0, impl="rbg")
        return jax.random.normal(key, (n, t), dtype=jnp.float32)

    x = _gen()
    jax.block_until_ready(x)
    return x


def step_rows(n: int, t: int, reps: int) -> list:
    """Per-call device ms of the XLA fused step at each precision tier."""
    import jax
    import jax.numpy as jnp

    from picard_ica_tpu.models.core import data_fused_step

    rng = np.random.default_rng(0)
    _log(f"step_rows {n}x{t}: generating X on device")
    x = _device_normal(n, t)
    w_old = jnp.eye(n, dtype=jnp.float32)
    w_new = w_old + jnp.asarray(
        0.01 * rng.standard_normal((n, n)).astype(np.float32))
    jax.block_until_ready(x)
    _log(f"step_rows {n}x{t}: data ready")

    rows = []
    for mode in ("delta", "plain"):
        base_ms = None
        for precision in ("f32", "bf16x3", "bf16"):
            opts = _opts(precision, plain=(mode == "plain"))
            fn = jax.jit(
                lambda mn, mo, xx, o=opts: data_fused_step(
                    mn, mo, xx, o, need_h=False, need_ysq=True))
            _log(f"step_rows {n}x{t} {mode}/{precision}: compile+measure")
            ms = _measure(fn, (w_new, w_old, x), reps)
            if precision == "f32":
                base_ms = ms
            rows.append({
                "kind": "step", "n": n, "t": t, "mode": mode,
                "precision": precision, "device_ms_per_call": ms,
                "speedup_vs_f32": base_ms / ms,
            })
            print(f"N={n} T={t} xla/{mode}/{precision}: {ms:8.2f} ms/call "
                  f"({base_ms / ms:.2f}x vs f32)", file=sys.stderr, flush=True)
    return rows


def fit_rows(n: int, t: int, reps: int, tol: float, max_iter: int) -> list:
    """End-to-end run_core wall: single-stage HIGHEST vs staged auto."""
    import jax
    import jax.numpy as jnp

    from picard_ica_tpu.models.core import run_core_jit
    from picard_ica_tpu.ops.whitening import center_whiten
    from picard_ica_tpu.utils.datagen import generate_bench_data_device
    from picard_ica_tpu.utils.metrics import amari_distance

    _log(f"fit_rows {n}x{t}: device datagen + whiten")
    x_raw = generate_bench_data_device(n, t)
    xw, _, _ = center_whiten(x_raw, n)
    jax.block_until_ready(xw)
    del x_raw
    _log(f"fit_rows {n}x{t}: data ready")
    cov = jnp.eye(n, dtype=jnp.float32)

    rows = []
    w_by_precision = {}
    for precision in ("f32", "auto"):
        opts = _opts(precision)
        _log(f"fit_rows {n}x{t}/{precision}: compile+warm")
        res = run_core_jit(xw, cov, tol, 0.01, max_iter, opts)
        jax.block_until_ready(res)  # compile + warm
        _log(f"fit_rows {n}x{t}/{precision}: warm done")
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            res = run_core_jit(xw, cov, tol, 0.01, max_iter, opts)
            jax.block_until_ready(res)
            wall = time.perf_counter() - t0
            best = wall if best is None else min(best, wall)
        iters = int(res.n_iterations)
        w_by_precision[precision] = np.asarray(res.w)
        rows.append({
            "kind": "fit", "n": n, "t": t, "precision": precision,
            "wall_s": best, "iters": iters,
            "ls_calls": int(res.ls_calls),
            "stage_exits": [int(v) for v in np.asarray(res.stage_exits)],
            "stage_ls_calls": [int(v) for v in np.asarray(res.stage_ls_calls)],
            "converged": bool(res.converged),
            "gradient_norm": float(res.gradient_norm),
            "samples_per_s": t * iters / best,
        })
        r = rows[-1]
        print(f"N={n} T={t} fit/{precision}: {best:6.2f} s, {iters} iters "
              f"({r['ls_calls']} ls calls), gnorm {r['gradient_norm']:.1e}, "
              f"converged={r['converged']}", file=sys.stderr, flush=True)
    speed = rows[-2]["wall_s"] / rows[-1]["wall_s"]
    basin = amari_distance(
        w_by_precision["auto"], np.linalg.pinv(w_by_precision["f32"]))
    rows.append({
        "kind": "fit_summary", "n": n, "t": t,
        "speedup_auto_vs_f32": speed,
        "amari_auto_vs_f32": float(basin),
    })
    print(f"N={n} T={t} SPEEDUP auto vs f32: {speed:.2f}x "
          f"(amari between fixed points {basin:.2e})",
          file=sys.stderr, flush=True)
    return rows


def floor_rows(n: int, t: int, max_iter: int) -> list:
    """Pinned-tier gradient-norm floors at this (n, t) — the numbers
    that calibrate the staged schedule's handoff thresholds (the
    committed N=64 floors do not transfer: the Frobenius norm of a
    fixed per-entry moment noise grows ~N)."""
    import jax
    import jax.numpy as jnp

    from picard_ica_tpu.models.core import run_core_jit
    from picard_ica_tpu.ops.whitening import center_whiten
    from picard_ica_tpu.utils.datagen import generate_bench_data_device

    _log(f"floor_rows {n}x{t}: device datagen + whiten")
    x_raw = generate_bench_data_device(n, t)
    xw, _, _ = center_whiten(x_raw, n)
    jax.block_until_ready(xw)
    del x_raw
    cov = jnp.eye(n, dtype=jnp.float32)

    rows = []
    for precision in ("bf16", "bf16x3"):
        # Pinned tier, unreachable tol: the fit runs to max_iter and
        # the final gradient norm IS the tier's floor on this data.
        opts = _opts(precision)
        _log(f"floor_rows {n}x{t}/{precision}: compile+run")
        res = run_core_jit(xw, cov, 1e-12, 0.01, max_iter, opts)
        jax.block_until_ready(res)
        rows.append({
            "kind": "floor", "n": n, "t": t, "precision": precision,
            "gradient_norm_floor": float(res.gradient_norm),
            "iters": int(res.n_iterations),
            "ls_calls": int(res.ls_calls),
        })
        print(f"N={n} T={t} floor/{precision}: gnorm "
              f"{rows[-1]['gradient_norm_floor']:.2e} after "
              f"{rows[-1]['iters']} iters", file=sys.stderr, flush=True)
    return rows


def conformance_row(n: int = 384, t: int = 100_000) -> dict:
    """Staged XLA fit vs the f64 C++ oracle on the same whitened data."""
    from benchmarks.suite import _oracle_core_cached
    from picard_ica_tpu import Picard, PicardConfig, native
    from picard_ica_tpu.utils.datagen import generate_bench_data
    from picard_ica_tpu.utils.metrics import amari_distance

    if not native.available():
        return {"kind": "conformance", "skipped": "oracle unavailable"}

    x64 = np.asarray(generate_bench_data(n, t, seed=42), np.float64)
    xc, _ = native.oracle_center(x64)
    xw, k_o = native.oracle_whiten(xc, n)
    t0 = time.perf_counter()
    res_o = _oracle_core_cached(
        xw, np.eye(n), ortho=True, extended=True, max_iter=500, tol=1e-7)
    oracle_s = time.perf_counter() - t0
    w_full_oracle = res_o["w"] @ k_o

    cfg = PicardConfig(tol=1e-7, max_iter=500, w_init=np.eye(n),
                       use_pallas=False, kernel_precision="auto")
    res = Picard.fit(x64, cfg)
    amari = amari_distance(
        np.asarray(res.full_unmixing()), np.linalg.pinv(w_full_oracle))
    row = {
        "kind": "conformance", "n": n, "t": t,
        "amari_vs_oracle": float(amari), "target": 1e-3,
        "pass": bool(amari < 1e-3),
        "iters": res.n_iterations, "oracle_iters": res_o["n_iterations"],
        "stage_exits": list(res.stage_exits),
        "oracle_wall_s": oracle_s,
    }
    print(f"conformance N={n} T={t}: amari={amari:.2e} "
          f"({'PASS' if row['pass'] else 'FAIL'})", file=sys.stderr, flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+",
                    default=["384:1000000", "512:1000000"], help="N:T pairs")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--max-iter", type=int, default=100)
    ap.add_argument("--json", default=None)
    ap.add_argument("--skip-steps", action="store_true")
    ap.add_argument("--skip-fits", action="store_true")
    ap.add_argument("--floors", action="store_true")
    ap.add_argument("--conformance", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from picard_ica_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"backend: {dev.platform} ({dev.device_kind})", file=sys.stderr)

    rows = []

    def _flush():
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"backend": dev.platform,
                           "device_kind": dev.device_kind, "rows": rows},
                          f, indent=2)

    for spec in args.configs:
        n, t = (int(v) for v in spec.split(":"))
        if not args.skip_steps:
            rows.extend(step_rows(n, t, args.reps))
            _flush()
        if args.floors:
            rows.extend(floor_rows(n, t, min(args.max_iter, 40)))
            _flush()
        if not args.skip_fits:
            rows.extend(fit_rows(n, t, args.reps, args.tol, args.max_iter))
            _flush()
    if args.conformance:
        rows.append(conformance_row())
        _flush()

    if not args.json:
        json.dump({"backend": dev.platform, "device_kind": dev.device_kind,
                   "rows": rows}, sys.stdout, indent=2)
        print()


if __name__ == "__main__":
    main()
