"""Smoke test of the whole system on the GPU, through its public entry points.

    python chip_smoke.py           # one card: phases 1-6 below
    python chip_smoke.py --four    # four cards: the sample-sharded fit only

One card, one process (a JAX process reserves most of a card's memory,
so nothing here starts a second one). Phases, each printing its own
line; any failure exits non-zero:

  1. device     the GPU, JAX version, XLA_FLAGS, compile cache, and the
                card's name and power limit from nvidia-smi.
  2. headline   Picard-O + extended + tanh at 64 x 4,000,000, tol 1e-7,
                whitened on the device (about an hour of 64-channel EEG
                at 1 kHz): warm-up, two timed fits, and the same fit
                with single-stage exact-f32 dots on the XLA path as the
                reference, from the same w_init.
  3. oracle     BASELINE config 1 (8 x 10k, tanh) in float64 on the
                card against the C++ f64 oracle (picard_ica_tpu/native),
                ortho and non-ortho.
  4. coverage   32 x 100k fits with each density, ortho and non-ortho,
                and the JADE and FastICA warm starts, each against the
                single-stage f32 XLA fit of the same configuration.
  5. kernels    the fused Triton kernel at 64 x 4M and 48 x 1M (padded
                to 64 rows) against the XLA formulation at every
                precision tier, whole-fit times with and without it, and
                each tier's time per pass and gradient-norm floor at
                64 x 1M. (N > 64 takes the XLA path: see
                ops/pallas_kernels.MAX_N.)
  6. tests      the tests marked ``gpu``, in this same process.

With ``--four`` only the multi-card path runs: BASELINE config 5
(256 x 10M, extended + ortho, tanh) sharded over a 4-card sample mesh
against the same fit on card 0 alone.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Amari distance allowed between the fit under test and its reference.
# Headline: both fits converge to gnorm < 1e-7 at the same fixed point,
# so their unmixings differ by the f32 gradient noise at the optimum.
HEADLINE_AMARI = 1e-5
# Oracle lockstep bounds of tests/test_native.py.
ORACLE_AMARI = 1e-9
ORACLE_FORK = {True: 2, False: 8}
# Coverage: the same basin at tol 1e-6 (BASELINE's agreement bound).
COVERAGE_AMARI = 1e-3
FOUR_AMARI = 1e-4
# The four-card fits run at tol 1e-7; if the sharded fit stops short
# of it, the stated tol is 1e-6 (the single-card fit at 1e-7 meets it).
FOUR_TOLS = (1e-7, 1e-6)


def log(msg: str) -> None:
    print(msg, flush=True)


def _block(*arrays):
    import jax

    jax.block_until_ready(arrays)


def card_line() -> str:
    """The card's name and power limit, read by a child process that
    does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def _amari_between(w_a, w_b) -> float:
    """Amari distance between two square unmixings of the same data."""
    from picard_ica_tpu.utils.metrics import amari_distance

    return float(amari_distance(np.asarray(w_a, np.float64),
                                np.linalg.inv(np.asarray(w_b, np.float64))))


def _reference_config(cfg):
    """The plain reference of a fit: single-stage exact-f32 dots on the
    XLA path, everything else (w_init included) unchanged."""
    return dataclasses.replace(cfg, kernel_precision="f32", use_pallas=False)


def _timed_fit(x, cfg, mesh=None):
    from picard_ica_tpu import Picard

    t0 = time.perf_counter()
    r = Picard.fit_with_config(x, cfg, mesh=mesh)
    _block(r.sources, r.unmixing)
    return r, time.perf_counter() - t0


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_device(expect_platform: str = "gpu") -> dict:
    import jax

    from picard_ica_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != expect_platform:
        raise RuntimeError(f"expected a {expect_platform} device, found "
                           f"{dev.platform} ({dev.device_kind})")
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    log(f"[device] {info} jax {jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={enable_compile_cache()}")
    return info


def phase_headline(n: int = 64, t: int = 4_000_000, reps: int = 2) -> dict:
    import jax

    from picard_ica_tpu import PicardConfig
    from picard_ica_tpu.solver import _kernel_route
    from picard_ica_tpu.utils import memory_model
    from picard_ica_tpu.utils.datagen import (
        generate_bench_data_device,
        reference_mixing_matrix,
    )
    from picard_ica_tpu.utils.metrics import amari_distance

    x = generate_bench_data_device(n, t, seed=42)
    _block(x)
    stats = jax.devices()[0].memory_stats() or {}
    peak_datagen = stats.get("peak_bytes_in_use")
    cfg = PicardConfig(ortho=True, extended=True, tol=1e-7, max_iter=100,
                       random_state=0)
    r, compile_s = _timed_fit(x, cfg)  # warm-up: compiles
    walls = []
    for _ in range(reps):
        r, wall = _timed_fit(x, cfg)
        walls.append(wall)
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    kernel = _kernel_route(n, np.float32)
    model = memory_model.fit_peak_bytes(n, t, use_pallas=kernel)
    wall = min(walls)
    log(f"[headline] {n}x{t} kernel={kernel} walls_s={walls} "
        f"warmup_s={compile_s:.3f} iterations={r.n_iterations} "
        f"stage_exits={r.stage_exits} ls_calls={r.ls_calls} "
        f"converged={r.converged} gnorm={r.gradient_norm:.3e} "
        f"fit_samples_per_s={t * r.n_iterations / wall:.4e}")
    log(f"[headline] peak_bytes_in_use={peak} (after datagen alone "
        f"{peak_datagen}) model_peak_bytes={model} "
        f"bytes_limit={stats.get('bytes_limit')}")

    ref, ref_wall = _timed_fit(x, _reference_config(cfg))
    ref, ref_wall = _timed_fit(x, _reference_config(cfg))
    am = _amari_between(r.full_unmixing(), ref.full_unmixing())
    truth = reference_mixing_matrix(n, t, 42)
    am_true = amari_distance(np.asarray(r.full_unmixing(), np.float64), truth)
    log(f"[headline] reference(f32 single-stage, XLA) wall_s={ref_wall:.3f} "
        f"iterations={ref.n_iterations} converged={ref.converged} "
        f"amari(fit, reference)={am:.3e} amari(fit, true mixing)={am_true:.3e}")
    if not (r.converged and ref.converged):
        raise AssertionError("headline fit or its reference did not converge")
    if not am <= HEADLINE_AMARI:
        raise AssertionError(f"headline amari {am:.3e} > {HEADLINE_AMARI}")
    return {"wall_s": wall, "iterations": r.n_iterations, "peak": peak}


def phase_oracle(n: int = 8, t: int = 10_000) -> None:
    import jax.numpy as jnp

    from picard_ica_tpu import native
    from picard_ica_tpu.models.core import CoreOptions, run_core_jit
    from picard_ica_tpu.ops.densities import Tanh
    from picard_ica_tpu.utils.datagen import generate_bench_data

    if not native.available():
        raise RuntimeError("the C++ oracle did not build (g++)")
    x = generate_bench_data(n, t, seed=42)
    xc, _ = native.oracle_center(x)
    xw, _ = native.oracle_whiten(xc, n)
    for ortho in (True, False):
        extended = ortho  # the reference's default (config.rs:99-101)
        res_o = native.oracle_core(
            xw, np.eye(n) if extended else None, density="tanh",
            ortho=ortho, extended=extended, max_iter=300, tol=1e-7,
        )
        opts = CoreOptions(density=Tanh(), ortho=ortho, extended=extended,
                           has_cov=extended, m=7, ls_tries=10)
        xd = jnp.asarray(xw, jnp.float64)
        cov = (jnp.eye(n, dtype=jnp.float64) if extended
               else jnp.zeros((n, n), jnp.float64))
        res_j = run_core_jit(xd, cov, 1e-7, 0.01, 300, opts)
        platform = next(iter(res_j.w.devices())).platform
        am = _amari_between(res_o["w"], res_j.w)
        fork = abs(res_o["n_iterations"] - int(res_j.n_iterations))
        log(f"[oracle] ortho={ortho} dtype={res_j.w.dtype} on {platform}: "
            f"amari={am:.3e} iterations oracle={res_o['n_iterations']} "
            f"jax={int(res_j.n_iterations)} fork={fork}")
        if res_j.w.dtype != jnp.float64:
            raise AssertionError("oracle phase must run in float64")
        if not (res_o["converged"] and bool(res_j.converged)):
            raise AssertionError("oracle or device fit did not converge")
        if not am < ORACLE_AMARI or fork > ORACLE_FORK[ortho]:
            raise AssertionError(f"oracle lockstep broken: amari={am:.3e} "
                                 f"fork={fork}")


def _uniform_mixture(n, t, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-np.sqrt(3.0), np.sqrt(3.0), size=(n, t))
    return rng.standard_normal((n, n)) @ s


def coverage_cases():
    """(label, data kind, config overrides) of the coverage phase."""
    from picard_ica_tpu.ops.densities import Cube, Exp, Tanh

    return [
        ("tanh-ortho-ext", "mixed", dict(density=Tanh(), ortho=True)),
        ("tanh-nonortho", "laplace", dict(density=Tanh(), ortho=False)),
        ("exp-ortho", "laplace", dict(density=Exp(), ortho=True, extended=False)),
        # extended: exp non-ortho without it diverges to a NaN gradient
        # on every mixture tried, on the CPU too (ROADMAP).
        ("exp-nonortho-ext", "laplace",
         dict(density=Exp(), ortho=False, extended=True)),
        ("cube-ortho", "uniform", dict(density=Cube(), ortho=True, extended=False)),
        ("cube-nonortho", "uniform", dict(density=Cube(), ortho=False)),
        ("jade-tanh", "laplace", dict(density=Tanh(), ortho=True, jade_it=50)),
        ("fastica-tanh", "laplace", dict(density=Tanh(), ortho=True, fastica_it=10)),
    ]


def phase_coverage(n: int = 32, t: int = 100_000, use_pallas=None) -> None:
    from picard_ica_tpu import PicardConfig
    from picard_ica_tpu.utils.datagen import (
        generate_mixed_kurtosis_data,
        generate_test_data,
    )

    data = {
        "laplace": generate_test_data(n, t, 7)[2],
        "mixed": generate_mixed_kurtosis_data(n, t, 8)[2],
        "uniform": _uniform_mixture(n, t, 9),
    }
    failures = []
    for label, kind, kw in coverage_cases():
        x = data[kind].astype(np.float32)
        cfg = PicardConfig(tol=1e-6, max_iter=500, random_state=0,
                           use_pallas=use_pallas, **kw)
        r, wall = _timed_fit(x, cfg)
        ref, _ = _timed_fit(x, _reference_config(cfg))
        am = _amari_between(r.full_unmixing(), ref.full_unmixing())
        ok = r.converged and ref.converged and am <= COVERAGE_AMARI
        log(f"[coverage] {label} {n}x{t}: converged={r.converged}/"
            f"{ref.converged} iterations={r.n_iterations}/{ref.n_iterations} "
            f"stages={r.stage_exits} amari(fit, reference)={am:.3e} "
            f"wall_s={wall:.3f} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError(f"coverage failures: {failures}")


# Tier -> (relative bound on the moments, absolute bound on the per-row
# loss-delta means) of the kernel against the XLA formulation. Both run
# the same dot algorithm; they differ in summation order and in how
# often bf16 operands are rounded.
_TIER_BOUNDS = {"f32": (1e-4, 1e-6), "bf16x3": (1e-3, 1e-5),
                "bf16": (3e-2, 3e-3)}
_TIER_MODES = [("f32", False), ("bf16x3", False), ("bf16", True)]


def _kernel_vs_xla(n, t, reps=10, interpret=False):
    import jax
    import jax.numpy as jnp

    from picard_ica_tpu.models.core import CoreOptions, data_fused_step
    from picard_ica_tpu.ops.densities import Tanh
    from picard_ica_tpu.ops.pallas_kernels import rotated_fused_sums
    from picard_ica_tpu.ops.whitening import center_whiten
    from picard_ica_tpu.utils.datagen import generate_bench_data_device

    x = generate_bench_data_device(n, t, seed=42)
    xw, _, _ = center_whiten(x, n)
    del x
    rng = np.random.default_rng(1)
    mo = jnp.asarray(np.eye(n) + 0.01 * rng.standard_normal((n, n)), jnp.float32)
    mn = jnp.asarray(np.asarray(mo) + 0.01 * rng.standard_normal((n, n)),
                     jnp.float32)
    base = CoreOptions(density=Tanh(), ortho=False, extended=True,
                       has_cov=True, m=7, ls_tries=10)
    inv_t = 1.0 / t

    def per_call_ms(f, *args):
        _block(f(*args))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*args)
        _block(out)
        return (time.perf_counter() - t0) / reps * 1e3

    rows = []
    for precision, plain in _TIER_MODES:
        opts = dataclasses.replace(base, kernel_precision=precision,
                                   plain_ls=plain)
        xla = jax.jit(lambda a, b, xx, o=opts: data_fused_step(
            a, b, xx, o, True, True))
        xin = xw.astype(jnp.bfloat16) if plain else xw
        kern = jax.jit(lambda a, b, xx, p=precision, pl_=plain:
                       rotated_fused_sums(a, b, xx, Tanh(), True, True,
                                          interpret=interpret, precision=p,
                                          absolute_ll=pl_))
        compiled = kern.lower(mn, mo, xin).compile()
        mem = compiled.memory_analysis()
        dll_x, dysq_x, mom_x = xla(mn, mo, xw)
        dll_k, dysq_k, g_k, pm_k, h_k, ysq_k = compiled(mn, mo, xin)
        rel_bound, abs_bound = _TIER_BOUNDS[precision]
        errs = {}
        for name, got, want in [("g", g_k, mom_x.g_raw), ("h", h_k, mom_x.h_raw),
                                ("pm", pm_k, mom_x.pm_raw),
                                ("ysq", ysq_k, mom_x.ysq_rowmean)]:
            got = np.asarray(got, np.float64) * inv_t
            want = np.asarray(want, np.float64)
            errs[name] = float(np.max(np.abs(got - want)) /
                               max(np.max(np.abs(want)), 1e-30))
        errs["dll"] = float(np.max(np.abs(np.asarray(dll_k, np.float64) * inv_t
                                          - np.asarray(dll_x, np.float64))))
        ms_k = per_call_ms(compiled, mn, mo, xin)
        ms_x = per_call_ms(xla, mn, mo, xw)
        ok = (max(errs[k] for k in ("g", "h", "pm", "ysq")) <= rel_bound
              and errs["dll"] <= abs_bound)
        temp = getattr(mem, "temp_size_in_bytes", None)
        log(f"[kernels] {n}x{t} {precision}{'-plain' if plain else '-delta'}: "
            f"kernel {ms_k:.3f} ms/call, xla {ms_x:.3f} ms/call, "
            f"rel errs {', '.join(f'{k}={v:.1e}' for k, v in errs.items())} "
            f"kernel temp_bytes={temp} {'ok' if ok else 'FAIL'}")
        rows.append((precision, plain, ms_k, ms_x, ok))
    return rows


def _tier_floors(n=64, t=1_000_000, max_iter=60):
    """Each pinned tier's final gradient norm after ``max_iter``
    iterations at an unreachable tol (its noise floor), its passes and
    the fit's wall time per pass."""
    from picard_ica_tpu import PicardConfig
    from picard_ica_tpu.utils.datagen import generate_bench_data_device

    x = generate_bench_data_device(n, t, seed=42)
    for tier in ("bf16", "bf16x3", "f32"):
        for use_pallas in (True, False):
            cfg = PicardConfig(ortho=True, extended=True, tol=1e-12,
                               max_iter=max_iter, random_state=0,
                               kernel_precision=tier, use_pallas=use_pallas)
            _timed_fit(x, cfg)
            r, wall = _timed_fit(x, cfg)
            log(f"[kernels] tier {tier} kernel={use_pallas} {n}x{t}: "
                f"gnorm after {r.n_iterations} iterations "
                f"{r.gradient_norm:.3e}, {r.ls_calls} passes, "
                f"{wall / max(r.ls_calls, 1) * 1e3:.3f} ms/pass (whole fit "
                f"{wall:.3f} s)")


def _whole_fit_ab(n=64, t=4_000_000, reps=2):
    """Whole-fit wall time with and without the kernel, in turns, for
    the headline (Picard-O) and for the non-orthogonal extended fit
    (MNE's extended-Infomax setting, which also needs the H moment)."""
    from picard_ica_tpu import PicardConfig
    from picard_ica_tpu.utils.datagen import generate_bench_data_device

    x = generate_bench_data_device(n, t, seed=42)
    walls = {}
    for ortho in (True, False):
        def cfg(use_pallas):
            return PicardConfig(ortho=ortho, extended=True, tol=1e-7,
                                max_iter=100, random_state=0,
                                use_pallas=use_pallas)

        for use_pallas in (True, False):
            _timed_fit(x, cfg(use_pallas))
        for rep in range(reps):
            order = (True, False) if rep % 2 == 0 else (False, True)
            for use_pallas in order:
                r, wall = _timed_fit(x, cfg(use_pallas))
                walls.setdefault((ortho, use_pallas), []).append(wall)
                log(f"[kernels] whole fit {n}x{t} ortho={ortho} "
                    f"kernel={use_pallas}: {wall:.3f} s, {r.n_iterations} "
                    f"iterations, {r.ls_calls} passes, converged="
                    f"{r.converged}")
    return walls


def phase_kernels(shapes=((64, 4_000_000), (48, 1_000_000))) -> None:
    failures = []
    for n, t in shapes:
        for precision, plain, _, _, ok in _kernel_vs_xla(n, t):
            if not ok:
                failures.append((n, t, precision, plain))
    _whole_fit_ab()
    _tier_floors()
    if failures:
        raise AssertionError(f"kernel/XLA mismatches: {failures}")


def phase_tests() -> None:
    """The tests marked ``gpu``, in this process (a second process
    could not open the card while this one holds it)."""
    import pytest

    os.environ["PICARD_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(REPO, "tests")])
    log(f"[tests] pytest -m gpu exit code {int(rc)}")
    if int(rc) != 0:
        raise AssertionError(f"gpu-marked tests failed (exit code {int(rc)})")


def _owned_fit(make_x, cfg, mesh=None):
    """Time one fit of freshly generated data that the fit alone holds:
    the solver drops its input after whitening, so the raw buffer is
    freed before the core loop allocates (at 256 x 10M every 10 GB
    buffer counts)."""
    from picard_ica_tpu import Picard

    xs = [make_x()]
    _block(xs[0])
    t0 = time.perf_counter()
    r = Picard.fit_with_config(xs.pop(), cfg, mesh=mesh)
    _block(r.sources, r.unmixing)
    return r, time.perf_counter() - t0


def phase_four(n: int = 256, t: int = 10_000_000, devices=None) -> int:
    """BASELINE config 5 sharded over a 4-device sample mesh against the
    same fit on the first device alone. Returns the device count."""
    import jax

    from picard_ica_tpu import PicardConfig
    from picard_ica_tpu.parallel import sample_mesh
    from picard_ica_tpu.utils.datagen import generate_bench_data_device

    devices = list(devices if devices is not None else jax.devices())
    if len(devices) != 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devices)}")
    mesh = sample_mesh(devices)

    def make_x():
        # Generated on the first device; the sharded fit places its
        # shards from there (Picard.fit's device_put).
        return jax.device_put(generate_bench_data_device(n, t, seed=42),
                              devices[0])

    def peaks():
        return [(d.memory_stats() or {}).get("peak_bytes_in_use")
                for d in devices]

    cfg = PicardConfig(ortho=True, extended=True, tol=FOUR_TOLS[0],
                       max_iter=200, random_state=0)
    single, single_cold = _owned_fit(make_x, cfg)
    del single
    single, single_wall = _owned_fit(make_x, cfg)
    w_single = np.asarray(single.full_unmixing(), np.float64)
    single_gnorm = single.gradient_norm
    log(f"[four] {n}x{t} tol={cfg.tol}: single-device wall_s={single_wall:.3f} "
        f"(first run {single_cold:.3f}) iterations={single.n_iterations} "
        f"converged={single.converged} gnorm={single_gnorm:.3e} "
        f"stages={single.stage_exits} passes={single.ls_calls}; peak bytes "
        f"per device {peaks()}")
    del single
    for tol in FOUR_TOLS:
        cfg = dataclasses.replace(cfg, tol=tol)
        sharded, sharded_cold = _owned_fit(make_x, cfg, mesh=mesh)
        del sharded
        sharded, sharded_wall = _owned_fit(make_x, cfg, mesh=mesh)
        log(f"[four] {n}x{t} tol={tol}: 4-device wall_s={sharded_wall:.3f} "
            f"(first run {sharded_cold:.3f}) iterations={sharded.n_iterations} "
            f"converged={sharded.converged} gnorm={sharded.gradient_norm:.3e} "
            f"stages={sharded.stage_exits} passes={sharded.ls_calls}; peak "
            f"bytes per device {peaks()}")
        if sharded.converged or tol == FOUR_TOLS[-1]:
            break
        del sharded
    if not (single_gnorm < tol and sharded.converged):
        raise AssertionError(f"sharded or single-device fit did not converge "
                             f"at tol {tol}")
    log(f"[four] both fits converged at the stated tol {tol}")
    shards = sharded.sources.addressable_shards
    shard_devices = {s.device for s in shards}
    sizes = {s.data.shape for s in shards}
    log(f"[four] sources sharding: {len(shard_devices)} devices, "
        f"shard shapes {sorted(sizes)}; bytes_in_use per device "
        f"{[(d.memory_stats() or {}).get('bytes_in_use') for d in devices]}")
    if shard_devices != set(devices) or len(sizes) != 1:
        raise AssertionError("sharded sources do not span the 4 devices "
                             "in equal shards")
    am = _amari_between(sharded.full_unmixing(), w_single)
    log(f"[four] amari(4-device, single-device)={am:.3e} (bound {FOUR_AMARI})")
    if not am <= FOUR_AMARI:
        raise AssertionError(f"4-device amari {am:.3e} > {FOUR_AMARI}")
    return len(devices)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-card sample-sharded fit and "
                             "its single-card comparison")
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        info = phase_device()
        log(f"[device] card: {card_line()}")
        if args.four:
            info["count"] = phase_four()
        else:
            for name, fn in [("headline", phase_headline),
                             ("oracle", phase_oracle),
                             ("coverage", phase_coverage),
                             ("kernels", phase_kernels),
                             ("tests", phase_tests)]:
                t0 = time.time()
                fn()
                log(f"[{name}] ok in {time.time() - t0:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
