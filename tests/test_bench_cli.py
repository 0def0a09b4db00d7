"""Coverage for the headline bench (bench.py).

The bench must never print a number it did not measure: it exits
non-zero, with no JSON line, when it finds no GPU or measured nothing,
and every record names the device it ran on. Happy-path tests run the
full pipeline — on-device datagen, device whiten, core measurement,
CPU baseline, JSON emission — at toy scale on the CPU backend through
the ``PICARD_BENCH_PLATFORM=cpu`` rehearsal override, asserting the
stdout contract (reference harness contract: the criterion bench runs
cold and unattended, benches/benchmarks.rs:130-141).
"""

import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def bench(monkeypatch):
    """bench.py module shrunk to toy scale, on the CPU override."""
    import bench as bench_mod

    monkeypatch.setenv("PICARD_BENCH_PLATFORM", "cpu")
    monkeypatch.setattr(bench_mod, "N_COMPONENTS", 8)
    monkeypatch.setattr(bench_mod, "N_SAMPLES", 20_000)
    monkeypatch.setattr(bench_mod, "SEED_SAMPLES", 10_000)
    monkeypatch.setattr(bench_mod, "REPS", 1)
    bench_mod._BEST.clear()
    bench_mod._DEVICE.clear()
    bench_mod._EMITTED = False
    return bench_mod


def _parse_stdout(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, f"expected exactly one stdout line, got {out}"
    return json.loads(out[0])


def test_bench_emits_driver_contract(bench, capsys):
    assert bench.main() == 0
    rec = _parse_stdout(capsys)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "platform",
                        "device_kind", "device_count", "n", "t", "iterations"}
    assert rec["metric"] == "grad_loop_samples_per_sec_per_chip"
    assert rec["unit"] == "samples/s/chip"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    # The record names the device it measured — here the CPU override.
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert (rec["n"], rec["t"]) == (8, 20_000)


def test_bench_rerun_reproduces_contract(bench, capsys):
    """A second in-process run must reproduce the contract — the bench
    holds NO disk state a fresh clone cannot have."""
    bench.main()
    first = _parse_stdout(capsys)

    bench._BEST.clear()
    bench.main()
    second = _parse_stdout(capsys)
    assert second["metric"] == first["metric"]
    assert second["value"] > 0


def test_bench_data_is_device_generated(bench, monkeypatch, capsys):
    """The critical path must not touch the host-side LCG generator or
    probe the native module (whose first use builds it with g++)."""
    from picard_ica_tpu import native
    from picard_ica_tpu.utils import datagen

    def _boom(*a, **kw):  # pragma: no cover - assertion helper
        raise AssertionError("bench touched a host-scale datagen path")

    # (the n*n mixing block still comes from the host LCG — that is
    # n*n values, not a data-scale stream, and stays allowed)
    monkeypatch.setattr(datagen, "generate_bench_data", _boom)
    monkeypatch.setattr(native, "available", _boom)
    bench.main()
    assert _parse_stdout(capsys)["value"] > 0


def test_bench_survives_deterministic_measurement_bug(bench, capsys, monkeypatch):
    """A failure in the measurement is reported, not papered over:
    main()'s catch-all logs the traceback, prints no record, and
    returns non-zero."""
    import picard_ica_tpu.models.core as core_mod

    monkeypatch.setattr(
        core_mod, "run_core_jit",
        lambda *a, **kw: (_ for _ in ()).throw(ValueError("deterministic bug")),
    )
    assert bench.main() != 0
    captured = capsys.readouterr()
    assert captured.out.strip() == ""
    assert "deterministic bug" in captured.err  # traceback surfaced


def test_bench_refuses_a_platform_that_is_not_the_gpu(bench, capsys, monkeypatch):
    """Without the rehearsal override the bench measures only the GPU;
    on the CPU it prints nothing and exits non-zero."""
    monkeypatch.delenv("PICARD_BENCH_PLATFORM")
    assert bench.main() != 0
    captured = capsys.readouterr()
    assert captured.out.strip() == ""
    assert "measures the GPU" in captured.err


def test_bench_sigterm_emits_best_so_far(bench, capsys):
    """The timeout path: once _BEST holds a measurement, the SIGTERM
    handler prints it (_emit_and_exit calls os._exit, so invoke _emit
    directly here), with the T it measured and the device."""
    bench._DEVICE.update(platform="gpu", device_kind="test", device_count=1)
    bench._BEST.update(sps=1.23e8, iters=30, cpu_sps=2.4e6, n=64,
                       t=1_000_000)
    assert bench._emit() == 0
    rec = _parse_stdout(capsys)
    assert rec["value"] == pytest.approx(1.23e8)
    assert rec["vs_baseline"] == pytest.approx(1.23e8 / 2.4e6)
    assert rec["t"] == 1_000_000 and rec["device_kind"] == "test"


def test_budget_aware_shrink_ladder(bench):
    """The full-config T steps down as budget evaporates instead of
    running out mid-measurement."""
    assert bench._choose_full_t(500.0) == bench.N_SAMPLES
    assert bench._choose_full_t(150.0) == min(bench.N_SAMPLES, 2_000_000)
    assert bench._choose_full_t(90.0) == min(bench.N_SAMPLES, 1_000_000)
    assert bench._choose_full_t(30.0) is None


def test_stall_injection_deadline_emits_record():
    """A run whose first device op blocks past the self-deadline (an
    injected stall, 8 s against a 2 s deadline): the deadline thread
    fires while the main thread is still blocked, and since nothing
    was measured it prints no record and exits non-zero."""
    env = dict(os.environ)
    env.update(
        PICARD_BENCH_TEST_STALL_S="8",
        PICARD_BENCH_DEADLINE_S="2",
        PICARD_BENCH_BUDGET_S="6",
        PICARD_BENCH_PLATFORM="cpu",
    )
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "bench.py")],
        capture_output=True, text=True, timeout=120, env=env, cwd=_REPO,
    )
    assert proc.returncode != 0, proc.stderr
    assert proc.stdout.strip() == ""
    assert "self-deadline reached" in proc.stderr
    assert "no measurement completed" in proc.stderr


def test_stall_forensics_heartbeat():
    """A silent phase leaves heartbeat lines on stderr."""
    env = dict(os.environ)
    env.update(
        PICARD_BENCH_TEST_STALL_S="25",
        PICARD_BENCH_DEADLINE_S="22",
        PICARD_BENCH_BUDGET_S="20",
        PICARD_BENCH_PLATFORM="cpu",
    )
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "bench.py")],
        capture_output=True, text=True, timeout=120, env=env, cwd=_REPO,
    )
    assert proc.returncode != 0, proc.stderr
    assert "heartbeat: still in" in proc.stderr, proc.stderr
