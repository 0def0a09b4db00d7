"""chip_smoke.py rehearsed on the CPU: each phase at toy size (the
kernel in interpret mode), the four-device phase on four virtual CPU
devices, and the refusal to report success without a GPU or without
the package beside it."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(cwd, extra_env=None, args=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _reports_ok(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            continue
    return False


@pytest.mark.parametrize("args", [(), ("--four",)], ids=["one", "four"])
def test_chip_smoke_exits_nonzero_without_gpu(args):
    proc = _run_script(_REPO, args=args)
    assert proc.returncode != 0
    assert not _reports_ok(proc.stdout)
    assert "expected a gpu device" in proc.stderr


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path))
    assert proc.returncode != 0
    assert not _reports_ok(proc.stdout)


def test_phase_device_names_the_device():
    info = chip_smoke.phase_device(expect_platform="cpu")
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    with pytest.raises(RuntimeError, match="expected a gpu device"):
        chip_smoke.phase_device()


def test_phase_headline_toy(capsys):
    out = chip_smoke.phase_headline(n=8, t=50_000, reps=1)
    assert out["iterations"] > 0 and out["wall_s"] > 0
    log = capsys.readouterr().out
    assert "amari(fit, reference)" in log and "model_peak_bytes" in log


def test_phase_oracle_runs_in_f64(capsys):
    chip_smoke.phase_oracle()
    log = capsys.readouterr().out
    assert log.count("dtype=float64") == 2


def test_phase_coverage_toy(capsys):
    chip_smoke.phase_coverage(n=8, t=20_000)
    log = capsys.readouterr().out
    assert log.count("[coverage]") == len(chip_smoke.coverage_cases())


def test_phase_coverage_case_through_the_kernel(monkeypatch, capsys):
    """One coverage case with the fused kernel forced (interpret mode
    on the CPU), as the card takes it."""
    first = chip_smoke.coverage_cases()[:1]
    monkeypatch.setattr(chip_smoke, "coverage_cases", lambda: first)
    chip_smoke.phase_coverage(n=8, t=20_000, use_pallas=True)
    assert " ok" in capsys.readouterr().out


def test_phase_kernels_toy(capsys):
    rows = chip_smoke._kernel_vs_xla(16, 8192, reps=1, interpret=True)
    assert [(p, plain) for p, plain, *_ in rows] == chip_smoke._TIER_MODES
    assert all(ok for *_, ok in rows), capsys.readouterr().out


def test_phase_four_on_four_virtual_devices(capsys):
    count = chip_smoke.phase_four(n=8, t=40_000, devices=jax.devices()[:4])
    assert count == 4
    log = capsys.readouterr().out
    assert "4 devices" in log and "amari(4-device, single-device)" in log
