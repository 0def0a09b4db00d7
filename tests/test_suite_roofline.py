"""Fit-level roofline columns (benchmarks/suite._roofline_fracs), the
peak table they divide by (benchmarks/roofline.py), and the cold-check
forensics parser.

These tests pin the GEMM-product accounting so a schedule or kernel
change that invalidates the model shows up as a test failure, not a
silently wrong committed fraction.
"""

import numpy as np
import pytest

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture()
def suite():
    import benchmarks.suite as suite_mod

    return suite_mod


class _Res:
    def __init__(self, stage_ls_calls):
        self.stage_ls_calls = np.asarray(stage_ls_calls)


def _opts(suite, **kw):
    from picard_ica_tpu.models.core import CoreOptions
    from picard_ica_tpu.ops.densities import Tanh

    base = dict(density=Tanh(), ortho=True, extended=True, has_cov=True,
                m=7, ls_tries=10, use_pallas=True, kernel_precision="auto")
    base.update(kw)
    return CoreOptions(**base)


def test_roofline_fracs_known_value(suite):
    """Hand-computed: ortho kernel auto-schedule, cumulative ls calls
    [10, 14, 15] -> per-stage [10, 4, 1]; bf16 stage is plain (2 GEMMs,
    1 bf16 product), bf16x3 delta (3 GEMMs, 3 bf16 products), final
    f32 delta (3 GEMMs at the f32 rate)."""
    from benchmarks.roofline import PEAKS

    peak = PEAKS[H100]
    n, t = 64, 1_000_000
    rec = {"wall_s": 0.01}
    opts = _opts(suite)
    suite._roofline_fracs(rec, _Res([10, 14, 15]), opts, n, t, device_kind=H100)

    gemm = 2.0 * n * n * t
    compute = ((10 * 2 * gemm + 4 * 3 * gemm * 3) / peak["bf16_flops"]
               + 1 * 3 * gemm / peak["f32_flops"])
    memory = (10 * 2.0 * n * t + (4 + 1) * 4.0 * n * t) / peak["hbm_bytes_per_s"]
    assert rec["roofline_compute_s"] == pytest.approx(compute)
    assert rec["roofline_memory_s"] == pytest.approx(memory)
    assert rec["roofline_share"] == pytest.approx(max(compute, memory) / 0.01)
    assert rec["roofline_bound"] == ("compute" if compute >= memory else "memory")


def test_roofline_share_scales_with_wall_time(suite):
    rec = {"wall_s": 0.5}
    suite._roofline_fracs(rec, _Res([4]), _opts(
        suite, kernel_precision="f32"), 32, 100_000, device_kind=H100)
    rec2 = {"wall_s": 1.0}
    suite._roofline_fracs(rec2, _Res([4]), _opts(
        suite, kernel_precision="f32"), 32, 100_000, device_kind=H100)
    assert rec["roofline_share"] == pytest.approx(2 * rec2["roofline_share"])


def test_roofline_fracs_skips_cpu_backend(suite):
    """A CPU time divided by a card's peak is no device metric: without
    a GPU no roofline column is written."""
    rec = {"wall_s": 0.01}
    suite._roofline_fracs(rec, _Res([10, 14, 15]), _opts(suite), 64, 10_000)
    assert "roofline_share" not in rec


def test_peak_table_has_the_h100_data_sheet_rates():
    from benchmarks.roofline import peaks

    p = peaks(H100)
    assert (p["bf16_flops"], p["tf32_flops"], p["f32_flops"]) == (
        989e12, 495e12, 67e12)
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in p["source"]


def test_peak_table_unknown_device_is_an_error(suite):
    from benchmarks.roofline import peaks

    with pytest.raises(KeyError, match="no published peaks"):
        peaks("Example Card 9000")
    with pytest.raises(KeyError):
        suite._roofline_fracs({"wall_s": 1.0}, _Res([4]), _opts(suite),
                              32, 100_000, device_kind="unknown card")


_COLD_STDERR = """\
[bench +    0.0s] enabling persistent compilation cache
[bench +   10.4s] device: {'platform': 'gpu', 'device_kind': 'NVIDIA H100 80GB HBM3', 'device_count': 1}
[bench +   10.4s] compile cache: .jax_cache
[bench +   10.4s] seed-datagen: generating 64x1000000 Laplace mixture on device
[bench +   22.0s] seed-datagen: done in 11.6s
[bench +   24.3s] seed-center+whiten done in 2.3s
[bench +   40.0s] seed-core compile+warm run done in 15.7s (30 iters, ...)
[bench +   40.3s] seed-rep 0: 2.900e+08 samples/s (30 iters, 0.10s)
[bench +   40.3s] seed measurement: 2.900e+08 samples/s (30 iters at T=1000000)
[bench +   40.3s] datagen: generating 64x4000000 Laplace mixture on device
[bench +   42.2s] datagen: done in 1.9s
[bench +   48.5s] center+whiten done in 6.3s
[bench +   59.6s] core compile+warm run done in 11.1s (35 iters, ...)
"""


def test_parse_cold_phases(suite):
    """The seed run's 'seed-' prefixed lines must NOT satisfy the
    full-run phase patterns (the pattern anchors right after the
    timestamp stamp) — otherwise a skipped full run would go
    unnoticed."""
    ends = suite._parse_cold_phases(_COLD_STDERR)
    assert ends == {"acquire": pytest.approx(10.4),
                    "seed": pytest.approx(40.3),
                    "datagen": pytest.approx(42.2),
                    "whiten": pytest.approx(48.5),
                    "core": pytest.approx(59.6)}


def test_parse_cold_phases_seed_only_leaves_full_run_none(suite):
    """A budget-shrunk run that never reaches the full config leaves
    the full-run phases None — cold_check then fails them as missing
    forensics, which is correct: a healthy cold run must complete the
    full pipeline."""
    seed_only = "".join(
        l + "\n" for l in _COLD_STDERR.splitlines()
        if "] seed" in l or "device:" in l or "cache" in l)
    ends = suite._parse_cold_phases(seed_only)
    assert ends["seed"] == pytest.approx(40.3)
    assert ends["datagen"] is None
    assert ends["whiten"] is None
    assert ends["core"] is None


def test_parse_cold_phases_missing_forensics(suite):
    ends = suite._parse_cold_phases("no bench lines at all")
    assert ends == {"acquire": None, "seed": None, "datagen": None,
                    "whiten": None, "core": None}


_FALLBACK_STDERR = """\
[bench +    9.3s] device: {'platform': 'gpu'}
[bench +    9.3s] datagen: generating 64x4000000 Laplace mixture on device
[bench +   11.0s] datagen: done in 1.7s
[bench +   17.2s] center+whiten done in 6.2s
[bench +   80.0s] core: 64x4000000 failed once, retrying
[bench +  150.0s] core compile+warm run done in 70.0s (36 iters, ...)
[bench +  190.4s] core compile+warm run done in 40.4s (36 iters, ...)
"""


def test_parse_cold_phases_fallback_retry(suite):
    """Only done-lines stamp a phase ('core: ... failed' starts with the
    same token), and the LAST one counts, so the cost of a repeated
    compile cannot slip past cold_check."""
    ends = suite._parse_cold_phases(_FALLBACK_STDERR)
    assert ends["core"] == pytest.approx(190.4)
