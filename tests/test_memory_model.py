"""Pins the single-device memory peak model (utils/memory_model) to the
pipeline's buffer anatomy, so a buffer-structure change that would
lower the largest fitting T shows up as arithmetic instead of an
out-of-memory error on the card."""

import pytest

from picard_ica_tpu.utils import memory_model as mm


def test_projection_is_the_binding_phase_at_bench_scale():
    """The whitened copy materializes while the raw data is still
    alive — 2 full data buffers, more than datagen's in-place 1, the
    refine's 1+block, and the core's 1.5."""
    phases = mm.phase_peak_bytes(256, 6_000_000)
    assert mm.binding_phase(256, 6_000_000) == "projection"
    assert phases["projection"] == 2 * 256 * 6_000_000 * 4  # 12.288e9
    # datagen mixes in place: 1 buffer + one rotation block
    assert phases["datagen"] < phases["projection"] * 0.60
    # core: donated f32 X + bf16 copy < 2 buffers
    assert phases["core"] < phases["projection"]


def test_max_t_reproduces_the_measured_boundary():
    """256xT peaks at 2 data buffers: 6M (12.29e9) fits any arena in
    [12.3e9, 14.3e9), 7M (14.34e9) does not — for every arena value in
    that bracket, not just one."""
    for arena in (12.4e9, 13.0e9, 14.3e9):
        assert mm.max_t(256, arena_bytes=arena) == 6_000_000, arena
    # 256x10M (BASELINE config 5) needs 20.5e9: one 80 GB card's
    # default 75 % arena (~60e9) holds it whole.
    assert mm.max_t(256, arena_bytes=60e9) >= 10_000_000


def test_peak_scales_linearly_in_t():
    assert mm.fit_peak_bytes(256, 4_000_000) == pytest.approx(
        mm.fit_peak_bytes(256, 2_000_000) * 2, rel=0.01
    )


def test_headline_shape_has_ample_headroom():
    """The 64x4M headline pipeline peaks ~2 GB — nowhere near an
    arena of tens of GB; memory pressure is a large-N concern only."""
    peak = mm.fit_peak_bytes(64, 4_000_000)
    assert peak == pytest.approx(2 * 64 * 4_000_000 * 4, rel=0.05)
    assert peak < 0.2 * 60e9


def test_xla_path_core_model():
    phases = mm.phase_peak_bytes(512, 1_000_000, use_pallas=False)
    comp = 512 * 1_000_000 * 4
    assert phases["core"] == 2 * comp
    kernel = mm.phase_peak_bytes(64, 1_000_000, use_pallas=True)
    assert kernel["core"] == 64 * 1_000_000 * 4 * 3 // 2


def test_default_arena_comes_from_the_device():
    """With no explicit arena the model asks the device's allocator;
    a device that reports none is an error, not a guessed default."""

    class _NoStats:
        device_kind = "cpu"

        def memory_stats(self):
            return None

    class _Stats:
        device_kind = "test"

        def memory_stats(self):
            return {"bytes_limit": 123}

    assert mm.device_arena_bytes(_Stats()) == 123
    with pytest.raises(RuntimeError, match="bytes_limit"):
        mm.device_arena_bytes(_NoStats())
