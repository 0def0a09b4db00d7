"""Checkpoint/resume round-trip tests (no reference analog — SURVEY.md
§5 documents the reference has no persistence; resume maps onto its
``w_init`` warm-start mechanism)."""

import numpy as np
import pytest

from picard_ica_tpu import Picard, PicardConfig
from picard_ica_tpu.checkpoint import load_result, resume_config, save_result
from picard_ica_tpu.utils.datagen import generate_test_data


@pytest.fixture(scope="module")
def fitted():
    _, mixing, x = generate_test_data(5, 20_000, seed=9)
    config = PicardConfig(random_state=1, max_iter=200)
    return x, mixing, config, Picard.fit(x, config)


def test_round_trip(tmp_path, fitted):
    x, _, _, result = fitted
    p = tmp_path / "fit.npz"
    save_result(p, result)
    loaded = load_result(p)

    np.testing.assert_array_equal(np.asarray(result.unmixing), loaded.unmixing)
    np.testing.assert_array_equal(np.asarray(result.whitening), loaded.whitening)
    np.testing.assert_array_equal(np.asarray(result.sources), loaded.sources)
    np.testing.assert_array_equal(np.asarray(result.mean), loaded.mean)
    assert loaded.n_iterations == result.n_iterations
    assert loaded.converged == result.converged
    assert loaded.gradient_norm == pytest.approx(result.gradient_norm)


def test_round_trip_preserves_every_field(tmp_path, fitted):
    """load_result == original on EVERY PicardResult field (the
    diagnostics are part of the result contract,
    result.rs:7-33, and a round trip must not silently drop them)."""
    import dataclasses

    x, _, _, result = fitted
    p = tmp_path / "fit.npz"
    save_result(p, result)
    loaded = load_result(p)

    # the fit ran the staged-precision path, so the diagnostics exist
    assert result.stage_exits is not None
    assert result.stage_precisions is not None
    assert result.ls_calls is not None
    assert result.stage_ls_calls is not None

    for field in dataclasses.fields(result):
        orig = getattr(result, field.name)
        got = getattr(loaded, field.name)
        if orig is None:
            assert got is None, field.name
        elif hasattr(orig, "shape") and getattr(orig, "ndim", 0) > 0:
            np.testing.assert_array_equal(np.asarray(orig), np.asarray(got),
                                          err_msg=field.name)
        else:
            assert got == orig, field.name


def test_version_1_checkpoint_still_loads(tmp_path, fitted):
    """A pre-round-5 (format 1) file — no diagnostic keys — loads with
    the diagnostic fields None, exactly what it stored."""
    x, _, _, result = fitted
    p = tmp_path / "fit_v1.npz"
    with open(p, "wb") as f:
        np.savez(
            f,
            format_version=np.asarray(1),
            unmixing=np.asarray(result.unmixing),
            n_iterations=np.asarray(result.n_iterations),
            converged=np.asarray(result.converged),
            gradient_norm=np.asarray(result.gradient_norm),
        )
    loaded = load_result(p)
    np.testing.assert_array_equal(np.asarray(result.unmixing), loaded.unmixing)
    assert loaded.stage_exits is None
    assert loaded.stage_precisions is None
    assert loaded.ls_calls is None
    assert loaded.stage_ls_calls is None


def test_future_version_rejected(tmp_path):
    p = tmp_path / "future.npz"
    with open(p, "wb") as f:
        np.savez(f, format_version=np.asarray(99),
                 unmixing=np.eye(2), n_iterations=np.asarray(1),
                 converged=np.asarray(True), gradient_norm=np.asarray(0.0))
    with pytest.raises(ValueError, match="newer than supported"):
        load_result(p)


def test_round_trip_without_sources_and_optionals(tmp_path):
    _, _, x = generate_test_data(4, 5_000, seed=3)
    cfg = PicardConfig(random_state=0, whiten=False, centering=False,
                       extended=False, max_iter=100)
    result = Picard.fit(x, cfg)
    assert result.whitening is None and result.mean is None

    p = tmp_path / "fit.npz"
    save_result(p, result, include_sources=False)
    loaded = load_result(p)
    assert loaded.sources is None
    assert loaded.whitening is None
    assert loaded.mean is None
    assert loaded.signs is None
    np.testing.assert_array_equal(np.asarray(result.unmixing), loaded.unmixing)

    # transform still works from the checkpoint alone.
    y = Picard.transform(x, loaded)
    assert y.shape == (4, 5_000)


def test_resume_reaches_tighter_tolerance(tmp_path, fitted):
    x, _, config, result = fitted
    p = tmp_path / "fit.npz"
    save_result(p, result)
    prev = load_result(p)

    cfg2 = resume_config(prev, config.replace(tol=1e-9, max_iter=300))
    assert cfg2.jade_it is None and cfg2.fastica_it is None
    result2 = Picard.fit(x, cfg2)
    # Warm-started run improves (or at least matches) the gradient norm
    # in far fewer iterations than the cold run took.
    assert result2.n_iterations <= result.n_iterations
    assert result2.gradient_norm <= result.gradient_norm * 10


def test_resume_on_fresh_data_from_same_sources():
    """The resume_config whitening-basis caveat, exercised: a warm
    start from data A speeds up a fit on fresh data B drawn from the
    same sources, and both fits separate (the bases differ only by
    sampling noise)."""
    import numpy as np

    from picard_ica_tpu import Picard, PicardConfig
    from picard_ica_tpu.checkpoint import resume_config
    from picard_ica_tpu.utils import amari_distance

    rng = np.random.default_rng(33)
    mixing = rng.standard_normal((4, 4))
    s_a = rng.laplace(size=(4, 20_000))
    s_b = rng.laplace(size=(4, 20_000))

    cfg = PicardConfig(random_state=0, tol=1e-6)
    res_a = Picard.fit(mixing @ s_a, cfg)
    assert res_a.converged

    cold = Picard.fit(mixing @ s_b, cfg)
    warm = Picard.fit(mixing @ s_b, resume_config(res_a, cfg))
    assert warm.converged
    assert warm.n_iterations <= cold.n_iterations
    assert amari_distance(np.asarray(warm.full_unmixing()), mixing) < 5e-3
