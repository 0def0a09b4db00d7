"""Centering + PCA whitening (reference: whitening.rs tests + conventions)."""

import jax.numpy as jnp
import numpy as np
import pytest

from picard_ica_tpu.errors import InvalidDimensionsError, SingularMatrixError
from picard_ica_tpu.ops.whitening import center, whiten


def test_center_zero_mean():
    """(whitening.rs:123-135)."""
    x = jnp.asarray([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    centered, mean = center(x)
    np.testing.assert_allclose(np.asarray(mean), [2.0, 5.0], atol=1e-12)
    np.testing.assert_allclose(np.asarray(centered).mean(axis=1), 0.0, atol=1e-12)


def test_whiten_shapes():
    """(whitening.rs:138-150)."""
    x = jnp.asarray([[1.0, 2.0, 3.0, 4.0], [2.0, 4.0, 6.0, 8.1], [1.0, 3.0, 2.0, 4.0]])
    centered, _ = center(x)
    result = whiten(centered, 2)
    assert result.data.shape == (2, 4)
    assert result.whitening_matrix.shape == (2, 3)


def test_whitened_data_has_identity_covariance():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 4000)) * np.array([3.0, 1.0, 0.5, 2.0, 1.5])[:, None]
    x = jnp.asarray(np.linalg.qr(rng.standard_normal((5, 5)))[0] @ np.asarray(x))
    centered, _ = center(x)
    result = whiten(centered, 5)
    cov = np.asarray(result.data) @ np.asarray(result.data).T / 4000
    np.testing.assert_allclose(cov, np.eye(5), atol=1e-8)


def test_whitening_matches_svd_formulation():
    """Eigh-of-covariance K == the reference's SVD K (whitening.rs:81-107)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 300))
    x = x - x.mean(axis=1, keepdims=True)

    result = whiten(jnp.asarray(x), 3)

    # Direct NumPy mirror of the reference's SVD construction.
    u, s, _ = np.linalg.svd(x, full_matrices=False)
    k_ref = (u[:, :3] / s[:3]).T * np.sqrt(300)
    for i in range(3):
        j = np.argmax(np.abs(k_ref[i]))
        if k_ref[i, j] < 0:
            k_ref[i] = -k_ref[i]

    np.testing.assert_allclose(np.asarray(result.whitening_matrix), k_ref, atol=1e-8)


def test_whiten_sign_convention():
    """Largest-|entry| of each row of K is positive (whitening.rs:92-107)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 500))
    x -= x.mean(axis=1, keepdims=True)
    k = np.asarray(whiten(jnp.asarray(x), 6).whitening_matrix)
    for row in k:
        assert row[np.argmax(np.abs(row))] > 0


def test_whiten_rejects_too_many_components():
    x = jnp.zeros((3, 10))
    with pytest.raises(InvalidDimensionsError):
        whiten(x, 4)


def test_whiten_rejects_rank_deficient():
    """(whitening.rs:71-79) near-zero singular value -> error."""
    base = np.random.default_rng(6).standard_normal((1, 100))
    x = np.vstack([base, 2 * base, 3 * base])  # rank 1
    x -= x.mean(axis=1, keepdims=True)
    with pytest.raises(SingularMatrixError):
        whiten(jnp.asarray(x), 3)


def test_whiten_rank_deficient_emits_no_warnings():
    """The rank test runs BEFORE K is formed: no overflow in 1/s."""
    import warnings

    base = np.random.default_rng(6).standard_normal((1, 100))
    x = np.vstack([base, 2 * base, 3 * base])
    x -= x.mean(axis=1, keepdims=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(SingularMatrixError):
            whiten(jnp.asarray(x), 3)


def test_chunked_f32_covariance_accuracy():
    """The chunked f32 device path tracks the f64 covariance to
    ~1e-6 relative (a single f32 accumulation drifts ~sqrt(T)*eps)."""
    from picard_ica_tpu.ops.whitening import _covariance

    rng = np.random.default_rng(7)
    x64 = rng.laplace(size=(8, 300_000))
    x32 = jnp.asarray(x64.astype(np.float32))
    cov32 = np.asarray(_covariance(x32), np.float64)
    cov64 = x64 @ x64.T
    rel = np.abs(cov32 - cov64).max() / np.abs(cov64).max()
    assert rel < 2e-6, rel


def test_chunked_f32_center_accuracy():
    rng = np.random.default_rng(8)
    x64 = rng.laplace(size=(4, 300_000)) + 3.0
    _, mean = center(jnp.asarray(x64.astype(np.float32)))
    rel = np.abs(np.asarray(mean, np.float64) - x64.mean(axis=1)).max()
    assert rel < 1e-6, rel


def test_preprocess_f64_matches_reference_pipeline():
    """Host-f64 preprocessing == f64 center+whiten to ~1e-12."""
    from picard_ica_tpu.ops.whitening import preprocess_f64

    rng = np.random.default_rng(9)
    x = rng.laplace(size=(6, 5000))
    data, mean, k = preprocess_f64(x, 6, True, True)

    xc = x - x.mean(axis=1, keepdims=True)
    u, s, _ = np.linalg.svd(xc, full_matrices=False)
    k_ref = (u / s).T * np.sqrt(5000)
    for i in range(6):
        j = np.argmax(np.abs(k_ref[i]))
        if k_ref[i, j] < 0:
            k_ref[i] = -k_ref[i]
    np.testing.assert_allclose(mean, x.mean(axis=1), atol=1e-12)
    np.testing.assert_allclose(k, k_ref, atol=1e-9)
    np.testing.assert_allclose(data, k_ref @ xc, atol=1e-8)


def test_preprocess_f64_rejects_rank_deficient():
    from picard_ica_tpu.ops.whitening import preprocess_f64

    base = np.random.default_rng(10).standard_normal((1, 100))
    x = np.vstack([base, 2 * base])
    with pytest.raises(SingularMatrixError):
        preprocess_f64(x, 2, True, True)


def test_center_whiten_matches_separate_pipeline():
    """Fused center_whiten == center followed by whiten (same data,
    mean and K), for every centering/whiten flag combination."""
    from picard_ica_tpu.ops.whitening import center_whiten

    rng = np.random.default_rng(21)
    x = (rng.laplace(size=(6, 4000)) + 1.5).astype(np.float32)

    x1, mean, k = center_whiten(jnp.asarray(x), 6, True, True)
    xc, mean_ref = center(jnp.asarray(x))
    wres = whiten(xc, 6)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(mean_ref), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(k), np.asarray(wres.whitening_matrix), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(x1), np.asarray(wres.data), rtol=1e-4, atol=1e-4
    )

    # centering off
    x1, mean, k = center_whiten(jnp.asarray(x), 6, False, True)
    assert mean is None
    wres = whiten(jnp.asarray(x), 6)
    np.testing.assert_allclose(
        np.asarray(k), np.asarray(wres.whitening_matrix), rtol=1e-5, atol=1e-6
    )

    # whiten off
    x1, mean, k = center_whiten(jnp.asarray(x), 6, True, False)
    assert k is None
    np.testing.assert_allclose(np.asarray(mean), np.asarray(mean_ref), rtol=1e-6)

    # both off: identity
    x1, mean, k = center_whiten(jnp.asarray(x), 6, False, False)
    assert mean is None and k is None
    np.testing.assert_allclose(np.asarray(x1), x, rtol=0, atol=0)


def test_center_whiten_ensure_owned_copies_passthrough():
    """ensure_owned=True is the solver's donation contract (ADVICE
    r4): even on the passthrough branch (centering=False,
    whiten_flag=False) the returned x1 must be a distinct buffer the
    caller may donate/mutate without touching the user's array."""
    from picard_ica_tpu.ops.whitening import center_whiten

    rng = np.random.default_rng(3)
    xd = jnp.asarray(rng.laplace(size=(4, 256)).astype(np.float32))

    x1, mean, k = center_whiten(xd, 4, False, False, ensure_owned=True)
    assert mean is None and k is None
    assert x1 is not xd
    assert (x1.unsafe_buffer_pointer() != xd.unsafe_buffer_pointer())
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(xd))

    # default keeps the zero-copy passthrough
    x1_alias, _, _ = center_whiten(xd, 4, False, False)
    assert x1_alias is xd


def test_fit_never_mutates_caller_device_array():
    """The in-place pre-rotation donates x1 unconditionally now that
    ownership is enforced at the source — a fit on a caller-owned
    device array with all preprocessing off must leave that array
    byte-identical and alive."""
    from picard_ica_tpu import ConfigBuilder, Picard

    rng = np.random.default_rng(11)
    s = rng.laplace(size=(3, 3000))
    a = rng.standard_normal((3, 3))
    xd = jnp.asarray((a @ s).astype(np.float32))
    before = np.asarray(xd).copy()

    cfg = (ConfigBuilder().centering(False).whiten(False)
           .max_iter(30).random_state(0).build())
    Picard.fit_with_config(xd, cfg)
    assert not xd.is_deleted()
    np.testing.assert_array_equal(np.asarray(xd), before)


@pytest.mark.parametrize("shape", [(5, 256), (5, 300), (5, 5000),
                                   (4, 2049), (40, 9001), (8, 40_000)])
def test_chunked_xla_mean_and_covariance_match_numpy_f64(shape):
    """The chunked, pairwise-folded XLA mean and centered covariance
    (the device whitening path) against NumPy f64, on partial and exact
    chunks, below and above the chunking threshold (T > 2048)."""
    from picard_ica_tpu.ops.whitening import (
        _cov_impl_for,
        _mean_impl_for,
        _prepare_stats,
    )

    n, t = shape
    rng = np.random.default_rng(12)
    x64 = rng.standard_normal((n, t)) + 5.0  # large mean stresses centering
    x = jnp.asarray(x64.astype(np.float32))
    cov_impl, mean_impl = _cov_impl_for(x), _mean_impl_for(x)
    assert (cov_impl, mean_impl) == (
        ("chunked", "chunked") if t > 2048 else ("dot", "plain"))
    mean, cov = _prepare_stats(x, cov_impl, mean_impl, True)
    x32 = np.asarray(x, np.float64)
    xc = x32 - x32.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(np.asarray(mean, np.float64),
                               x32.mean(axis=1), rtol=0, atol=1e-6)
    cov_ref = xc @ xc.T
    rel = np.abs(np.asarray(cov, np.float64) - cov_ref).max() / np.abs(cov_ref).max()
    assert rel < 5e-6, rel


def test_sharded_mid_n_dot_covariance_does_not_warn():
    """A mesh-sharded input routes to the single GSPMD dot
    DELIBERATELY (per-shard accumulation error is sqrt(n_devices)
    lower), with no warning, and agrees with the chunked route."""
    import warnings

    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from picard_ica_tpu.ops.whitening import _cov_impl_for, _covariance
    from picard_ica_tpu.parallel import sample_mesh

    rng = np.random.default_rng(7)
    x1 = jnp.asarray(rng.standard_normal((60, 4096)).astype(np.float32))
    mesh = sample_mesh()
    x = jax.device_put(x1, NamedSharding(mesh, PartitionSpec(None, "samples")))
    assert _cov_impl_for(x) == "dot"  # the sharded route
    assert _cov_impl_for(x1) == "chunked"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cov = _covariance(x)
    np.testing.assert_allclose(np.asarray(cov), np.asarray(_covariance(x1)),
                               rtol=2e-5, atol=2e-3)


def test_f32_single_dot_covariance_rotates_k():
    """QUANTIFIES why the device path chunks its covariance: a
    single-dot f32 covariance (~sqrt(T)*eps accumulation) rotates K by
    orders of magnitude more than the chunked/pairwise design, because
    random large-N mixtures have near-degenerate eigenvalues (relative
    gaps ~1e-6) that amplify covariance noise ~1/gap into the
    eigenvectors.

    This test runs the comparison at N=300 x T=120k for suite
    runtime.
    """
    from picard_ica_tpu.ops.whitening import (
        _covariance_chunked,
        whitening_matrix_from_covariance,
    )

    rng = np.random.default_rng(0)
    n, t = 300, 120_000
    s = rng.laplace(size=(n, t))
    x64 = rng.standard_normal((n, n)) @ s
    x64 -= x64.mean(axis=1, keepdims=True)
    x32 = x64.astype(np.float32)

    cov64 = x64 @ x64.T
    cov_dot32 = (x32 @ x32.T).astype(np.float64)  # single-dot error model
    cov_chunked = np.asarray(
        _covariance_chunked(jnp.asarray(x32)), np.float64
    )

    k64, _ = whitening_matrix_from_covariance(cov64, t, n)
    k_dot, _ = whitening_matrix_from_covariance(cov_dot32, t, n)
    k_chunked, _ = whitening_matrix_from_covariance(cov_chunked, t, n)

    rel_dot = np.linalg.norm(k_dot - k64) / np.linalg.norm(k64)
    rel_chunked = np.linalg.norm(k_chunked - k64) / np.linalg.norm(k64)
    # The single dot's K rotation is real and the chunked design is
    # markedly closer to f64.
    assert rel_dot > 1e-4, f"fallback unexpectedly accurate: {rel_dot:.2e}"
    assert rel_chunked < rel_dot / 3, (
        f"chunked {rel_chunked:.2e} vs dot {rel_dot:.2e}"
    )


def test_nan_data_whitening_raises_computation_error():
    """Non-finite data reaching the whitening eigh surfaces as
    ComputationError (whitening.rs:62-67 maps its SVD failure the same
    way), not a leaked numpy.linalg.LinAlgError."""
    from picard_ica_tpu.errors import ComputationError

    x = np.full((4, 1000), np.nan, dtype=np.float32)
    with pytest.raises(ComputationError, match="non-finite"):
        whiten(jnp.asarray(x), 4)


def test_iterative_rewhitening_reaches_functional_whiteness():
    """The f32 device path's one-step re-whitening.

    An ill-conditioned mixture amplifies norm-scale covariance noise
    by cond(C) into the small eigendirections: the FIRST-pass K
    whitens the true covariance only to percent-or-worse residual no
    matter how accurate the f32 covariance kernel is (its own f32
    quantization is eps*cond relative to the smallest eigenvalue).
    After composing the host-f64 symmetric inverse square root of the
    re-measured (near-identity, cond~1) covariance, the residual must
    drop to the measurement floor.
    """
    from picard_ica_tpu.ops.whitening import (
        center_whiten,
        whitening_matrix_from_covariance,
    )

    rng = np.random.default_rng(1)
    n, t = 300, 120_000
    s = rng.laplace(size=(n, t))
    x64 = rng.standard_normal((n, n)) @ s
    x64 -= x64.mean(axis=1, keepdims=True)
    cov64 = x64 @ x64.T

    x1, _, k = center_whiten(jnp.asarray(x64.astype(np.float32)), n)
    k = np.asarray(k, np.float64)
    resid = np.abs(k @ (cov64 / t) @ k.T - np.eye(n)).max()
    assert resid < 1e-3, f"refined whiten residual {resid:.2e}"

    # The emitted data itself is white (the property the core loop's
    # orthogonal constraint assumes).
    x1_64 = np.asarray(x1, np.float64)
    self_white = np.abs(x1_64 @ x1_64.T / t - np.eye(n)).max()
    assert self_white < 1e-4, f"output self-whiteness {self_white:.2e}"

    # Contrast: the unrefined first-pass K at the same scale misses by
    # orders of magnitude (this is what made refinement necessary).
    cov32 = (x64.astype(np.float32) @ x64.astype(np.float32).T).astype(
        np.float64)
    k1, _ = whitening_matrix_from_covariance(cov32, t, n)
    if k1 is not None:  # the fallback can outright fail the rank test
        resid1 = np.abs(k1 @ (cov64 / t) @ k1.T - np.eye(n)).max()
        assert resid1 > 10 * resid


def test_refinement_skips_f64_and_tiny_t():
    """f64 inputs (already exact to input precision) and tiny-T data
    must not pay the second pass: K equals the single-pass construction
    exactly."""
    from picard_ica_tpu.ops.whitening import (
        center_whiten,
        whitening_matrix_from_covariance,
    )

    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 1500))  # f64, t <= 2048
    x -= x.mean(axis=1, keepdims=True)
    _, _, k = center_whiten(jnp.asarray(x), 5)
    k_ref, _ = whitening_matrix_from_covariance(x @ x.T, 1500, 5)
    np.testing.assert_allclose(np.asarray(k, np.float64), k_ref,
                               rtol=1e-12, atol=1e-12)


def test_inplace_rotation_matches_full_dot_bitwise():
    """The refinement's in-place column-block rotation must be
    BIT-identical to the plain dot it replaces (the rotation contracts
    over rows only, so blockwise evaluation preserves each element's
    reduction order) — including at T that is not a multiple of the
    block width, and at T below one block."""
    from picard_ica_tpu.ops.whitening import (
        _HI,
        _ROTATE_BLOCK_T,
        _rotate_rows_inplace,
    )

    rng = np.random.default_rng(3)
    for n, t in [(4, 100), (8, _ROTATE_BLOCK_T + 777), (8, _ROTATE_BLOCK_T)]:
        r = jnp.asarray(rng.standard_normal((n, n)), jnp.float32)
        x = jnp.asarray(rng.standard_normal((n, t)), jnp.float32)
        want = np.asarray(jnp.dot(r, x, precision=_HI))
        got = np.asarray(_rotate_rows_inplace(r, x.copy()))
        assert np.array_equal(got, want), (n, t)


def test_refinement_dispatch_prefers_inplace_on_single_device():
    """Single-device projections route through the in-place rotation
    (the 3-buffer peak of the donated plain dot was the measured
    single-chip max-T ceiling); sharded arrays keep the plain dot
    (column-block slicing a T-sharded array would gather across
    devices)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from picard_ica_tpu.ops.whitening import _rotate_rows_dispatch
    from picard_ica_tpu.parallel import sample_mesh

    rng = np.random.default_rng(4)
    r = jnp.asarray(rng.standard_normal((4, 4)), jnp.float32)
    x = jnp.asarray(rng.standard_normal((4, 4096)), jnp.float32)
    want = np.asarray(jnp.dot(r, x, precision=jax.lax.Precision.HIGHEST))

    got_single = np.asarray(_rotate_rows_dispatch(r, x.copy()))
    assert np.array_equal(got_single, want)

    mesh = sample_mesh()
    sharded = jax.device_put(
        x, NamedSharding(mesh, PartitionSpec(None, "samples"))
    )
    got_sharded = np.asarray(_rotate_rows_dispatch(r, sharded))
    np.testing.assert_allclose(got_sharded, want, rtol=1e-6, atol=1e-6)
