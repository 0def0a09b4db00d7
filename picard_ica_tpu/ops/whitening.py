"""Centering and PCA whitening.

The reference whitens with a thin SVD of the N x T data matrix
(whitening.rs:61-65). On an accelerator the SVD of a long matrix is the
wrong formulation: the sample axis is sharded, so we compute the tiny N x N
covariance ``C = X X^T`` with one (sharded, psum-reduced) matmul and
eigendecompose it replicated. The two are mathematically identical:
if X = U S V^T then C = U S^2 U^T, so the whitening matrix
``K = (U / s)^T[:k] * sqrt(T)`` (whitening.rs:81-90) is recovered from
the top-k eigenpairs of C. The deterministic sign convention
(largest-|entry| of each row of K made positive, whitening.rs:92-107)
is reproduced exactly so results are comparable across implementations.

Accuracy design. The eigenVECTORS of the covariance are amplified by
1/eigengap: with many similar-variance components the relative gaps
sit at ~1e-3, so a naive f32 covariance (accumulation error
~sqrt(T)*eps ~ 2e-5 at T=500k) rotates K by percent-level amounts —
measurably different whitened data than an f64 pipeline, which (in
extended mode, whose sign dynamics are chaotic) can land the optimizer
in a different stationary point. Two mitigations:

* the f32 device path accumulates the covariance (and the mean) in
  T-chunks whose partials are folded with a pairwise tree — error
  ~eps*(bt/sqrt(T) + log2(n_chunks)), ~50x better than a single f32
  accumulation at T=500k, at the cost of nothing (same single pass
  over X);
* ``preprocess_f64`` runs the whole center+whiten in NumPy f64 on the
  host — the reference-parity path the facade selects automatically
  for f64 NumPy inputs of moderate size (the one-time O(N^2 T) host
  pass buys an input to the f32 core that matches the f64 pipeline's
  to cast precision, which provably keeps the extended-mode trajectory
  in the reference's basin; see docs/DESIGN.md §7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import InvalidDimensionsError, SingularMatrixError

# Reject singular values below this (whitening.rs:77).
_MIN_SINGULAR_VALUE = 1e-10

_HI = jax.lax.Precision.HIGHEST


class WhiteningResult(NamedTuple):
    """Whitened data + whitening matrix (whitening.rs:10-15)."""

    data: jnp.ndarray  # (n_components, n_samples)
    whitening_matrix: jnp.ndarray  # (n_components, n_features)


from .moments import fold_pairwise as _fold_pairwise  # noqa: E402


def _chunk_len(t: int) -> int:
    """T-chunk for the accurate f32 reductions: small chunks bound the
    in-chunk f32 accumulation error (~eps * bt / sqrt(T) relative) while
    the pairwise fold keeps the cross-chunk error at ~eps * log2(n)."""
    if t <= 2048:
        return t
    return max(512, min(8192, t // 512))


def _chunked_mean(x) -> jnp.ndarray:
    """Per-row mean with chunked sums + a pairwise fold (error
    ~eps*log(T/bt) instead of ~eps*sqrt(T) — the mean feeds the
    covariance, whose eigenvectors amplify input noise by 1/eigengap).
    Traceable: safe to call inside jit."""
    n, t = x.shape
    if x.dtype == jnp.float64 or t <= 2048:
        return jnp.mean(x, axis=1)
    bt = _chunk_len(t)
    pad = (-t) % bt
    xp = jnp.pad(x, ((0, 0), (0, pad))) if pad else x
    partial = jnp.sum(xp.reshape(n, -1, bt), axis=2)  # (n, n_chunks)
    return _fold_pairwise(partial.T) / t


def _mean_impl_for(x) -> str:
    """Pick the mean implementation (eager decision; the
    implementations are traceable).

    * f64 / tiny T / mesh-sharded: plain ``jnp.mean`` (exact enough at
      f64; under GSPMD each shard reduces only T/n_devices + psum).
    * otherwise the chunked form with a pairwise fold.
    """
    n, t = x.shape
    if x.dtype == jnp.float64 or t <= 2048:
        return "plain"
    if isinstance(x, jax.Array) and len(x.sharding.device_set) > 1:
        return "plain"
    return "chunked"


def _mean_impl(x, impl: str) -> jnp.ndarray:
    """Traceable per-row-mean dispatch (see :func:`_mean_impl_for`)."""
    if impl == "chunked":
        return _chunked_mean(x)
    return jnp.mean(x, axis=1)


@functools.partial(jax.jit, static_argnames=("mean_impl",))
def _center_jit(x, mean_impl: str):
    mean = _mean_impl(x, mean_impl)
    return x - mean[:, None], mean


def center(x) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Subtract the per-row (per-feature) mean (whitening.rs:24-35),
    as one jitted executable (the chunk/fold pipeline is ~40 tiny ops).
    """
    x = jnp.asarray(x)
    return _center_jit(x, _mean_impl_for(x))


# Exactly-rank-deficient data leaves the f64 eigh's smallest
# eigenvalue at ~machine-eps * lambda_max; anything below this RELATIVE
# floor is numerically zero. Needed because forming X X^T squares the
# condition number: the reference's absolute 1e-10 test on the SVD's
# sigma_min (whitening.rs:77) cannot be reproduced through the
# covariance (sigma = sqrt(lambda) bottoms out at sqrt(eps)*sigma_max),
# so rank deficiency is detected relatively instead.
_RELATIVE_EIG_FLOOR = 1e-14


def whitening_matrix_from_covariance(cov, n_samples: int, n_components: int):
    """Build K from the N x N covariance ``X X^T`` (unnormalized).

    Returns ``(k_matrix, min_singular_value)`` — NumPy f64; the caller
    casts. ``min_singular_value`` is forced to 0.0 (and ``k_matrix`` to
    ``None``) when the covariance is numerically rank-deficient — the
    rank test runs BEFORE K is formed so no 1/tiny overflow occurs.
    Eager (host-side): the covariance is a tiny replicated N x N
    matrix, and decomposing it in NumPy f64 keeps the whitening basis
    and the rank test at full precision even when the device computes
    in f32. The singularity *raise* is the caller's job.
    """
    cov64 = np.asarray(cov, np.float64)
    try:
        eigenvalues, eigenvectors = np.linalg.eigh(cov64)
    except np.linalg.LinAlgError as e:
        # Reference parity: decomposition failure surfaces as
        # ComputationError (whitening.rs:62-67 maps the SVD error the
        # same way) — typically non-finite input data.
        from ..errors import ComputationError

        raise ComputationError(
            f"whitening eigendecomposition failed: {e}"
            + (
                " (input data contains non-finite values)"
                if not np.all(np.isfinite(cov64))
                else ""
            )
        ) from e
    # eigh returns ascending order; the SVD convention is descending.
    order = np.argsort(eigenvalues)[::-1][:n_components]
    top_eigs = eigenvalues[order]
    u = eigenvectors[:, order]  # (n_features, k), columns = left sing. vectors
    # Singular values of X are sqrt of eigenvalues of X X^T.
    s = np.sqrt(np.maximum(top_eigs, 0.0))
    min_sv = float(s[-1]) if s.size else 0.0
    if eigenvalues.size and eigenvalues[-1] > 0 and (
        top_eigs[-1] < eigenvalues[-1] * _RELATIVE_EIG_FLOOR
    ):
        min_sv = 0.0
    if min_sv < _MIN_SINGULAR_VALUE:
        return None, min_sv

    scale = np.sqrt(np.float64(n_samples))
    k = (u / s[None, :]).T * scale  # (k, n_features)
    return k * _matlab_row_signs(k), min_sv


def _matlab_row_signs(k: np.ndarray) -> np.ndarray:
    """Deterministic sign column: flip rows whose largest-|entry| is
    negative (whitening.rs:92-107, "MATLAB convention")."""
    max_idx = np.argmax(np.abs(k), axis=1)
    row_sign = np.sign(np.take_along_axis(k, max_idx[:, None], axis=1))
    return np.where(row_sign == 0, 1.0, row_sign)


@jax.jit
def _covariance_chunked(x) -> jnp.ndarray:
    n, t = x.shape
    bt = _chunk_len(t)
    pad = (-t) % bt
    xp = jnp.pad(x, ((0, 0), (0, pad))) if pad else x
    xc = jnp.moveaxis(xp.reshape(n, -1, bt), 1, 0)  # (n_chunks, n, bt)

    def step(carry, x_chunk):
        return carry, jnp.dot(x_chunk, x_chunk.T, precision=_HI)

    _, partials = jax.lax.scan(step, jnp.zeros((), x.dtype), xc)
    return _fold_pairwise(partials)


def _cov_impl_for(x) -> str:
    """Pick the covariance implementation for ``x`` (eager decision;
    the implementations themselves are traceable).

    * f64 / tiny T: a single HIGHEST dot is exact enough.
    * mesh-sharded: the sequential chunk scan would serialize across
      devices; the single GSPMD dot already accumulates only
      T/n_devices per shard + psum, dividing the error by
      sqrt(n_devices).
    * otherwise the chunked scan with a pairwise fold.
    """
    n, t = x.shape
    if x.dtype == jnp.float64 or t <= 2048:
        return "dot"
    if isinstance(x, jax.Array) and len(x.sharding.device_set) > 1:
        return "dot"
    return "chunked"


def _covariance_impl(x, impl: str):
    """Traceable covariance dispatch (see :func:`_cov_impl_for`)."""
    if impl == "chunked":
        return _covariance_chunked(x)
    return jnp.dot(x, x.T, precision=_HI)


def _covariance(x) -> jnp.ndarray:
    """``X X^T`` (unnormalized) with chunked f32 accumulation.

    A single f32 dot accumulates over all T with ~sqrt(T)*eps
    relative error; chunking the T axis and tree-folding the (tiny)
    N x N chunk partials keeps the error at ~eps*log2(n_chunks).
    Sharded-friendly: the chunked scan is still one local pass over
    X (+ psum under SPMD). f64 inputs take the plain dot.
    """
    return _covariance_impl(x, _cov_impl_for(x))


def _refine_whitening(x1, k: np.ndarray, n_samples: int):
    """One step of iterative re-whitening for the f32 device path.

    Even an accurate f32 covariance (norm-relative error at f32 output
    quantization) leaves the first-pass K whitening the true covariance
    poorly when the mixture is ill-conditioned (cond(C) ~ 1e6 at
    N=600), because such mixtures amplify NORM-scale covariance noise
    into the small eigendirections. No f32-valued covariance can beat
    this — the quantization of C alone is eps_f32 * ||C||, i.e.
    eps_f32 * cond(C) relative to the smallest eigenvalue. The fix is
    not higher-precision accumulation but a second measurement in the
    whitened basis, where the covariance is near-identity (cond ~ 1):
    measure C2 = X1 X1^T of the projected data, form its HOST-f64
    symmetric inverse square root R = C2^{-1/2} (symmetric — the PCA
    whitener of a near-identity matrix is an arbitrary rotation and
    would scramble the component order), and compose K <- R K. The
    same norm-scale measurement error now lands on a cond~1 matrix,
    so the residual drops to the measurement floor.
    Reference anchor: whitening.rs:61-90 is all-f64 — this is the f32
    device path's route to not silently losing those digits.

    Returns ``(x1_refined, k_refined)``; on any numerical trouble in
    the refinement eigh the inputs are returned unchanged (the
    first-pass K is already rank-validated).
    """
    cov2 = np.asarray(
        _covariance_impl(x1, _cov_impl_for(x1)), np.float64
    ) / float(n_samples)
    try:
        w, u = np.linalg.eigh(cov2)
    except np.linalg.LinAlgError:  # pragma: no cover - guarded fallback
        return x1, k
    if not np.all(np.isfinite(w)) or w[-1] <= 0 or w[0] <= 1e-6 * w[-1]:
        # A grossly non-white first pass means the first K was already
        # untrustworthy; refinement on garbage would hide that.
        return x1, k  # pragma: no cover - requires pathological input
    r = (u / np.sqrt(w)) @ u.T  # symmetric C2^{-1/2}, f64
    k_ref = r @ np.asarray(k, np.float64)
    signs = _matlab_row_signs(k_ref)
    k_ref *= signs
    rs = jnp.asarray(signs * r, x1.dtype)
    return _rotate_rows_dispatch(rs, x1), k_ref


@functools.partial(jax.jit, donate_argnums=(1,))
def _rotate_rows_jit(r, x1):
    # x1 is an internal temporary (the pre-refinement projection) that
    # every caller discards, so it is donated — but XLA does NOT alias
    # a GEMM's output onto a donated operand (measured: 256x6M with a
    # data-sized ballast still OOMs), so this path keeps a 2-buffer
    # peak. Single-device callers get the truly in-place variant below.
    return jnp.dot(r, x1, precision=_HI)


def _rotate_rows(r, x1):
    from .linalg import call_donating

    return call_donating(_rotate_rows_jit, r, x1)


# In-place refinement re-projection: a donated plain dot cannot alias
# (see _rotate_rows), which would make the whitening pipeline peak at
# THREE data-sized f32 buffers. The shared blockwise rotation
# (ops/linalg, bit-identical to the full dot) holds it at one buffer
# plus one block. Aliased here for the whitening tests' import surface.
from .linalg import ROTATE_BLOCK_T as _ROTATE_BLOCK_T  # noqa: E402
from .linalg import rotate_rows_inplace as _rotate_rows_inplace  # noqa: E402


def _rotate_rows_dispatch(r, x1):
    """In-place rotation for single-device data; plain dot otherwise
    (a T-sharded GSPMD array must not be column-block-sliced — that
    would lower to cross-device gathers)."""
    if isinstance(
        getattr(x1, "sharding", None), jax.sharding.SingleDeviceSharding
    ):
        return _rotate_rows_inplace(r, x1)
    return _rotate_rows(r, x1)


def _should_refine(x) -> bool:
    """Refine exactly when the accuracy machinery applies: f32 data at
    scale (the f64 covariance path is already exact to input
    precision, and tiny-T fits are quantization-dominated anyway)."""
    return x.dtype == jnp.float32 and x.shape[1] > 2048


def whiten(x, n_components: int) -> WhiteningResult:
    """PCA-whiten centered data (eager; raises on singular data).

    ``x`` is (n_features, n_samples); output data has unit variance per
    component (scaled by sqrt(T) as in whitening.rs:83).
    """
    n_features, n_samples = x.shape
    if n_components > n_features:
        raise InvalidDimensionsError(
            f"n_components ({n_components}) cannot exceed n_features ({n_features})"
        )

    cov = _covariance(x)
    k, min_sv = whitening_matrix_from_covariance(cov, n_samples, n_components)
    if k is None or min_sv < _MIN_SINGULAR_VALUE:
        raise SingularMatrixError()
    kd = jnp.asarray(k, x.dtype)
    x1 = jnp.dot(kd, x, precision=_HI)
    if _should_refine(x):
        x1, k = _refine_whitening(x1, k, n_samples)
        kd = jnp.asarray(k, x.dtype)

    return WhiteningResult(data=x1, whitening_matrix=kd)


@functools.partial(
    jax.jit, static_argnames=("cov_impl", "mean_impl", "centering")
)
def _prepare_stats(x, cov_impl: str, mean_impl: str, centering: bool):
    """Mean of ``x`` + covariance of the centered data, ONE executable
    (the eager center -> covariance pipeline is ~40 tiny ops from the
    unrolled pairwise fold). Math is identical to :func:`center` +
    :func:`_covariance`."""
    if not centering:
        return None, _covariance_impl(x, cov_impl)
    mean = _mean_impl(x, mean_impl)
    return mean, _covariance_impl(x - mean[:, None], cov_impl)


@functools.partial(jax.jit, static_argnames=("centering",))
def _project_centered(k, x, mean, centering: bool):
    if centering:
        x = x - mean[:, None]
    return jnp.dot(k, x, precision=_HI)


def center_whiten(
    x,
    n_components: int,
    centering: bool = True,
    whiten_flag: bool = True,
    ensure_owned: bool = False,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray], Optional[jnp.ndarray]]:
    """Fused device-path center + whiten: ``(x1, mean, K)``.

    Semantically identical to :func:`center` followed by :func:`whiten`
    (same chunked-accuracy design, sign convention and rank test) but
    structured as exactly two device executables (stats; projection)
    around the host-f64 eigendecomposition.

    ``ensure_owned=True`` guarantees the returned ``x1`` is a buffer
    the caller exclusively owns (safe to donate/mutate in place):
    every transforming branch already returns a fresh array, and the
    one passthrough branch (``centering=False, whiten_flag=False``)
    copies. The solver keys its in-place pre-rotation donation on this
    contract instead of reconstructing ownership from config flags
    (ADVICE r4) — and the copy costs nothing net: the donated in-place
    rotation then skips the out-of-place dot's own (N, T) allocation.
    """
    x = jnp.asarray(x)
    if not whiten_flag:
        if centering:
            x1, mean = _center_jit(x, _mean_impl_for(x))
            return x1, mean, None
        return (jnp.array(x, copy=True) if ensure_owned else x), None, None
    n_features, n_samples = x.shape
    if n_components > n_features:
        raise InvalidDimensionsError(
            f"n_components ({n_components}) cannot exceed n_features ({n_features})"
        )
    mean, cov = _prepare_stats(x, _cov_impl_for(x), _mean_impl_for(x), centering)
    k, min_sv = whitening_matrix_from_covariance(
        np.asarray(cov), n_samples, n_components
    )
    if k is None or min_sv < _MIN_SINGULAR_VALUE:
        raise SingularMatrixError()
    kd = jnp.asarray(k, x.dtype)
    x1 = _project_centered(kd, x, mean, centering)
    if _should_refine(x):
        x1, k = _refine_whitening(x1, k, n_samples)
        kd = jnp.asarray(k, x.dtype)
    return x1, mean, kd


# Above this many elements the one-time host f64 pass (O(N^2 T) BLAS +
# O(N T) projection) stops being negligible next to the device fit;
# the facade's "auto" mode then stays on the device path.
_HOST_F64_MAX_ELEMENTS = 200_000_000


def preprocess_f64(
    x64: np.ndarray,
    n_components: int,
    centering: bool,
    whiten_flag: bool,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Host NumPy f64 centering + PCA whitening (reference parity).

    Returns ``(preprocessed_data_f64, mean_or_None, K_or_None)``.
    Semantics identical to :func:`center` + :func:`whiten` (including
    the sign convention and the rank test), evaluated entirely in f64:
    the whitening basis then matches an all-f64 pipeline's (e.g. the
    native oracle's, whitening.rs semantics) to ~1e-13 instead of the
    device path's ~1e-4-1e-2 — which keeps chaotic extended-mode
    trajectories in the same basin as the f64 reference
    (docs/DESIGN.md §7). Raises on singular data like :func:`whiten`.
    """
    x64 = np.ascontiguousarray(x64, np.float64)
    mean = None
    if centering:
        mean = x64.mean(axis=1)
        x64 = x64 - mean[:, None]
    if not whiten_flag:
        return x64, mean, None
    n_features, n_samples = x64.shape
    if n_components > n_features:
        raise InvalidDimensionsError(
            f"n_components ({n_components}) cannot exceed n_features ({n_features})"
        )
    cov = x64 @ x64.T
    k, min_sv = whitening_matrix_from_covariance(cov, n_samples, n_components)
    if k is None or min_sv < _MIN_SINGULAR_VALUE:
        raise SingularMatrixError()
    return k @ x64, mean, k
