"""Hot N x T moment contractions of the Picard inner loop.

Per iteration the optimizer needs (reference: core.rs:211-276):

  * ``G_raw  = psi(Y) Y^T / T``            — relative gradient moment
  * ``pm_raw = mean(psi'(Y), axis=1)``     — E[psi'] per component
  * ``H_raw  = psi'(Y) (Y*Y)^T / T``       — Hessian moment (non-ortho)
  * ``ysq_rowmean = mean(Y*Y, axis=1)``    — extended non-ortho loss term

and per line-search try (core.rs:117-127):

  * ``Y' = Tm @ Y`` and ``rowsum(log_lik(Y'))``

Everything here is expressed so that the T axis may be sharded across a
device mesh: each contraction is a local partial reduced by XLA's SPMD
partitioner (psum over the "samples" axis). The sign/+1/skew fix-ups of
extended mode are cheap N x N algebra applied OUTSIDE these kernels
(see models/core.py), which keeps the data-axis kernels
sign-independent and lets one fused pass serve every mode.

Two interchangeable implementations are provided:
  * the XLA path below (jnp; always available, differentiable), and
  * a fused Triton kernel in ops/pallas_kernels.py (the GPU at
    N <= 64) for the line-search pass.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


class RawMoments(NamedTuple):
    g_raw: jnp.ndarray  # (N, N)   psi(Y) Y^T / T
    pm_raw: jnp.ndarray  # (N,)     E[psi'(Y)] per row
    h_raw: jnp.ndarray  # (N, N)   psi'(Y) (Y^2)^T / T (zeros when unused)
    ysq_rowmean: jnp.ndarray  # (N,) E[Y^2] per row (zeros when unused)


def fold_pairwise(partials):
    """Tree-fold (n_chunks, ...) leading-axis partials.

    Unrolled at trace time into ~log2(n) vectorized adds; rounding
    error grows O(log n * eps) instead of a naive running sum's
    O(n * eps). The single shared definition of the accuracy-critical
    reduction used by the Pallas tile folds
    (ops/pallas_kernels.py) and the chunked whitening
    statistics (whitening._chunked_mean/_covariance_chunked).
    """
    while partials.shape[0] > 1:
        half = partials.shape[0] // 2
        folded = partials[:half] + partials[half : 2 * half]
        if partials.shape[0] % 2:
            folded = folded.at[0].add(partials[-1])
        partials = folded
    return partials[0]


def _row_mean(m):
    """``mean(m, axis=1)`` shaped for the hardware.

    f32: a dot with a ones vector, at HIGHEST like every other
    contraction here. f64 (the conformance surface) keeps
    ``jnp.mean`` — its reduce order is what the oracle-lockstep
    tolerances were measured against.
    """
    if m.dtype == jnp.float64:
        return jnp.mean(m, axis=1)
    t = m.shape[1]
    ones = jnp.ones((t,), m.dtype)
    return jnp.dot(m, ones, precision=_HI) * m.dtype.type(1.0 / t)


def compute_raw_moments_xla(y, density, need_h: bool, need_ysq_mean: bool) -> RawMoments:
    """Reference XLA implementation of the fused moment pass.

    ``need_h`` is static: the Hessian moment is only needed in the
    non-orthogonal branch (core.rs:274); the orthogonal branch builds
    its Hessian from ``pm_raw`` alone (core.rs:263-272).
    """
    n, t = y.shape
    dtype = y.dtype
    inv_t = jnp.asarray(1.0 / t, dtype)

    psi, psi_d = density.score_and_der(y)
    g_raw = jnp.dot(psi, y.T, precision=_HI) * inv_t
    pm_raw = _row_mean(psi_d)

    if need_h:
        ysq = y * y
        h_raw = jnp.dot(psi_d, ysq.T, precision=_HI) * inv_t
    else:
        h_raw = jnp.zeros((n, n), dtype)

    if need_ysq_mean:
        ysq_rowmean = _row_mean(y * y)
    else:
        ysq_rowmean = jnp.zeros((n,), dtype)

    return RawMoments(g_raw, pm_raw, h_raw, ysq_rowmean)


def loglik_rowmeans_xla(y, density):
    """Per-component mean log-likelihood: ``mean(log_lik(Y), axis=1)``.

    The density term of the loss (core.rs:73-77) is then
    ``sum(signs * loglik_rowmeans)``.
    """
    return _row_mean(density.log_lik(y))
