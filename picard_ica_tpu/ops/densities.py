"""Density (nonlinearity) plugins for ICA.

Each density is a small frozen dataclass whose methods are pure
``jnp`` elementwise functions. Because instances are hashable and
compared by value, a density can be passed as a *static* argument to
``jax.jit`` — dispatch happens at trace time and the elementwise math
fuses freely into surrounding XLA fusions and the Triton kernel.

Behavioral parity with the reference (src/density.rs):
  * Tanh — log-lik ``|y| + log(1 + exp(-2a|y|))/a`` (density.rs:50-56),
    score ``tanh(a*y)``, derivative ``a*(1 - tanh^2)`` (density.rs:58-63).
  * Exp  — log-lik ``-exp(-a*y^2/2)/a`` (density.rs:91-94), score
    ``y*exp(-a*y^2/2)``, derivative ``(1-a*y^2)*exp(-a*y^2/2)``
    (density.rs:96-103).
  * Cube — log-lik ``y^4/4``, score ``y^3``, derivative ``3*y^2``
    (density.rs:122-130).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple, runtime_checkable

import jax.numpy as jnp

@runtime_checkable
class Density(Protocol):
    """Protocol for density plugins (reference trait: density.rs:14-22)."""

    def log_lik(self, y):
        """Elementwise log-likelihood, same shape as ``y``."""
        ...

    def score_and_der(self, y) -> Tuple:
        """Return ``(score, score_derivative)``, each shaped like ``y``."""
        ...

    def log_lik_delta(self, y_old, dy):
        """``log_lik(y_old + dy) - log_lik(y_old)`` WITHOUT cancellation.

        Evaluated as an analytic function of (y_old, dy) so the result's
        error is relative to |dy| rather than to |log_lik| — the direct
        subtraction leaves ~eps-of-log_lik noise per element, which is
        what floors the line search's accept test near convergence
        (true per-step decreases fall below it long before tol=1e-7).
        Robust to extreme tails: when the step is large the identity
        falls back to a direct difference of the (order-of-magnitude
        separated, hence cancellation-safe) endpoint terms instead of a
        0 * inf underflow-times-overflow product.
        """
        ...

    def score_der_loglik_delta(self, y_old, dy) -> Tuple:
        """Return ``(score(y_new), score_der(y_new), log_lik_delta)``
        with y_new = y_old + dy, sharing transcendental subexpressions
        — THE method the fused hot-loop pass calls (one pass gives
        the accept test's loss delta and the candidate's score terms).
        """
        ...

    def score_der_loglik(self, y) -> Tuple:
        """Return ``(score, score_der, log_lik)`` of ``y`` with shared
        transcendentals — the PLAIN (absolute) variant of the fused
        pass: about half the elementwise work of the delta form and one fewer
        rotation dot, usable while the loss resolution of a direct
        f32 subtraction (~1e-4 absolute) still exceeds the per-step
        decreases (the cheap bf16 tier's whole working range).
        """
        ...


@dataclasses.dataclass(frozen=True)
class Tanh:
    """Hyperbolic-tangent density (default; super-Gaussian sources)."""

    alpha: float = 1.0

    # Staged-precision handoff thresholds (~2.5x the gradient noise
    # floor of each cheap tier, bf16 ~1.1e-4 and bf16x3 ~1.5e-7 at
    # N=64/T=1M; see models/core._precision_stages).
    bf16_handoff = 3e-4
    bf16x3_handoff = 4e-7

    def log_lik(self, y):
        a = self.alpha
        abs_y = jnp.abs(y)
        # Numerically stable form: exp argument is always <= 0.
        return abs_y + jnp.log1p(jnp.exp(-2.0 * a * abs_y)) / a

    def score_and_der(self, y):
        a = self.alpha
        score = jnp.tanh(a * y)
        return score, a * (1.0 - score * score)

    def log_lik_delta(self, y_old, dy):
        _, _, dll = self.score_der_loglik_delta(y_old, dy)
        return dll

    def score_der_loglik_delta(self, y_old, dy):
        # Shared e_a = exp(-2a|y_new|):
        #   tanh(a*y_new) = sign(y_new) * (1 - e_a) / (1 + e_a)
        # Delta with d_abs = |y_new| - |y_old| (exactly sign(y_old)*dy
        # when no sign crossing; directly — both operands tiny — when
        # there is one):
        #   ll(new) - ll(old) = d_abs + [log1p(e_a) - log1p(e_b)] / a
        # and log1p(e_a) - log1p(e_b) = log1p((e_a - e_b)/(1 + e_b)),
        # where e_a - e_b is evaluated as e_b * expm1(-2a*d_abs) for
        # small steps (full relative precision in the delta) and as the
        # direct difference for large ones — the product form there is
        # an underflow * overflow = NaN trap (e.g. y_old=90, dy=-45),
        # while the direct difference is cancellation-safe once the
        # endpoints differ by >= 40%.
        a = self.alpha
        y_new = y_old + dy
        abs_new = jnp.abs(y_new)
        abs_old = jnp.abs(y_old)
        e_b = jnp.exp(-2.0 * a * abs_old)

        crossing = abs_old <= jnp.abs(dy)
        d_abs = jnp.where(crossing, abs_new - abs_old, jnp.sign(y_old) * dy)
        t = -2.0 * a * d_abs
        small = jnp.abs(t) < 0.5

        if y_old.dtype == jnp.float64:
            # f64 conformance surface: bit-for-bit the form the C++
            # oracle's lockstep tests were measured against.
            e_a = jnp.exp(-2.0 * a * abs_new)
            t_th = (1.0 - e_a) / (1.0 + e_a)
            score = jnp.sign(y_new) * t_th
            score_der = a * (1.0 - t_th * t_th)
            num = jnp.where(
                small,
                e_b * jnp.expm1(jnp.clip(t, -0.5, 0.5)),
                e_a - e_b,
            )
        else:
            # f32: one native tanh replaces two exps.
            #   score = tanh(a*y_new) (exact — no (1-e)/(1+e) algebra),
            #   e_a   = (1-|tanh|)/(1+|tanh|), needed ONLY in the
            #           large-|t| branch where dll is dominated by
            #           d_abs >= 0.25/a, so the ~1e-7 absolute error
            #           this back-derivation carries for large |y_new|
            #           stays ~5e-7 RELATIVE in dll — f32-grade.
            # The small-|t| branch (every near-convergence element)
            # never touches e_a and is bit-identical to the f64 form.
            score = jnp.tanh(a * y_new)
            score_der = a * (1.0 - score * score)
            abs_th = jnp.abs(score)
            e_a = (1.0 - abs_th) / (1.0 + abs_th)
            num = jnp.where(
                small,
                e_b * jnp.expm1(jnp.clip(t, -0.5, 0.5)),
                e_a - e_b,
            )
        dll = d_abs + jnp.log1p(num / (1.0 + e_b)) / a
        return score, score_der, dll

    def score_der_loglik(self, y):
        # One exp serves score, derivative and log-lik:
        #   e = exp(-2a|y|); tanh(a y) = sign(y)(1-e)/(1+e);
        #   ll = |y| + log1p(e)/a.
        a = self.alpha
        abs_y = jnp.abs(y)
        e = jnp.exp(-2.0 * a * abs_y)
        t = (1.0 - e) / (1.0 + e)
        score = jnp.sign(y) * t
        score_der = a * (1.0 - t * t)
        ll = abs_y + jnp.log1p(e) / a
        return score, score_der, ll


@dataclasses.dataclass(frozen=True)
class Exp:
    """Gaussian-kernel ("exp") density for heavy-tailed sources."""

    alpha: float = 1.0

    # Measured floors match tanh's (bf16 ~1.3e-4, bf16x3 ~1.8e-7).
    bf16_handoff = 3e-4
    bf16x3_handoff = 4e-7

    def log_lik(self, y):
        a = self.alpha
        return -jnp.exp(-a * y * y / 2.0) / a

    def score_and_der(self, y):
        a = self.alpha
        y_sq = y * y
        k = jnp.exp(-a / 2.0 * y_sq)
        return y * k, (1.0 - a * y_sq) * k

    def log_lik_delta(self, y_old, dy):
        _, _, dll = self.score_der_loglik_delta(y_old, dy)
        return dll

    def score_der_loglik_delta(self, y_old, dy):
        # Shared k_a = exp(-a*y_new^2/2) between score, derivative and
        # the delta. Delta:
        #   ll(new) - ll(old) = (k_b - k_a) / a
        #                     = -k_b * expm1(-a*(2 y_old + dy)*dy/2) / a
        # using y_new^2 - y_old^2 = (2 y_old + dy)*dy (no cancellation).
        # The product form is kept for small exponents (full relative
        # precision); large ones use the direct difference, which is
        # cancellation-safe there and immune to the underflow *
        # overflow = NaN trap (e.g. y_old=13.5, dy=-12).
        a = self.alpha
        y_new = y_old + dy
        y_sq = y_new * y_new
        k_a = jnp.exp(-a / 2.0 * y_sq)
        k_b = jnp.exp(-a / 2.0 * y_old * y_old)

        score = y_new * k_a
        score_der = (1.0 - a * y_sq) * k_a

        q = -a / 2.0 * (2.0 * y_old + dy) * dy
        small = jnp.abs(q) < 0.5
        dll = jnp.where(
            small,
            -k_b * jnp.expm1(jnp.clip(q, -0.5, 0.5)) / a,
            (k_b - k_a) / a,
        )
        return score, score_der, dll

    def score_der_loglik(self, y):
        a = self.alpha
        y_sq = y * y
        k = jnp.exp(-a / 2.0 * y_sq)
        return y * k, (1.0 - a * y_sq) * k, -k / a


@dataclasses.dataclass(frozen=True)
class Cube:
    """Cubic density for sub-Gaussian (e.g. uniform) sources."""

    # y^3 amplifies tail dynamic range into the moment contractions:
    # measured cheap-tier floors sit ~10x above tanh's (bf16 ~1.1e-3,
    # bf16x3 ~1.4e-6 at N=64/T=1M) — the staged schedule must hand off
    # earlier or the bf16 tier stalls below its reachable range.
    bf16_handoff = 3e-3
    bf16x3_handoff = 4e-6

    def log_lik(self, y):
        y2 = y * y
        return y2 * y2 / 4.0

    def score_and_der(self, y):
        return y * y * y, 3.0 * y * y

    def log_lik_delta(self, y_old, dy):
        # (a^4 - b^4)/4 = (a^2 + b^2)(a + b) dy / 4 — exact factoring.
        y_new = y_old + dy
        return (y_new * y_new + y_old * y_old) * (y_new + y_old) * dy / 4.0

    def score_der_loglik_delta(self, y_old, dy):
        y_new = y_old + dy
        y2 = y_new * y_new
        return y2 * y_new, 3.0 * y2, self.log_lik_delta(y_old, dy)

    def score_der_loglik(self, y):
        y2 = y * y
        return y2 * y, 3.0 * y2, y2 * y2 / 4.0


class DensityType:
    """Constructor namespace matching the reference enum's helpers
    (density.rs:152-175). In Python the density *instances* are the
    dispatch mechanism, so this is sugar only."""

    Tanh = Tanh
    Exp = Exp
    Cube = Cube

    @staticmethod
    def tanh() -> Tanh:
        return Tanh()

    @staticmethod
    def tanh_with_alpha(alpha: float) -> Tanh:
        return Tanh(alpha)

    @staticmethod
    def exp() -> Exp:
        return Exp()

    @staticmethod
    def exp_with_alpha(alpha: float) -> Exp:
        return Exp(alpha)

    @staticmethod
    def cube() -> Cube:
        return Cube()


def default_density() -> Tanh:
    """Default density (reference: density.rs:146-150)."""
    return Tanh()
