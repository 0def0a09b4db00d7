"""Exception hierarchy for picard_ica_tpu.

Mirrors the error surface of the reference implementation
(reference: src/error.rs:9-79) as idiomatic Python exceptions. The
reference is a Rust ``enum PicardError``; here each variant is a
subclass of :class:`PicardError` so callers can catch either the broad
class or a specific failure mode.
"""

from __future__ import annotations


class PicardError(Exception):
    """Base class for all errors raised by picard_ica_tpu."""


class NotConvergedError(PicardError):
    """The algorithm did not converge within ``max_iter`` iterations.

    Note: like the reference (src/solver.rs:171-177), ``fit`` does not
    raise this by default — non-convergence is reported through
    ``PicardResult.converged`` plus a warning. This class exists for
    callers who want to escalate (``raise_on_no_convergence``).
    """

    def __init__(self, gradient_norm: float, tolerance: float, iterations: int):
        self.gradient_norm = float(gradient_norm)
        self.tolerance = float(tolerance)
        self.iterations = int(iterations)
        super().__init__(
            f"PICARD did not converge after {iterations} iterations. "
            f"Final gradient norm: {gradient_norm:.4e}, requested tolerance: "
            f"{tolerance:.4e}. Consider increasing max_iter or tolerance."
        )


class InvalidDimensionsError(PicardError):
    """Input dimensions are invalid (reference: error.rs:21-24)."""

    def __init__(self, message: str):
        self.message = message
        super().__init__(f"Invalid dimensions: {message}")


class SingularMatrixError(PicardError):
    """A singular matrix was encountered (reference: error.rs:27)."""

    def __init__(self, message: str = "Singular matrix encountered during computation"):
        super().__init__(message)


class ComputationError(PicardError):
    """General numerical/computation failure (reference: error.rs:30-33)."""

    def __init__(self, message: str):
        self.message = message
        super().__init__(f"Computation error: {message}")


class InvalidConfigError(PicardError):
    """Invalid configuration parameter (reference: error.rs:36-41)."""

    def __init__(self, parameter: str, message: str):
        self.parameter = parameter
        self.message = message
        super().__init__(f"Invalid configuration for '{parameter}': {message}")
