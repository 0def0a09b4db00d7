"""Result container for a fitted Picard model.

Mirrors ``PicardResult`` (reference: src/result.rs:7-64). Arrays are
JAX arrays (device-resident); scalar diagnostics are Python values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from .ops.linalg import mixing_pinv


@dataclasses.dataclass
class PicardResult:
    """Output of ``Picard.fit`` (result.rs:7-33)."""

    # Whitening matrix K (n_components, n_features); None if whiten=False.
    whitening: Optional[jnp.ndarray]
    # Unmixing matrix W (n_components, n_components).
    unmixing: jnp.ndarray
    # Estimated sources (n_components, n_samples).
    sources: jnp.ndarray
    # Per-feature mean (n_features,); None if centering=False.
    mean: Optional[jnp.ndarray]
    n_iterations: int
    converged: bool
    gradient_norm: float
    # Sub/super-Gaussian signs per component; None unless extended mode.
    signs: Optional[jnp.ndarray]
    # --- observability extensions (reference: verbose prints only,
    # core.rs:383-390; here the diagnostics also ride the result) ---
    # Iteration number at which each precision stage exited (one entry
    # per stage of models/core._precision_stages; a single entry for
    # pinned precisions / the XLA path).
    stage_exits: Optional[tuple] = None
    # Precision name per stage, aligned with stage_exits.
    stage_precisions: Optional[tuple] = None
    # Total fused line-search passes over the data (accepted +
    # rejected tries incl. GD fallbacks) — each is one streaming read
    # of X, the dominant cost; ls_calls / n_iterations is the
    # optimizer-efficiency diagnostic.
    ls_calls: Optional[int] = None
    # Cumulative ls_calls at each stage exit (aligned with
    # stage_exits); successive differences are the per-tier pass
    # counts that, times the per-tier device cost, form the headline
    # cost model.
    stage_ls_calls: Optional[tuple] = None

    def full_unmixing(self) -> jnp.ndarray:
        """``W @ K`` when whitened, else ``W`` (result.rs:39-44).

        HIGHEST precision: the default GPU matmul (TF32) would add
        ~1e-3 relative noise to the composed unmixing — larger than
        the solver's own error by orders of magnitude.
        """
        if self.whitening is not None:
            return jnp.dot(self.unmixing, self.whitening,
                           precision=jax.lax.Precision.HIGHEST)
        return self.unmixing

    def mixing(self) -> jnp.ndarray:
        """Pseudo-inverse of the full unmixing matrix (result.rs:49-64).

        SVD-based pinv with a transpose fallback for degenerate inputs
        (valid for orthogonal W); see ops.linalg.mixing_pinv for why this
        improves on the reference's normal-equations formulation.
        """
        return mixing_pinv(self.full_unmixing())
