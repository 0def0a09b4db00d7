"""Public Picard solver facade.

Orchestrates a full fit (reference: src/solver.rs:45-189):
validate -> RNG -> center -> whiten -> init W (random / JADE / FastICA)
-> core loop -> compose W·W_init -> PicardResult. The orchestration is
eager Python (cheap, one-time N x N work plus two sharded passes over
the data); the hot optimizer loop is one jitted function.

Extension: ``fit(..., mesh=...)`` shards the samples axis of the data
over a 1-D device mesh; all T-axis contractions then reduce
with psum via SPMD while the N x N state stays replicated.
"""

from __future__ import annotations

import sys
import warnings
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import PicardConfig
from .errors import (
    InvalidDimensionsError,
    SingularMatrixError,
)
from .models.core import CoreOptions, run_core_jit, run_core_jit_donated
from .models.fastica import ica_par_jit
from .models.jade import jade_jit
from .ops.densities import Tanh
from .ops.linalg import _SYM_DECORR_MIN_EIG, sym_decorrelation_with_mineig
from .ops.whitening import _HOST_F64_MAX_ELEMENTS, center_whiten, preprocess_f64
from .results import PicardResult

try:  # jax >= 0.4 namespace
    from jax.sharding import NamedSharding, PartitionSpec
except ImportError:  # pragma: no cover
    NamedSharding = None
    PartitionSpec = None

SAMPLE_AXIS = "samples"


def _resolve_dtype(x, config: PicardConfig):
    if config.dtype is not None:
        return jnp.dtype(config.dtype)
    x_dtype = np.asarray(x).dtype if not isinstance(x, jax.Array) else x.dtype
    if x_dtype == np.float64 and jax.config.jax_enable_x64:
        return jnp.dtype(jnp.float64)
    return jnp.dtype(jnp.float32)


def _data_sharding(mesh):
    if mesh is None:
        return None
    return NamedSharding(mesh, PartitionSpec(None, SAMPLE_AXIS))


def _kernel_route(n_components: int, dtype) -> bool:
    """Whether a fit takes the fused Triton kernel: on the GPU, in
    f32, at N within the kernel's register budget. Everything else runs
    the XLA formulation of the same pass."""
    from .ops.pallas_kernels import MAX_N

    return (
        jax.default_backend() == "gpu"
        and jnp.dtype(dtype) == jnp.float32
        and n_components <= MAX_N
    )


class Picard:
    """Static-method facade, mirroring the reference's ``Picard`` struct."""

    @staticmethod
    def fit(x, config: Optional[PicardConfig] = None, mesh=None) -> PicardResult:
        """Fit ICA on ``x`` of shape (n_features, n_samples)."""
        return Picard.fit_with_config(x, config or PicardConfig(), mesh=mesh)

    @staticmethod
    def fit_with_config(x, config: PicardConfig, mesh=None) -> PicardResult:
        config.validate()

        dtype = _resolve_dtype(x, config)

        # Host-f64 preprocessing (see config.whiten_precision): when the
        # caller hands us an f64 host array and the core will run in
        # f32, the one-time center+whiten pass runs in NumPy f64 so the
        # whitening basis matches an all-f64 pipeline's (the eigengap
        # amplification makes a device-f32 covariance rotate K by
        # orders of magnitude more than the core's own f32 error —
        # docs/DESIGN.md §7).
        x_host = x if isinstance(x, np.ndarray) else None
        host_f64 = config.whiten_precision == "f64"
        if config.whiten_precision == "auto":
            host_f64 = (
                x_host is not None
                and x_host.dtype == np.float64
                and dtype == jnp.dtype(jnp.float32)
                and x_host.size <= _HOST_F64_MAX_ELEMENTS
                and (config.centering or config.whiten)
            )
        if host_f64 and x_host is None:
            raise InvalidDimensionsError(
                "whiten_precision='f64' requires a host (NumPy) input array"
            )

        if not host_f64:
            # Host inputs stay on the host until the target sharding is
            # known: casting with jnp.asarray here would materialize
            # the FULL array on the default device first, which both
            # costs a redundant transfer and caps the fit at
            # single-device memory even under a mesh.
            if isinstance(x, jax.Array):
                x = jnp.asarray(x, dtype)
            else:
                x = np.asarray(x, np.dtype(dtype))
        else:
            x = x_host
        if x.ndim != 2:
            raise InvalidDimensionsError("Input must be a 2-D (n_features, n_samples) matrix")
        n, p = x.shape
        if n == 0 or p == 0:
            raise InvalidDimensionsError("Input matrix cannot be empty")

        sharding = _data_sharding(mesh)
        if sharding is not None:
            n_devices = mesh.devices.size
            if p % n_devices != 0:
                raise InvalidDimensionsError(
                    f"n_samples ({p}) must be divisible by the mesh size "
                    f"({n_devices}) to shard the samples axis; trim to "
                    f"{p - p % n_devices} or pad the data"
                )
            if not host_f64:
                # Shard-direct placement: each device receives only its
                # sample slice (host arrays never touch one device whole).
                x = jax.device_put(x, sharding)
        elif not host_f64 and not isinstance(x, jax.Array):
            x = jnp.asarray(x)

        # RNG (solver.rs:57-60): the reference-matched StdRng/ChaCha12
        # stream (utils/reference_rng.py) — a given random_state draws
        # the SAME w_init the reference draws. A None seed matches the
        # reference's from_rng(rand::rng()) behaviorally (fresh OS
        # entropy each call).
        seed = config.random_state
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2**64))

        requested = min(n, p) if config.n_components is None else config.n_components
        n_components = min(requested, min(n, p))
        extended = config.effective_extended()

        # Problematic-configuration warning (solver.rs:69-74).
        if not isinstance(config.density, Tanh) and extended and not config.ortho:
            warnings.warn(
                "Using a density other than tanh with extended=True and "
                "ortho=False may result in incorrect estimation or numerical "
                "overflow",
                RuntimeWarning,
            )

        if host_f64:
            # Reference-parity path: center+whiten in NumPy f64 on the
            # host, then place the (k, T) result on device in f32.
            x1_64, mean_64, k_64 = preprocess_f64(
                x, n_components, config.centering, config.whiten
            )
            # Cast to the RESOLVED core dtype: an explicit
            # whiten_precision='f64' fit with an f64 core must not be
            # silently downgraded to f32 (the 'auto' path always
            # resolves to f32 so this is an identity cast there).
            # Shard-direct under a mesh (same rationale as above).
            x1_host = x1_64.astype(np.dtype(dtype))
            if sharding is not None:
                x1 = jax.device_put(x1_host, sharding)
            else:
                x1 = jnp.asarray(x1_host)
            x_mean = None if mean_64 is None else jnp.asarray(mean_64, dtype)
            k_matrix = None if k_64 is None else jnp.asarray(k_64, dtype)
        else:
            # Center (solver.rs:77-82) + whiten (solver.rs:85-93), fused
            # into two device executables (ops/whitening.center_whiten).
            x1, x_mean, k_matrix = center_whiten(
                x, n_components, config.centering, config.whiten,
                ensure_owned=True,
            )

            if sharding is not None:
                x1 = jax.lax.with_sharding_constraint(x1, sharding)

        # The raw input is not read again — drop this frame's reference
        # so a device copy WE made (NumPy input path) frees before the
        # optimizer's own buffers allocate. For a caller-owned device
        # array this is a no-op (the caller's reference keeps it alive;
        # that buffer is theirs to hold).
        x = None  # noqa: F841
        actual_components = x1.shape[0]

        # W_init: user-provided (shape-checked, solver.rs:98-111) or
        # random normal + symmetric decorrelation (solver.rs:112-120).
        if config.w_init is not None:
            w_init = jnp.asarray(config.w_init, dtype)
            if w_init.shape != (actual_components, actual_components):
                raise InvalidDimensionsError(
                    f"w_init shape {tuple(w_init.shape)} doesn't match expected "
                    f"({actual_components}, {actual_components})"
                )
        else:
            # Row-major N(0,1) fill from StdRng::seed_from_u64(seed),
            # bit-matching solver.rs:112-120 (sampled in f64 on the
            # host like the reference, then cast to the core dtype).
            # Lazy import: utils/__init__ -> profiling -> solver cycle.
            from .utils import reference_rng

            w_raw = jnp.asarray(
                reference_rng.normal_matrix(
                    seed, actual_components, actual_components
                ),
                dtype,
            )
            w_init, min_eig = sym_decorrelation_with_mineig(w_raw)
            if float(min_eig) < _SYM_DECORR_MIN_EIG:
                raise SingularMatrixError()

        # Warm starts, mutually exclusive (solver.rs:124-137).
        if config.jade_it is not None:
            if config.verbose:
                print(f"Running {config.jade_it} iterations of JADE...",
                      file=sys.stderr)
            w_init, min_eig = jade_jit(
                x1, config.jade_it, 1e-6, config.verbose, data_sharding=sharding
            )
            if float(min_eig) < _SYM_DECORR_MIN_EIG:
                raise SingularMatrixError()
        elif config.fastica_it is not None:
            if config.verbose:
                print(f"Running {config.fastica_it} iterations of FastICA...",
                      file=sys.stderr)
            w_init, min_eig = ica_par_jit(x1, config.density, config.fastica_it, w_init)
            if float(min_eig) < _SYM_DECORR_MIN_EIG:
                raise SingularMatrixError()
            if config.verbose:
                print("FastICA pre-iterations complete.", file=sys.stderr)

        # Pre-rotate the data (solver.rs:140).
        # HIGHEST: a default (bf16) pass here would rewrite the data the
        # core loop then solves to tol=1e-7. x1 is solver-owned on
        # every path here (the host-f64 branch device_puts a fresh
        # array; the device branch passes ensure_owned=True to
        # center_whiten), so when it is a single-device buffer, rotate
        # it IN PLACE (ops/linalg.rotate_rows_inplace — bit-identical
        # to the dot) instead of allocating a second (N, T) array:
        # with the core's donated-X path this keeps the whole
        # unsharded fit at ONE internal data buffer past whitening.
        if (
            sharding is None
            and isinstance(
                getattr(x1, "sharding", None), jax.sharding.SingleDeviceSharding
            )
        ):
            from .ops.linalg import rotate_rows_inplace

            x1 = rotate_rows_inplace(w_init, x1)
        else:
            x1 = jnp.dot(w_init, x1, precision=jax.lax.Precision.HIGHEST)
        if sharding is not None:
            x1 = jax.lax.with_sharding_constraint(x1, sharding)

        # Whitened extended runs use the identity covariance (solver.rs:143-147).
        has_cov = extended and config.whiten
        covariance = jnp.eye(actual_components, dtype=dtype) if has_cov else None

        if config.verbose:
            print("Running Picard...", file=sys.stderr)

        use_pallas = config.use_pallas
        if use_pallas is None:
            use_pallas = _kernel_route(actual_components, dtype)

        opts = CoreOptions(
            density=config.density,
            ortho=config.ortho,
            extended=extended,
            has_cov=has_cov,
            m=config.m,
            ls_tries=config.ls_tries,
            verbose=config.verbose,
            data_sharding=sharding,
            use_pallas=use_pallas,
            kernel_precision=config.kernel_precision,
            # x1 here is always the solver's own pre-rotation product
            # (never the caller's array), and nothing below reads it
            # again — donate it so the final Y = W @ X aliases its
            # buffer (one fewer (N, T) allocation at the peak). Sharded
            # fits keep the non-donating entry (the in-place rotation
            # is single-device-only).
            donate_data=sharding is None,
        )
        # call_donating: filters the 'donated buffers were not usable'
        # dispatch warning on backends that cannot alias (CPU) —
        # donation is a memory optimization, not a semantic need.
        from .ops.linalg import call_donating

        if sharding is None:
            core = call_donating(
                run_core_jit_donated, x1, covariance, config.tol,
                config.lambda_min, config.max_iter, opts,
            )
        else:
            core = run_core_jit(
                x1, covariance, config.tol, config.lambda_min,
                config.max_iter, opts,
            )

        # Compose transforms (solver.rs:169).
        w = jnp.dot(core.w, w_init, precision=jax.lax.Precision.HIGHEST)

        converged = bool(core.converged)
        gradient_norm = float(core.gradient_norm)
        n_iterations = int(core.n_iterations)

        from .models.core import _precision_stages

        stage_precisions = tuple(
            p for p, _ in _precision_stages(opts, jnp.dtype(dtype))
        )
        stage_exits = tuple(int(v) for v in np.asarray(core.stage_exits))
        stage_ls_calls = tuple(int(v) for v in np.asarray(core.stage_ls_calls))
        ls_calls = int(core.ls_calls)

        if config.verbose:
            # Post-fit summary of the precision stages.
            stages = ", ".join(
                f"{p}->it{e}" for p, e in zip(stage_precisions, stage_exits)
            )
            print(
                f"Picard finished: {n_iterations} iterations "
                f"({ls_calls} line-search passes), gradient norm "
                f"{gradient_norm:.4e}, stages [{stages}]",
                file=sys.stderr,
            )

        if not converged:
            if config.raise_on_no_convergence:
                from .errors import NotConvergedError

                raise NotConvergedError(gradient_norm, config.tol, n_iterations)
            if config.verbose:
                print(
                    f"Warning: PICARD did not converge. Final gradient norm: "
                    f"{gradient_norm:.4e}, tolerance: {config.tol:.4e}",
                    file=sys.stderr,
                )

        return PicardResult(
            whitening=k_matrix,
            unmixing=w,
            sources=core.y,
            mean=x_mean,
            n_iterations=n_iterations,
            converged=converged,
            gradient_norm=gradient_norm,
            signs=core.signs if extended else None,
            stage_exits=stage_exits,
            stage_precisions=stage_precisions,
            ls_calls=ls_calls,
            stage_ls_calls=stage_ls_calls,
        )

    @staticmethod
    def transform(x, result: PicardResult) -> jnp.ndarray:
        """Apply a fitted model to new data (solver.rs:199-214)."""
        x = jnp.asarray(x, result.unmixing.dtype)
        if result.mean is not None:
            x = x - result.mean[:, None]
        return jnp.dot(result.full_unmixing(), x,
                       precision=jax.lax.Precision.HIGHEST)
