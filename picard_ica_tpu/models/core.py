"""Core Picard optimizer loop.

Re-design of the reference's imperative hot loop (src/core.rs:162-401)
as a single jitted ``lax.while_loop`` over an immutable carry:

  * **Implicit Y.** The reference carries the rotated data Y and
    rewrites it every accepted step (core.rs:124, 372). Here the loop
    exploits the exact invariant ``Y == W @ X`` (W starts at identity
    and accumulates every line-search transform), so the carry holds
    only the tiny N x N state; the N x T data matrix X is read-only.
    Every data pass fuses the rotation into the moment/log-lik pass
    (the Triton kernel of ops/pallas_kernels.py on the GPU at N <= 64,
    XLA fusions otherwise), so one optimizer iteration reads X once per
    line-search try and writes no N x T array on the kernel path.
  * the L-BFGS memory (Vec push/remove in core.rs:296-312) becomes a
    fixed-shape (m, N, N) ring with a validity count;
  * the backtracking line search with early return (core.rs:99-150)
    becomes an inner ``lax.while_loop`` with an accept flag — a
    rejected try costs one fused loss pass, never a Y' materialization;
  * the gradient-descent fallback (core.rs:349-364) and the extended
    sign-change memory flush (core.rs:317-331) are ``lax.cond``s;
  * the density is a static argument: tanh/exp/cube elementwise math is
    baked into the trace and fused into the data kernels.

Sharding: X may be sharded over a 1-D "samples" mesh axis. The XLA
path relies on GSPMD (contractions become local partials + psum); the
kernel path is wrapped in ``shard_map`` with explicit psums. All N x N
algebra is replicated. Data-pass matmuls default to exact f32 (a
single bf16 pass costs ~3 digits of gradient-norm floor, which matters
at tol near 1e-7 — SURVEY.md §7 hard part c);
``kernel_precision="auto"`` runs a staged bf16 -> bf16x3 -> f32
schedule that spends the expensive exact-f32 passes only on the final
iterations (see _precision_stages).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.densities import Density
from ..ops.linalg import expm_pow2_chain, matrix_exp, skew_symmetric
from ..ops.moments import (
    RawMoments,
    _row_mean,
    compute_raw_moments_xla,
    loglik_rowmeans_xla,
)

# Penalty loss for singular/failed evaluations (core.rs:90-96).
_SINGULAR_LOSS = 1e15
# Hard-coded fallback line-search tries (core.rs:361).
_FALLBACK_LS_TRIES = 10


@dataclasses.dataclass(frozen=True)
class CoreOptions:
    """Static (trace-time) configuration of the core loop."""

    density: Density
    ortho: bool
    extended: bool
    has_cov: bool
    m: int
    ls_tries: int
    verbose: bool = False
    data_sharding: Any = None  # optional NamedSharding (None, "samples") for X
    use_pallas: bool = False
    # Matmul precision of the data pass (ops/precision.py): "auto" =
    # staged bf16 -> bf16x3 -> f32 schedule (see _precision_stages),
    # "f32" = exact f32 dots throughout (the conservative default for
    # direct CoreOptions users), "bf16x3"/"bf16" pin a single tier
    # (gradient floors ~1.5e-7 / ~1.2e-4 with the analytic delta cap
    # the reachable tolerance). All tiers are HIGHEST at f64.
    kernel_precision: str = "f32"
    # Stall patience for NON-FINAL precision stages (0 disables; always
    # 0 for the final stage, which keeps the reference's run-to-max_iter
    # semantics). A tier at its data-dependent noise floor is detected
    # by either signal:
    #   * a line-search failure (GD fallback) — at the floor the
    #     measured gradient is noise and even -G fails; in healthy
    #     phases fallbacks are rare, or
    #   * no gradient-norm improvement for `stage_patience` iterations
    #     while within 20x of the tier's handoff threshold (early
    #     trajectories are legitimately non-monotone, so far-from-floor
    #     plateaus don't exit until 3x the patience).
    stage_patience: int = 0
    # Backtracking tries per line search (primary + GD fallback) for
    # this stage. The final stage always runs the reference's
    # (ls_tries, 10) semantics; NON-final cheap tiers cap both at 3 —
    # at a tier's noise floor the direction is noise and every
    # additional halved-alpha try is a wasted full pass over X
    # (measured: uncapped, one noisy stage exit costs ~40 passes).
    fallback_ls_tries: int = _FALLBACK_LS_TRIES
    # PLAIN line-search accept (cheap tiers only): evaluate the
    # candidate's absolute log-lik row sums in the fused pass (one
    # rotation dot, ~half the transcendentals) and accept on a direct
    # f32 loss subtraction. Resolution ~1e-4 absolute — ample down to
    # the bf16 tier's handoff; the accurate tiers keep the
    # cancellation-free delta form (see ops/pallas_kernels.py).
    # STAGE-MANAGED: run_core overwrites this per precision stage
    # (True only for a non-final bf16 tier); a user-constructed value
    # only takes effect when calling the stage bodies directly.
    plain_ls: bool = False
    # Start the primary line search at min(1, 2 * last accepted alpha)
    # instead of always 1 (cheap tiers only; the final stage keeps the
    # reference's alpha=1 semantics). Mid-trajectory steps routinely
    # need alpha ~ 1/8: restarting from 1 costs 3-4 rejected full
    # passes over X per iteration.
    # STAGE-MANAGED like plain_ls (True for every non-final tier).
    adaptive_alpha: bool = False
    # The caller donates X (run_core_jit_donated) and does not reuse it:
    # the final Y = W @ X is then written back THROUGH X's buffer via
    # the blockwise in-place rotation (ops/linalg.
    # rotate_rows_inplace_blocks — bit-identical to the full dot),
    # removing one data-sized output allocation from the program peak.
    # Single-device only (the solver sets it when unsharded); ignored
    # under data_sharding.
    donate_data: bool = False


class LbfgsMemory(NamedTuple):
    """Fixed-shape L-BFGS ring: slot j < count holds the j-th oldest pair."""

    s_mem: jnp.ndarray  # (m, N, N)
    y_mem: jnp.ndarray  # (m, N, N)
    r_mem: jnp.ndarray  # (m,)
    count: jnp.ndarray  # i32 scalar


class CoreState(NamedTuple):
    w: jnp.ndarray  # (N, N) replicated; Y == W @ X implicitly
    loss: jnp.ndarray
    signs: jnp.ndarray  # (N,)
    old_signs: jnp.ndarray  # (N,)
    c: jnp.ndarray  # (N, N) extended covariance proxy
    g_old: jnp.ndarray  # (N, N)
    prev_step: jnp.ndarray  # (N, N)
    memory: LbfgsMemory
    # Raw moments of Y = W @ X, produced by the previous line search's
    # fused pass (or the init pass at it == 0) — the iteration body
    # never runs its own moments kernel.
    moments: Any  # RawMoments
    it: jnp.ndarray  # i32
    n_iter_done: jnp.ndarray  # i32
    gradient_norm: jnp.ndarray
    converged: jnp.ndarray  # bool
    # Stall tracking for staged-precision handoff (reset per stage).
    best_gnorm: jnp.ndarray
    since_improve: jnp.ndarray  # i32
    consec_fallbacks: jnp.ndarray  # i32
    # Cumulative fused line-search passes (accepted + rejected tries,
    # incl. fallback) — each is one streaming read of X; the dominant
    # cost driver and the key per-run efficiency diagnostic.
    ls_calls: jnp.ndarray  # i32
    # log2 exponent of the last accepted step size (adaptive-alpha
    # warm start for the next primary line search in cheap tiers).
    prev_alpha_exp: jnp.ndarray  # i32


class CoreResult(NamedTuple):
    y: jnp.ndarray
    w: jnp.ndarray
    converged: jnp.ndarray
    gradient_norm: jnp.ndarray
    n_iterations: jnp.ndarray
    signs: jnp.ndarray
    # (n_stages,) iteration count at each precision-stage exit
    # (diagnostics; a single entry for pinned precisions).
    stage_exits: jnp.ndarray
    # Total fused line-search passes over X (tries incl. fallbacks).
    ls_calls: jnp.ndarray
    # (n_stages,) CUMULATIVE ls_calls at each stage exit — with
    # stage_exits this gives per-tier pass counts, the call-count side
    # of the headline cost model (calls x per-tier ms, DESIGN.md §6).
    stage_ls_calls: jnp.ndarray


_HI = jax.lax.Precision.HIGHEST


def _dot(a, b):
    return jnp.dot(a, b, precision=_HI)


def _interpret() -> bool:
    """Whether the fused Pallas kernel runs in interpret mode.

    Only on the CPU (tests and rehearsals). On the GPU the kernel
    compiles through Triton; any other backend has no route for it.
    """
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"the fused Pallas kernel has no route for {backend!r}")


def _work_dtype(x):
    """Scalar/output dtype for a data pass: the cheap tier may hand the
    kernels a bf16 copy of X (halved HBM traffic), but every
    reduction, loss scalar and N x N quantity stays f32."""
    return jnp.float32 if x.dtype == jnp.bfloat16 else x.dtype


# ---------------------------------------------------------------------------
# Fused data-axis passes: rotate + score/log-lik + reduce over T.
# ---------------------------------------------------------------------------


def _shard_mapped(local_fn, sharding, x, *replicated, critical_first=False):
    """Run ``local_fn(x_shard, *replicated)`` per shard, psum the outputs.

    ``critical_first=N`` (int) reduces the first N outputs with their
    own psum and orders the remaining psums after them through an
    optimization barrier. The fused line-search pass uses this:
    outputs 0-1 are the tiny per-row loss deltas (dll, dysq) the
    accept branch waits on, the rest are the N x N moments consumed
    only by the NEXT iteration — the barrier stops XLA's all-reduce
    combiner from folding the moment payload into the accept-critical
    collective, so the accept path waits on ~2N floats while the
    moment all-reduce remains free to overlap with later compute
    (BASELINE north-star overlap clause; HLO evidence in
    docs/DESIGN.md §4).
    """
    from jax.sharding import PartitionSpec as P

    from ..parallel.sharding import shard_map_replicated

    mesh = sharding.mesh
    axis = sharding.spec[1]

    def wrapped(x_local, *reps):
        outs = local_fn(x_local, *reps)
        if critical_first:
            nc = int(critical_first)
            head = tuple(lax.psum(o, axis) for o in outs[:nc])
            # A real data dependency, not an optimization barrier (some
            # backend pipelines strip opt-barriers before the
            # all-reduce combiner runs): gate the moment psums on the
            # accept payload having arrived. ``gate`` is exactly 0.0
            # unless the payload is NaN (a NaN payload already poisons
            # the accept test itself), so values are unchanged — but
            # its dependence on ``head`` would make merging the two
            # collectives a cycle, which no combiner pass can form.
            # Gate on NaN only, NOT inf: an overflowed (inf-dll)
            # rejected candidate still carries usable last-tried
            # moments that the GD fallback path must not see poisoned.
            h0 = head[0].ravel()[0]
            gate = jnp.where(jnp.isnan(h0), jnp.nan, 0.0).astype(
                outs[nc].dtype
            )
            return head + tuple(lax.psum(o + gate, axis) for o in outs[nc:])
        return tuple(lax.psum(o, axis) for o in outs)

    n_rep = len(replicated)
    kwargs = dict(
        mesh=mesh,
        in_specs=(P(None, axis),) + (P(),) * n_rep,
        out_specs=P(),
    )
    return shard_map_replicated(wrapped, **kwargs)(x, *replicated)


def data_moments(w, x, opts: CoreOptions, need_h: bool, need_ysq: bool) -> RawMoments:
    """Normalized moments of Y = W @ X (core.rs:215-276 quantities):
    G = E[psi(Y) Y^T], pm = E[psi'(Y)], H = E[psi'(Y) (Y^2)^T],
    ysq = E[Y^2] — all computed in one streaming pass over X."""
    # GSPMD shards the contractions automatically. The shared
    # ops.moments implementation IS the oracle-lockstep semantics (one
    # definition to keep in step with oracle.cpp). It runs at init and
    # at stage boundaries only, so it has no kernel of its own.
    return compute_raw_moments_xla(_dot(w, x), opts.density, need_h, need_ysq)


def data_loglik(m, x, opts: CoreOptions, need_ysq: bool):
    """(E[log_lik(M X)] per row, E[(M X)^2] per row) in one pass."""
    y = _dot(m, x)
    ll = loglik_rowmeans_xla(y, opts.density)
    ysq = _row_mean(y * y) if need_ysq else jnp.zeros_like(ll)
    return ll, ysq


def data_fused_step(m_new, m_old, x, opts: CoreOptions, need_h: bool, need_ysq: bool):
    """One line-search try + speculative next-iteration moments.

    Returns ``(dll_means, dysq_means, RawMoments(of M_new @ X))`` in a
    single streaming pass over X. The loss delta is evaluated per
    element, inside the kernel; the moments are the raw
    (sign-free) quantities of the CANDIDATE, so an accepted try hands
    the next optimizer iteration its moment pass for free — the
    standalone moments pass runs only at initialization and at
    precision-stage boundaries.
    """
    n, t = x.shape
    dtype = _work_dtype(x)
    inv_t = jnp.asarray(1.0 / t, dtype)

    if opts.use_pallas:
        from ..ops.pallas_kernels import rotated_fused_sums

        interp = _interpret()

        def local(x_local, mn, mo):
            return rotated_fused_sums(
                mn, mo, x_local, opts.density, need_h, need_ysq,
                interpret=interp, precision=opts.kernel_precision,
                absolute_ll=opts.plain_ls,
            )

        if opts.data_sharding is not None:
            dll, dysq, g, pm, h, ysq = _shard_mapped(
                local, opts.data_sharding, x, m_new, m_old,
                critical_first=2,
            )
        else:
            dll, dysq, g, pm, h, ysq = local(x, m_new, m_old)
        return (
            dll * inv_t,
            dysq * inv_t,
            RawMoments(g * inv_t, pm * inv_t, h * inv_t, ysq * inv_t),
        )

    # Same formulations as the kernel. Delta mode rotates the delta
    # matrix and evaluates the loss change analytically from
    # (y_old, dy), so the error is relative to |dy| instead of |ll|;
    # plain mode (cheap tiers) evaluates absolute row means. The
    # N x N x T matmuls run at the stage's precision tier
    # (ops/precision.py); row means stay HIGHEST.
    from ..ops.precision import matmul_tiered

    def tdot(a, b):
        return matmul_tiered(a, b, dtype, opts.kernel_precision)

    if opts.plain_ls:
        y_new = tdot(m_new, x)
        psi, psi_d, ll_el = opts.density.score_der_loglik(y_new)
        dll = _row_mean(ll_el)
        dysq = (
            _row_mean(y_new * y_new) if need_ysq
            else jnp.zeros((n,), dtype)
        )
    else:
        y_old = tdot(m_old, x)
        dy = tdot(m_new - m_old, x)
        y_new = y_old + dy
        psi, psi_d, dll_el = opts.density.score_der_loglik_delta(y_old, dy)
        dll = _row_mean(dll_el)
        dysq = (
            _row_mean((2.0 * y_old + dy) * dy) if need_ysq
            else jnp.zeros((n,), dtype)
        )
    g = tdot(psi, y_new.T) * inv_t
    pm = _row_mean(psi_d)
    if need_h:
        ysq_new = y_new * y_new
        h = tdot(psi_d, ysq_new.T) * inv_t
    else:
        h = jnp.zeros((n, n), dtype)
    ysq_new_mean = (
        _row_mean(y_new * y_new) if need_ysq
        else jnp.zeros((n,), dtype)
    )
    return dll, dysq, RawMoments(g, pm, h, ysq_new_mean)


def compute_loss(w, x, signs, opts: CoreOptions):
    """Negative log-likelihood objective of Y = W @ X (core.rs:39-85).

    Singular W maps to the 1e15 penalty (core.rs:90-96) instead of an
    error so the line search steers away from it.
    """
    dtype = _work_dtype(x)
    need_ysq = opts.extended and not opts.ortho
    ll_means, ysq_means = data_loglik(w, x, opts, need_ysq)

    if not opts.ortho:
        sign, log_abs_det = jnp.linalg.slogdet(w)
        logdet_term = jnp.where(
            sign == 0,
            jnp.asarray(_SINGULAR_LOSS, dtype),
            -log_abs_det.astype(dtype),
        )
    else:
        logdet_term = jnp.asarray(0.0, dtype)

    loss = logdet_term + jnp.sum(signs * ll_means)
    if need_ysq:
        loss = loss + 0.5 * jnp.sum(ysq_means)
    return loss


# ---------------------------------------------------------------------------
# Replicated N x N pieces: L-BFGS, Hessian helpers, line search.
# ---------------------------------------------------------------------------


def _push_memory(mem: LbfgsMemory, s, y, r, do_push) -> LbfgsMemory:
    """Append (s, y, r); evict the oldest when full (core.rs:296-312)."""
    m = mem.s_mem.shape[0]
    full = mem.count >= m
    s_mem = jnp.where(full, jnp.roll(mem.s_mem, -1, axis=0), mem.s_mem)
    y_mem = jnp.where(full, jnp.roll(mem.y_mem, -1, axis=0), mem.y_mem)
    r_mem = jnp.where(full, jnp.roll(mem.r_mem, -1, axis=0), mem.r_mem)
    idx = jnp.where(full, m - 1, mem.count)
    s_mem = s_mem.at[idx].set(s)
    y_mem = y_mem.at[idx].set(y)
    r_mem = r_mem.at[idx].set(r)
    count = jnp.minimum(mem.count + 1, m)
    return LbfgsMemory(
        jnp.where(do_push, s_mem, mem.s_mem),
        jnp.where(do_push, y_mem, mem.y_mem),
        jnp.where(do_push, r_mem, mem.r_mem),
        jnp.where(do_push, count, mem.count),
    )


def solve_hessian_system(h, h_off, g):
    """Pairwise 2x2 Hessian solves, vectorized (lbfgs.rs:136-150).

    result[i,j] = (h[j,i]*g[i,j] - h_off[i]*g[j,i]) / det with
    det = h[i,j]*h[j,i] - h_off[i]*h_off[j]; entries with |det|<=1e-15
    are zero.
    """
    det = h * h.T - jnp.outer(h_off, h_off)
    numer = h.T * g - h_off[:, None] * g.T
    safe_det = jnp.where(jnp.abs(det) > 1e-15, det, 1.0)
    return jnp.where(jnp.abs(det) > 1e-15, numer / safe_det, 0.0)


def regularize_hessian(h, h_off, lambda_min):
    """Eigenvalue-floor the 2x2 Hessian blocks (lbfgs.rs:155-171).

    Off-diagonal entries only; the smaller eigenvalue of the (i,j)
    block is lifted to lambda_min. The reference scans entries in
    row-major order MUTATING h as it goes, so a lower-triangle entry
    (p, q), p > q, computes its eigenvalue from the ALREADY-BUMPED
    upper partner h[q, p] (bumped when row q was scanned) while every
    upper entry sees only originals. That order is exactly two
    vectorized phases: bump the upper triangle from the original h,
    then bump the lower triangle against the phase-1 result.
    """
    n = h.shape[0]
    i = jnp.arange(n)
    upper = i[:, None] < i[None, :]
    lower = i[:, None] > i[None, :]
    off = jnp.outer(h_off, h_off)

    def bump(entries, partners, mask):
        diff = entries - partners
        discr = jnp.sqrt(diff * diff + 4.0 * off)
        eigenvalue = 0.5 * (entries + partners - discr)
        return jnp.where(mask & (eigenvalue < lambda_min),
                         lambda_min - eigenvalue, 0.0)

    h1 = h + bump(h, h.T, upper)
    return h1 + bump(h, h1.T, lower)


def compute_direction(g, h, h_off, mem: LbfgsMemory, opts: CoreOptions):
    """L-BFGS two-loop recursion with the sparse-Hessian preconditioner
    as the initial inverse-Hessian guess (lbfgs.rs:84-133).

    Both loops are unrolled (m is a static trace-time constant, default
    7): a ``fori_loop`` over dynamically-indexed (m, N, N) gathers is a
    chain of tiny sequential ops, while the unrolled form is static
    slices XLA schedules as one fused chain.
    Invalid slots (>= count) are masked with ``where``.
    """
    m = mem.s_mem.shape[0]
    dtype = g.dtype

    # Backward pass: newest (count-1) -> oldest (0). Slot j is valid
    # iff j < count.
    q = g
    alphas = [None] * m
    for j in range(m - 1, -1, -1):
        valid = j < mem.count
        a = mem.r_mem[j] * jnp.sum(mem.s_mem[j] * q)
        alphas[j] = a
        q = jnp.where(valid, q - a * mem.y_mem[j], q)

    if opts.ortho:
        z = q / h
        z = (z - z.T) / 2.0
    else:
        z = solve_hessian_system(h, h_off, q)

    # Forward pass: oldest (0) -> newest (count-1).
    for j in range(m):
        valid = j < mem.count
        beta = mem.r_mem[j] * jnp.sum(mem.y_mem[j] * z)
        z = jnp.where(valid, z + (alphas[j] - beta) * mem.s_mem[j], z)
    return -z


_ALPHA_EXP_CAP = 6  # adaptive initial alpha never starts below 2^-6


def line_search(x, w, direction, signs, current_loss, ls_tries, opts: CoreOptions,
                accept_slack=None, max_tries=None, init_alpha_exp=None):
    """Backtracking line search (core.rs:99-150), Y kept implicit.

    Tries alpha = 1, 1/2, 1/4, ... accepting the first loss decrease.
    The accept test ``loss_new < loss_current`` (core.rs:130) is
    evaluated as ``delta < 0``: the density term's cancellation happens
    per element inside a fused kernel, and the log-det term's
    cancellation is exact algebra —
    ``log|det(Tm W)| - log|det W| = log|det Tm|`` — so arbitrarily
    small true decreases remain resolvable in f32. On failure the
    returned (w, loss) are from the *last tried* alpha while the
    returned step uses the once-more-halved alpha — matching the
    reference exactly (core.rs:117-149).

    Every try runs the FUSED pass: loss delta + raw moments of the
    candidate in one pass over X. The returned moments always belong
    to the returned w (accepted or last-tried), so the caller feeds
    them straight into the next iteration — accepted tries make the
    per-iteration moments pass free.
    """
    n = w.shape[0]
    dtype = _work_dtype(x)
    eye = jnp.eye(n, dtype=dtype)
    need_h = not opts.ortho
    need_ysq = opts.extended and not opts.ortho
    # accept_slack > 0 reproduces the reference's STALE baseline at the
    # first extended iteration (see _iteration_update): accept when
    # loss(candidate, new signs) < current_loss + slack.
    if accept_slack is None:
        accept_slack = jnp.asarray(0.0, dtype)

    # f32 ortho: ALL candidate rotations expm(2^-k D) come from one
    # shared scaling-squaring chain computed up front (ops/linalg.py::
    # expm_pow2_chain) — per-try expm was the dominant N x N dispatch
    # cost (~2 ms/try at N=64). f64 keeps the per-try reference-exact
    # matrix_exp for oracle lockstep.
    #
    # Accuracy guard on final-semantics tiers (adaptive_alpha=False —
    # the reference-exact stage, and any direct CoreOptions caller):
    # the chain's shared over-scaled base amplifies f32 rounding
    # through its ~(s1 + n_alphas) squarings — measured ~2.6e-5
    # transform error (5e-4 non-orthogonality) at max|D| ~ 0.06-0.5 vs
    # ~1e-7 for per-try matrix_exp. Large-|D| directions only occur in
    # EARLY iterations (pinned-f32 fits; the auto schedule's final
    # tier sees |D| ~ gnorm ~ 1e-5 where the chain is eps-accurate),
    # so gate on the norm: below 2^-10 read the chain, above it pay
    # the per-try expm. Cheap tiers always read the chain — their own
    # noise floors (>= ~1e-7) dominate its error.
    if init_alpha_exp is None:
        init_alpha_exp = jnp.asarray(0, jnp.int32)
    use_chain = (
        opts.ortho and dtype != jnp.float64 and max_tries is not None
    )
    if use_chain:
        chain, chain_top = expm_pow2_chain(
            direction, int(max_tries) + _ALPHA_EXP_CAP
        )
        if not opts.adaptive_alpha:
            chain_accurate = (
                jnp.max(jnp.abs(direction)) <= jnp.asarray(2.0**-10, dtype)
            )

    def try_alpha(alpha, k):
        if opts.ortho:
            if use_chain and opts.adaptive_alpha:
                # Cheap tiers: always the chain (no fallback compiled).
                tm = chain[chain_top - init_alpha_exp - k]
            elif use_chain:
                tm = lax.cond(
                    chain_accurate,
                    lambda: chain[chain_top - init_alpha_exp - k],
                    lambda: matrix_exp(direction * alpha),
                )
            else:
                tm = matrix_exp(direction * alpha)
        else:
            tm = eye + alpha * direction
        w_new = _dot(tm, w)

        dll, dysq, moments = data_fused_step(w_new, w, x, opts, need_h, need_ysq)
        if opts.plain_ls:
            # dll/dysq hold the candidate's ABSOLUTE row means; accept
            # on a direct subtraction against the carried loss.
            loss_new = jnp.sum(signs * dll)
            if need_ysq:
                loss_new = loss_new + 0.5 * jnp.sum(dysq)
            if not opts.ortho:
                sign_w, log_abs_w = jnp.linalg.slogdet(w_new)
                loss_new = loss_new + jnp.where(
                    sign_w == 0,
                    jnp.asarray(_SINGULAR_LOSS, dtype),
                    -log_abs_w.astype(dtype),
                )
            delta = loss_new - current_loss
        else:
            delta = jnp.sum(signs * dll)
            if need_ysq:
                delta = delta + 0.5 * jnp.sum(dysq)
            if not opts.ortho:
                # -log|det W_new| + log|det W| == -log|det Tm|; a
                # singular candidate gets the 1e15 penalty
                # (core.rs:90-96).
                sign_tm, log_abs_tm = jnp.linalg.slogdet(tm)
                delta = delta + jnp.where(
                    sign_tm == 0,
                    jnp.asarray(_SINGULAR_LOSS, dtype),
                    -log_abs_tm.astype(dtype),
                )
        return w_new, delta, moments

    def cond(carry):
        alpha, tries, success, _, _, _ = carry
        return (~success) & (tries < ls_tries)

    def body(carry):
        alpha, tries, _, _, _, _ = carry
        w_new, delta, moments = try_alpha(alpha, tries)
        success = delta < accept_slack
        next_alpha = jnp.where(success, alpha, alpha / 2.0)
        return (next_alpha, tries + 1, success, w_new, delta, moments)

    zero_moments = RawMoments(
        jnp.zeros((n, n), dtype), jnp.zeros((n,), dtype),
        jnp.zeros((n, n), dtype), jnp.zeros((n,), dtype),
    )
    init = (
        jnp.exp2(-init_alpha_exp).astype(dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        w,
        jnp.asarray(0.0, dtype),
        zero_moments,
    )
    alpha, tries, success, w_new, delta, moments = lax.while_loop(cond, body, init)
    step = direction * alpha
    last_exp = init_alpha_exp + tries - 1
    return success, w_new, current_loss + delta, step, moments, tries, last_exp


# ---------------------------------------------------------------------------
# The iteration body and driver.
# ---------------------------------------------------------------------------


def _iteration_update(st: CoreState, x, g, h, h_off, signs, old_signs, sign_change,
                      gradient_norm, covariance, lambda_min, opts: CoreOptions) -> CoreState:
    """Post-convergence-check part of one iteration (core.rs:296-390)."""
    # L-BFGS memory push with the previous step (core.rs:296-313).
    y_diff = g - st.g_old
    denom = jnp.sum(st.prev_step * y_diff)
    r = 1.0 / denom
    do_push = (st.it > 0) & jnp.isfinite(r)
    memory = _push_memory(st.memory, st.prev_step, y_diff, r, do_push)

    # Extended sign change: re-baseline the loss, flush memory
    # (core.rs:317-331). Singular here is a 1e15 penalty, not an error.
    # A real lax.cond: the re-baseline is a full data pass (rotate +
    # log-lik) and sign changes are rare — evaluating it eagerly and
    # select-ing would cost every iteration an extra pass over X.
    if opts.extended:
        def flush(_):
            new_loss = compute_loss(st.w, x, signs, opts)
            new_loss = jnp.where(
                jnp.isfinite(new_loss), new_loss, st.loss.dtype.type(_SINGULAR_LOSS)
            )
            return new_loss, jnp.zeros_like(memory.count)

        def keep(_):
            return st.loss, memory.count

        current_loss, mem_count_flushed = lax.cond(
            sign_change, flush, keep, operand=None
        )
        memory = LbfgsMemory(
            memory.s_mem, memory.y_mem, memory.r_mem, mem_count_flushed
        )

        # First-iteration stale baseline (reference quirk, core.rs): at
        # it == 0 a sign flip does NOT re-baseline the loss (the
        # sign_change guard is it > 0), so the reference's line search
        # compares loss(candidate, NEW signs) against the init loss
        # computed with signs == ones. Reproduce it exactly:
        # loss(W, ones) - loss(W, new) = sum_i (1 - signs_i) E[ll_i(W)],
        # fed to the line search as current_loss = loss(W, new) plus an
        # accept slack of the same amount.
        def stale_offset(_):
            ll_means, _ = data_loglik(st.w, x, opts, False)
            return jnp.sum((1.0 - signs) * ll_means)

        def no_offset(_):
            return jnp.asarray(0.0, st.loss.dtype)

        it0_flip = (st.it == 0) & jnp.any(signs < 0)
        accept_slack = lax.cond(it0_flip, stale_offset, no_offset, operand=None)
        current_loss = current_loss - accept_slack
    else:
        current_loss = st.loss
        accept_slack = jnp.asarray(0.0, st.loss.dtype)

    direction = compute_direction(g, h, h_off, memory, opts)

    if opts.adaptive_alpha:
        init_exp = jnp.clip(st.prev_alpha_exp - 1, 0, _ALPHA_EXP_CAP)
    else:
        init_exp = jnp.asarray(0, jnp.int32)

    (success, ls_w, ls_loss, ls_step, ls_moments, ls_tries_used,
     ls_last_exp) = line_search(
        x, st.w, direction, signs, current_loss,
        jnp.asarray(opts.ls_tries, jnp.int32), opts,
        accept_slack=accept_slack, max_tries=opts.ls_tries,
        init_alpha_exp=init_exp,
    )

    # Gradient-descent fallback on line-search failure (core.rs:349-364):
    # clear memory and retry with -G for 10 tries; take its result even
    # if it also fails.
    def with_fallback(_):
        _, fb_w, fb_loss, fb_step, fb_moments, fb_tries, _fb_exp = line_search(
            x, st.w, -g, signs, current_loss,
            jnp.asarray(opts.fallback_ls_tries, jnp.int32), opts,
            accept_slack=accept_slack, max_tries=opts.fallback_ls_tries,
        )
        return (fb_w, fb_loss, fb_step, jnp.zeros_like(memory.count),
                fb_moments, ls_tries_used + fb_tries,
                jnp.asarray(0, jnp.int32))

    def without_fallback(_):
        return (ls_w, ls_loss, ls_step, memory.count, ls_moments,
                ls_tries_used, ls_last_exp)

    (new_w, new_loss, step, mem_count, new_moments, tries_total,
     new_alpha_exp) = lax.cond(
        ~success, with_fallback, without_fallback, operand=None
    )
    memory = LbfgsMemory(memory.s_mem, memory.y_mem, memory.r_mem, mem_count)

    # Extended covariance proxy update C = W cov W^T (core.rs:375-379);
    # only when an explicit covariance was supplied.
    if opts.extended and opts.has_cov:
        c = _dot(_dot(new_w, covariance), new_w.T)
    else:
        c = st.c

    if opts.verbose:
        # Reference per-iteration print (core.rs:383-390).
        jax.debug.print(
            "iteration {it}, gradient norm = {gn:.4e}, loss = {l:.4e}",
            it=st.it + 1, gn=gradient_norm, l=new_loss,
        )

    return CoreState(
        w=new_w,
        loss=new_loss,
        signs=signs,
        old_signs=old_signs,
        c=c,
        g_old=g,
        prev_step=step,
        memory=memory,
        moments=new_moments,
        it=st.it + 1,
        n_iter_done=st.it + 1,
        gradient_norm=gradient_norm,
        converged=jnp.asarray(False),
        best_gnorm=st.best_gnorm,
        since_improve=st.since_improve,
        consec_fallbacks=jnp.where(
            success, jnp.zeros_like(st.consec_fallbacks),
            st.consec_fallbacks + 1,
        ),
        ls_calls=st.ls_calls + tries_total,
        prev_alpha_exp=new_alpha_exp,
    )


def _iteration_body(st: CoreState, x, covariance, tol, lambda_min, opts: CoreOptions) -> CoreState:
    """One full optimizer iteration (core.rs:211-391).

    The moments of Y = W @ X arrive in the carry: the previous line
    search's fused pass computed them for the W it returned (the init
    pass seeds iteration 0), so the body starts directly with the
    N x N algebra.
    """
    n = st.w.shape[0]
    dtype = _work_dtype(x)

    moments = st.moments
    g = moments.g_raw
    pm0 = moments.pm_raw

    if opts.extended:
        # Kurtosis-based sub/super-Gaussian sign detection (core.rs:225-237).
        k = pm0 * jnp.diagonal(st.c) - jnp.diagonal(g)
        # f64::signum maps +0.0 -> 1.0; match that, not jnp.sign's 0.
        # Deliberate deviation at the measure-zero knife edge k == -0.0
        # (Rust signum gives -1.0 there; ``-0.0 >= 0`` is True here and
        # in the C++ oracle, so both OUR implementations agree) — and a
        # NaN k maps to -1 rather than propagating, which the singular
        # 1e15 loss path catches downstream anyway.
        signs = jnp.where(k >= 0, 1.0, -1.0).astype(dtype)
        sign_change = (st.it > 0) & jnp.any(signs != st.old_signs)
        old_signs = signs
        g = signs[:, None] * g
        pm = pm0 * signs  # row-sign-flipped E[psi']
    else:
        signs = st.signs
        old_signs = st.old_signs
        sign_change = jnp.asarray(False)
        pm = pm0

    if opts.extended and not opts.ortho:
        g = g + st.c
        # psi' += 1 folds into the Hessian moment below.

    # Hessian pieces (core.rs:256-276).
    if opts.ortho:
        h_off = jnp.diagonal(g)
        h = 0.5 * (pm[:, None] + pm[None, :] - h_off[:, None] - h_off[None, :])
        h = jnp.maximum(h, lambda_min)
    else:
        h_off = jnp.ones((n,), dtype)
        h = moments.h_raw
        if opts.extended:
            # (signs*psi' + 1) (Y^2)^T / T  ==  signs*H_raw + row-broadcast E[Y^2].
            h = signs[:, None] * h + moments.ysq_rowmean[None, :]
        h = regularize_hessian(h, h_off, lambda_min)

    # Project the gradient (core.rs:280-286).
    if opts.ortho:
        g = skew_symmetric(g)
    else:
        g = g - jnp.eye(n, dtype=dtype)

    gradient_norm = jnp.max(jnp.abs(g))
    converged = gradient_norm < tol

    # Non-final precision stages also exit when the tier stalls at its
    # (data-dependent) noise floor: two consecutive line-search
    # fallbacks, or a gradient-norm plateau NEAR THE FLOOR. The
    # near-floor gate (gnorm < 20x the tier's handoff threshold)
    # matters: early trajectories are legitimately non-monotone for
    # ~10 iterations, and an ungated plateau detector exits the cheap
    # tiers during that warmup — shunting the whole descent to the
    # expensive f32 tier (measured: 16 f32 iterations instead of 2 at
    # N=64/T=4M, a 1.5x headline regression). A long-stall escape
    # hatch (3x patience, any gnorm) still bounds a tier that truly
    # wedges above its floor. Disabled (patience 0) for the final
    # stage — the reference runs to max_iter.
    if opts.stage_patience > 0:
        improved = gradient_norm < st.best_gnorm * 0.99
        best_gnorm = jnp.minimum(st.best_gnorm, gradient_norm)
        since_improve = jnp.where(
            improved, jnp.zeros_like(st.since_improve), st.since_improve + 1
        )
        near_floor = gradient_norm < 20.0 * tol
        converged = converged | (
            (since_improve >= opts.stage_patience) & near_floor
        )
        converged = converged | (since_improve >= 3 * opts.stage_patience)
        # A failed line search near the floor IS the floor signal —
        # exit at once (capped fallback keeps the failing iteration
        # cheap). Far from the floor a single failure can be a genuine
        # deep backtrack; only repeated failure exits there. The
        # single-failure gate is TIGHT (3x the handoff, ~7x the
        # floor), not the plateau gate's 20x: an early-descent
        # fallback at gnorm ~5e-3 is a backtrack, not a floor signal,
        # and exiting on it forfeits the whole cheap tier (measured,
        # seed-43 stream at N=64: a lone iteration-3 fallback under
        # the 20x gate exited bf16 at stage_exits=[3,..] and the fit
        # ran 30 bf16x3 iterations the bf16 tier should have eaten —
        # 2.3e8 vs seed-42's 6.5e8 samples/s).
        converged = converged | (
            (st.consec_fallbacks >= 1) & (gradient_norm < 3.0 * tol)
        )
        converged = converged | (st.consec_fallbacks >= 2)
    else:
        best_gnorm = st.best_gnorm
        since_improve = st.since_improve

    st = st._replace(best_gnorm=best_gnorm, since_improve=since_improve)

    def finish(_):
        return st._replace(
            signs=signs,
            old_signs=old_signs,
            n_iter_done=st.it + 1,
            gradient_norm=gradient_norm,
            converged=jnp.asarray(True),
        )

    def proceed(_):
        return _iteration_update(
            st, x, g, h, h_off, signs, old_signs, sign_change,
            gradient_norm, covariance, lambda_min, opts,
        )

    return lax.cond(converged, finish, proceed, operand=None)


def init_state(x, covariance, opts: CoreOptions, x_stage=None):
    """Build the initial carry (core.rs:176-209).

    Returns (state, initial_singular) — the reference errors out if the
    very first loss evaluation hits a singular W (core.rs:188-193);
    with W = I that is unreachable, but the flag is surfaced anyway.

    ``x_stage`` is the first precision stage's data copy (the bf16 X
    of the plain-accept tier): the initial loss baseline and moments
    must come from the SAME copy the stage's accept tests evaluate
    candidates on, or iteration 0's plain accept compares
    loss(bf16-rounded data) against loss(f32 data) and the systematic
    E[log-lik] offset between the two datasets biases the first
    accept. The extended-mode covariance Gram below always uses the
    full-precision ``x`` — it seeds sign estimation for the WHOLE fit
    and is never re-measured at stage boundaries.
    """
    n, t = x.shape
    dtype = x.dtype
    xs = x if x_stage is None else x_stage
    w = jnp.eye(n, dtype=dtype)
    signs = jnp.ones((n,), dtype)

    need_h = not opts.ortho
    need_ysq = opts.extended and not opts.ortho
    if opts.plain_ls:
        # Plain-accept stage (the auto schedule's bf16 tier): ONE
        # fused pass yields the loss terms and iteration 0's moments
        # together — and it is the SAME kernel the stage's accept
        # tests run, so the baseline is bit-identical to candidate
        # evaluations AND the standalone loglik/moments kernels drop
        # out of the fit's cold-compile surface. slogdet(I) == 0
        # exactly, so the loss is just the density (+ extended)
        # terms.
        ll_means, ysq_means, moments0 = data_fused_step(
            w, w, xs, opts, need_h, need_ysq)
        loss = jnp.sum(signs * ll_means)
        if need_ysq:
            loss = loss + 0.5 * jnp.sum(ysq_means)
        loss = loss.astype(_work_dtype(xs))
    else:
        loss = compute_loss(w, xs, signs, opts)
        # Seed iteration 0's moments (every later iteration receives
        # them from the line search's fused pass).
        moments0 = data_moments(w, xs, opts, need_h, need_ysq)
    initial_singular = loss >= _SINGULAR_LOSS

    if opts.extended:
        if opts.has_cov:
            c = covariance
        else:
            # Y == X at init; GSPMD shards this one-time Gram + psum.
            c = _dot(x, x.T) / jnp.asarray(t, dtype)
    else:
        c = jnp.eye(n, dtype=dtype)

    mem = LbfgsMemory(
        s_mem=jnp.zeros((opts.m, n, n), dtype),
        y_mem=jnp.zeros((opts.m, n, n), dtype),
        r_mem=jnp.zeros((opts.m,), dtype),
        count=jnp.asarray(0, jnp.int32),
    )

    state = CoreState(
        w=w,
        loss=loss,
        signs=signs,
        old_signs=jnp.ones((n,), dtype),
        c=c,
        g_old=jnp.zeros((n, n), dtype),
        prev_step=jnp.zeros((n, n), dtype),
        memory=mem,
        moments=moments0,
        it=jnp.asarray(0, jnp.int32),
        n_iter_done=jnp.asarray(0, jnp.int32),
        gradient_norm=jnp.asarray(1.0, dtype),
        converged=jnp.asarray(False),
        best_gnorm=jnp.asarray(jnp.inf, dtype),
        since_improve=jnp.asarray(0, jnp.int32),
        consec_fallbacks=jnp.asarray(0, jnp.int32),
        ls_calls=jnp.asarray(0, jnp.int32),
        prev_alpha_exp=jnp.asarray(0, jnp.int32),
    )
    return state, initial_singular


def _precision_stages(opts: CoreOptions, dtype=jnp.float32):
    """Staged precision schedule for ``kernel_precision="auto"``.

    Each tier runs until the gradient norm clears a safe multiple of
    its noise floor (see ops/precision.py), then hands the carry to the
    next tier: bf16 (floor ~1.2e-4) -> bf16x3 (floor ~1.5e-7) -> exact
    f32 down to tol. The Jacobian of the handoff is trivial — W, the
    L-BFGS ring and the loss are precision-agnostic carry state; only
    the moments are re-measured at each boundary.

    The schedule applies to both compute paths: the fused kernel takes
    the tier as an argument, the XLA path runs its data matmuls through
    the same tiers (data_fused_step). At f64 every tier lowers to the
    same HIGHEST dots, so "auto" resolves to the single-stage schedule
    the oracle lockstep was measured against.
    """
    if opts.kernel_precision != "auto":
        return [(opts.kernel_precision, None)]
    if dtype == jnp.float64:
        return [("f32", None)]
    # Extended mode note: the bf16 tier's moment noise (~1e-4) is the
    # same scale as the sub/super sign margins k_i on mixed-kurtosis
    # data, so early bf16 iterations CAN run with noise-flipped signs.
    # Measured (BASELINE config-3 mixture, 64x500k): the flips
    # self-correct at the bf16x3/f32 tiers — the fit lands on the f64
    # reference's fixed point to Amari ~6e-12, spending a few extra
    # cheap iterations (32 vs 19). The basin is decided late, at
    # accurate tiers, so the cheap tier stays in the schedule
    # (docs/DESIGN.md §7).
    #
    # Handoff thresholds are DENSITY-AWARE: the cheap tiers' gradient
    # noise floors are properties of the density's moment dynamic
    # range (cube floors ~10x above tanh's — measured values on the
    # density classes, ops/densities.py).
    #
    # They are deliberately NOT N-scaled, although the floors rise
    # ~sqrt(N): at N=384 the whole descent lives in gnorm
    # [5e-4, 1e-8], so a sqrt(N)-scaled bf16 handoff sits ABOVE the
    # initial gradient and self-skips the tier, while the unscaled tier
    # still substitutes for accurate-tier iterations there. The
    # max-abs gnorm is a lagging, noise-floored indicator;
    # a tier stays productive while grinding NEAR its floor, and the
    # stall logic in _iteration_body — not the handoff arithmetic —
    # is what should end it.
    d = opts.density
    return [
        ("bf16", getattr(d, "bf16_handoff", 3e-4)),
        ("bf16x3", getattr(d, "bf16x3_handoff", 4e-7)),
        ("f32", None),
    ]


def run_core(x, covariance, tol, lambda_min, max_iter, opts: CoreOptions) -> CoreResult:
    """Run the full optimizer loop (core.rs:162-401). Jit-friendly."""
    if opts.data_sharding is not None:
        x = lax.with_sharding_constraint(x, opts.data_sharding)

    stages = _precision_stages(opts, x.dtype)
    need_h = not opts.ortho
    need_ysq = opts.extended and not opts.ortho

    n_stages = len(stages)

    def _stage_opts(idx: int, precision: str) -> CoreOptions:
        final_stage = idx == n_stages - 1
        return dataclasses.replace(
            opts,
            kernel_precision=precision,
            # Non-final tiers bail to the next tier on a gradient
            # plateau (their noise floor is data-dependent) and cap
            # the FALLBACK line search at 3 tries. The PRIMARY search
            # keeps its full budget: a primary failure near the floor
            # is the tier-exit signal (see _iteration_body), so a
            # capped primary MANUFACTURES failures and hands off to a
            # costlier tier while the cheap tier is still productive
            # (at N=64, T=4M, tanh extended ortho a cap of 3 exits bf16
            # at iteration 9 instead of running it for 32 of 35
            # iterations). The final tier honors reference semantics
            # (run to max_iter, ls_tries, 10 fallback tries).
            stage_patience=0 if final_stage else (opts.stage_patience or 10),
            fallback_ls_tries=(
                opts.fallback_ls_tries if final_stage
                else min(opts.fallback_ls_tries, 3)
            ),
            # Cheap-tier economics (see the CoreOptions fields): the
            # bf16 tier accepts on plain absolute log-lik (half the
            # elementwise work, one fewer rotation dot); all non-final tiers
            # warm-start alpha from the last accepted step. The final
            # tier keeps exact reference line-search semantics.
            plain_ls=(precision == "bf16" and not final_stage),
            adaptive_alpha=not final_stage,
        )

    def _stage_x(stage_opts: CoreOptions, precision: str):
        # The kernel's bf16-plain tier reads a bf16 COPY of X: half the
        # bytes of the dominant pass for +50% X memory during that
        # stage only. All reductions/scalars stay f32 (_work_dtype).
        if (stage_opts.plain_ls and precision == "bf16"
                and x.dtype == jnp.float32 and opts.use_pallas):
            return x.astype(jnp.bfloat16)
        return x

    first_opts = _stage_opts(0, stages[0][0])
    # init_state gets the stage-0 data copy so the initial loss
    # baseline/moments are self-consistent with the first stage's
    # accept tests (same-copy invariant, see init_state docstring).
    state, _ = init_state(
        x, covariance, first_opts,
        x_stage=_stage_x(first_opts, stages[0][0]),
    )
    tol = jnp.asarray(tol, x.dtype)
    lambda_min = jnp.asarray(lambda_min, x.dtype)
    max_iter = jnp.asarray(max_iter, jnp.int32)

    def cond(st: CoreState):
        return (st.it < max_iter) & (~st.converged)

    stage_exits = []
    stage_ls = []
    for idx, (precision, floor) in enumerate(stages):
        final_stage = idx == n_stages - 1
        stage_opts = _stage_opts(idx, precision)
        stage_tol = tol if floor is None else jnp.maximum(
            jnp.asarray(floor, x.dtype), tol
        )
        if idx > 0:
            # Re-measure the moments at the new precision and clear the
            # stage-convergence/plateau state; `it`/`n_iter_done` carry
            # over, so the boundary costs one moments pass, not an
            # iteration. The L-BFGS ring and (g_old, prev_step) are
            # ALSO cleared: a cross-tier curvature pair
            # y_diff = g(new tier) - g(old tier) embeds the old tier's
            # noise floor (~3e-4 for bf16), poisoning the first
            # higher-precision directions; zeroed prev_step makes the
            # first post-boundary push skip (denom = 0 -> r = inf),
            # mirroring the reference's memory flush at sign changes
            # (core.rs:330).
            # Skip the (full-pass-over-X) re-measure when the
            # iteration budget is already exhausted: the stage's
            # while_loop will not run and the moments are dead state
            # (CoreResult never exports them).
            moments = lax.cond(
                state.it < max_iter,
                lambda st=state, so=stage_opts: data_moments(
                    st.w, x, so, need_h, need_ysq),
                lambda st=state: st.moments,
            )
            state = state._replace(
                moments=moments,
                converged=jnp.asarray(False),
                best_gnorm=jnp.asarray(jnp.inf, x.dtype),
                since_improve=jnp.asarray(0, jnp.int32),
                consec_fallbacks=jnp.asarray(0, jnp.int32),
            )
            if x.dtype != jnp.float64:
                # At f64 every tier lowers to the same HIGHEST dots, so
                # the carry must flow through untouched (the staged
                # trajectory stays bit-identical to a single-stage run
                # — asserted by tests/test_pallas.py); only when tiers
                # genuinely differ is the cross-tier history poison.
                #
                # The clear is CONDITIONAL on how contaminated the ring
                # actually is: its pairs carry y_diff noise at the OLD
                # tier's gradient floor (~handoff/2.5 by calibration).
                # A floor exit (the common case: gnorm ~ the handoff at
                # the boundary) means ~40% noise — clear. But a stall
                # exit can hand off well ABOVE the old floor (measured
                # at N=384: a bf16x3 -> f32 handoff at gnorm 1.2e-5
                # with floor 3.3e-7 — 3% noise in the pairs — where the
                # cleared ring forced 13 cold f32 iterations at 3.5
                # line-search calls each to re-converge from an almost-
                # converged state). Keep the memory when the entering
                # gnorm clears 10x the old handoff (= ~25x the floor,
                # ~4% pair noise). A 4x threshold was measured to
                # poison the next tier on early-fallback streams: a
                # bf16 exit at gnorm ~2e-3 (seed-43 stream, N=64) kept
                # pairs carrying ~10% floor noise and the bf16x3 tier
                # ground 84 line-search calls over 30 iterations on
                # the contaminated directions.
                prev_handoff = stages[idx - 1][1]
                if prev_handoff is None:
                    keep = jnp.asarray(False)
                else:
                    keep = state.gradient_norm >= jnp.asarray(
                        10.0 * prev_handoff, x.dtype)
                state = state._replace(
                    memory=state.memory._replace(
                        count=jnp.where(
                            keep, state.memory.count,
                            jnp.zeros_like(state.memory.count)),
                    ),
                    g_old=jnp.where(keep, state.g_old,
                                    jnp.zeros_like(state.g_old)),
                    prev_step=jnp.where(keep, state.prev_step,
                                        jnp.zeros_like(state.prev_step)),
                )

        # Same-copy invariant: the initial baseline (init_state) and
        # every in-stage loss evaluation use this stage's data copy.
        x_stage = _stage_x(stage_opts, precision)

        def body(st: CoreState, _x=x_stage, _opts=stage_opts, _tol=stage_tol):
            return _iteration_body(st, _x, covariance, _tol, lambda_min, _opts)

        state = lax.while_loop(cond, body, state)
        stage_exits.append(state.n_iter_done)
        stage_ls.append(state.ls_calls)

    final = state

    # Materialize the sources once, at the end (the reference rewrites
    # them every iteration). With a donated X (run_core_jit_donated)
    # the rotation runs in place through X's buffer — every read of X
    # (stage loops, boundary re-measures, the bf16 copy) is sequenced
    # before it via the data dependency on final.w.
    if opts.donate_data and opts.data_sharding is None:
        from ..ops.linalg import rotate_rows_inplace_blocks

        y = rotate_rows_inplace_blocks(final.w, x)
    else:
        y = _dot(final.w, x)
    if opts.data_sharding is not None:
        y = lax.with_sharding_constraint(y, opts.data_sharding)

    return CoreResult(
        y=y,
        w=final.w,
        converged=final.converged,
        gradient_norm=final.gradient_norm,
        n_iterations=final.n_iter_done,
        signs=final.signs,
        stage_exits=jnp.stack(stage_exits),
        ls_calls=final.ls_calls,
        stage_ls_calls=jnp.stack(stage_ls),
    )


run_core_jit = jax.jit(run_core, static_argnames=("opts",))

# X-donating variant for callers that own the whitened buffer and never
# reuse it (the solver facade: its X is always the fresh pre-rotation
# product). Pair with opts.donate_data=True so the final Y aliases X's
# buffer — together they cut one full (N, T) allocation from the
# program peak. Direct run_core_jit users keep the non-donating entry.
run_core_jit_donated = jax.jit(
    run_core, static_argnames=("opts",), donate_argnums=(0,)
)
