"""Small replicated N x N linear-algebra kernels.

These map the reference's LAPACK-backed helpers (src/math.rs) onto XLA
primitives. All of them operate on the small ``n_components`` square
matrices which stay *replicated* on every chip — only the N x T data
axis is ever sharded, so nothing here needs collectives.

  * sym_decorrelation — W <- (W W^T)^{-1/2} W via eigh (math.rs:12-33)
  * matrix_exp        — scaling-and-squaring Taylor expm (math.rs:38-74)
  * slogdet           — signed log-determinant (math.rs:84-88)
  * skew_symmetric    — (A - A^T)/2 (math.rs:91-93)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..errors import SingularMatrixError

# N x N products run exact-f32-grade: a default (TF32 on the GPU) pass in
# the line-search transform or the decorrelation costs ~4e-3 relative
# error on state the loop treats as exact.
_HI_PREC = jax.lax.Precision.HIGHEST

# Minimum eigenvalue of W W^T accepted by symmetric decorrelation
# (math.rs:22).
_SYM_DECORR_MIN_EIG = 1e-10


def sym_decorrelation_with_mineig(w):
    """Symmetric decorrelation; also returns min eigenvalue of W W^T.

    Jit-safe (no host sync). Callers that run eagerly should use
    :func:`sym_decorrelation`, which raises ``SingularMatrixError`` when
    the min eigenvalue is below 1e-10, matching math.rs:21-24.
    """
    hi = jax.lax.Precision.HIGHEST
    ww_t = jnp.dot(w, w.T, precision=hi)
    eigenvalues, eigenvectors = jnp.linalg.eigh(ww_t)
    min_eig = jnp.min(eigenvalues)
    # Guard: avoid nan from sqrt of tiny negatives under f32.
    safe = jnp.maximum(eigenvalues, jnp.finfo(w.dtype).tiny)
    s_inv_sqrt = 1.0 / jnp.sqrt(safe)
    scaled = eigenvectors * s_inv_sqrt
    return jnp.dot(jnp.dot(scaled, eigenvectors.T, precision=hi), w, precision=hi), min_eig


def sym_decorrelation(w):
    """Eager symmetric decorrelation with the reference's singularity check."""
    result, min_eig = sym_decorrelation_with_mineig(w)
    if float(min_eig) < _SYM_DECORR_MIN_EIG:
        raise SingularMatrixError()
    return result


# Cap on the scaling exponent of expm. The reference derives
# s = ceil(log2(max|A|)) with no cap (math.rs:48); under jit we need a
# static bound. 2^64 overflows any f32/f64 gradient norm that could
# plausibly reach a line search, so 64 squarings is effectively "no cap".
_EXPM_MAX_SQUARINGS = 64
_EXPM_MAX_TERMS = 30  # math.rs:56
_EXPM_TERM_TOL = 1e-16  # math.rs:57


# Squarings handled by the unrolled (masked) chain; the data-dependent
# tail loop beyond this is effectively never taken (norm > 2^16).
_EXPM_UNROLLED_SQUARINGS = 16


def matrix_exp(a):
    """Matrix exponential via scaling-and-squaring Taylor series.

    Mirrors the reference algorithm (math.rs:38-74) so line-search
    trajectories are comparable step-for-step: scale by 2^s with
    s = max(ceil(log2(max|A|)), 0), run <=30 Taylor terms with early
    exit at 1e-16, then square s times.

    Accelerator shape: the Taylor recurrence and the first 16 squarings are
    UNROLLED with ``where`` masks instead of ``lax.while_loop``s — the
    matrices are tiny (N x N), so the sequential dependence of a while
    loop costs far more in per-step dispatch than the few masked spare
    matmuls; masking reproduces the early-exit semantics bit-for-bit
    (like the reference's while loop, the FIRST below-tolerance term
    is still added and no term after it; a squaring past s is
    skipped). Only the pathological s > 16 tail stays a while_loop.
    """
    n = a.shape[0]
    dtype = a.dtype
    eye = jnp.eye(n, dtype=dtype)

    norm = jnp.max(jnp.abs(a))
    is_zero = norm < 1e-15

    s = jnp.clip(jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-300 if dtype == jnp.float64 else 1e-38))), 0, _EXPM_MAX_SQUARINGS)
    scale = jnp.exp2(s).astype(dtype)
    a_scaled = a / scale

    # Unrolled Taylor: term_k = term_{k-1} @ A / k, added while every
    # previous term stayed >= the tolerance (the while_loop's early
    # exit is monotone, so one running flag reproduces it).
    result = eye
    term = eye
    active = jnp.asarray(True)
    for k in range(1, _EXPM_MAX_TERMS + 1):
        term_next = jnp.dot(term, a_scaled, precision=_HI_PREC) / dtype.type(k)
        result = jnp.where(active, result + term_next, result)
        term = jnp.where(active, term_next, term)
        active = active & (jnp.max(jnp.abs(term_next)) >= _EXPM_TERM_TOL)

    # Unrolled squarings (i < s), then a tail loop for absurd norms.
    s_i32 = s.astype(jnp.int32)
    for i in range(_EXPM_UNROLLED_SQUARINGS):
        result = jnp.where(
            i < s_i32, jnp.dot(result, result, precision=_HI_PREC), result
        )

    def square_cond(carry):
        i, _ = carry
        return i < s_i32

    def square_body(carry):
        i, r = carry
        return i + 1, jnp.dot(r, r, precision=_HI_PREC)

    _, result = lax.while_loop(
        square_cond, square_body,
        (jnp.asarray(_EXPM_UNROLLED_SQUARINGS, jnp.int32), result),
    )

    return jnp.where(is_zero, eye, result)


# Squarings attributable to the direction norm that the STATIC chain
# covers (norms beyond 2^16 essentially never reach a line search);
# larger norms are handled by a dynamic pre-squaring tail up to the
# same 64-squaring bound as matrix_exp, so the chain is accurate for
# any representable direction, like the reference's per-try expm
# (math.rs:48 derives s with no cap).
_CHAIN_MAX_S = 16


def expm_pow2_chain(d, n_alphas: int):
    """All of ``expm(2^-k d)`` for k = 0..n_alphas-1, via ONE shared
    scaling-squaring chain.

    The backtracking line search evaluates expm(alpha*D) at halved
    alphas. Scaling-and-squaring computes expm(2^-k d) as
    ``taylor(d / 2^j) ** (2^(j-k))`` — and the over-scaled base
    ``taylor(d / 2^j)`` with ``j = s1 + n_alphas - 1`` (s1 the norm's
    scaling exponent) is SHARED by every alpha: try k just reads entry
    ``j - k`` of the squaring chain ``chain[m] = base^(2^m)``.

    Cost: 6 Taylor matmuls + (16 + n_alphas) chain matmuls ONCE per
    line search, vs ~50 masked matmuls PER TRY for independent
    :func:`matrix_exp` calls — the expm chain is dispatch-bound N x N
    work that would otherwise dominate the per-try cost at N = 64.

    Accuracy: the base input norm is <= 2^(1 - n_alphas), so 6 Taylor
    terms truncate below 1e-18 — truncation is NOT the limit. The
    extra ``n_alphas - 1 - k`` squarings vs the reference's per-alpha
    scaling AMPLIFY f32 rounding: measured (f32, 16x16 skew,
    n_alphas=16) transform error ~2.6e-5 and non-orthogonality ~5e-4
    at max|D| ~ 0.06-0.5, vs ~1e-7 for per-try :func:`matrix_exp`.
    The error scales with |D|: at the converged regime's |D| ~ gnorm
    (<= 1e-5) it is eps-level. Callers with reference-exact accuracy
    requirements therefore gate on the direction norm and fall back
    to per-try matrix_exp above ~2^-10 (models/core.line_search);
    cheap noisy tiers read the chain unconditionally. f64 conformance
    never uses the chain (per-try matrix_exp, bit-matched to the
    reference).

    Returns ``(chain, j)`` with ``chain`` of static shape
    ``(_CHAIN_MAX_S + n_alphas, n, n)`` and ``expm(2^-k d) ==
    chain[j - k]``.
    """
    dtype = d.dtype
    tiny = 1e-300 if dtype == jnp.float64 else 1e-38
    norm = jnp.max(jnp.abs(d))
    s_full = jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(norm, tiny))), 0, _EXPM_MAX_SQUARINGS
    ).astype(jnp.int32)
    s1 = jnp.minimum(s_full, _CHAIN_MAX_S)
    # Norm bits beyond the static chain: absorbed by extra scaling of
    # the Taylor input + the SAME number of dynamic pre-squarings of
    # the base, so chain[m] = taylor(d/2^(j+e))^(2^(m+e)) still equals
    # base^(2^m) with base = expm(d/2^j)-quality. Zero iterations in
    # the (overwhelmingly common) norm <= 2^16 case.
    extra = s_full - s1
    j = s1 + (n_alphas - 1)
    scale = jnp.exp2((j + extra).astype(dtype))
    a = d / scale

    n = d.shape[0]
    base = jnp.eye(n, dtype=dtype)
    term = jnp.eye(n, dtype=dtype)
    for k in range(1, 7):
        term = jnp.dot(term, a, precision=_HI_PREC) / dtype.type(k)
        base = base + term

    base = lax.while_loop(
        lambda c: c[0] < extra,
        lambda c: (c[0] + 1, jnp.dot(c[1], c[1], precision=_HI_PREC)),
        (jnp.asarray(0, jnp.int32), base),
    )[1]

    mats = [base]
    for _ in range(_CHAIN_MAX_S + n_alphas - 1):
        mats.append(jnp.dot(mats[-1], mats[-1], precision=_HI_PREC))
    return jnp.stack(mats), j


def slogdet(m):
    """Signed log-determinant, ``(sign, log|det|)`` (math.rs:84-88)."""
    return jnp.linalg.slogdet(m)


def skew_symmetric(a):
    """(A - A^T) / 2 (math.rs:91-93)."""
    return (a - a.T) / 2.0


def mixing_pinv(w):
    """Pseudo-inverse of the (full) unmixing matrix.

    Fills the role of ``PicardResult::mixing`` (result.rs:49-64). The
    reference forms the normal equations ``(W^T W)^{-1} W^T`` with a
    hand-rolled Gauss-Jordan inverse; that squares the condition number
    and loses ~2 digits in f32, so we use the SVD-based
    ``jnp.linalg.pinv`` instead (same mathematical object), keeping the
    reference's transpose fallback for degenerate inputs (exact for
    orthogonal W).
    """
    p = jnp.linalg.pinv(w)
    return jnp.where(jnp.all(jnp.isfinite(p)), p, w.T)


# Column-block width of the in-place row rotation: (N, 2^20) f32 blocks
# are 256 MB at N=64 / 1 GB at N=256 — small next to the (N, T) buffer.
ROTATE_BLOCK_T = 1 << 20


def rotate_rows_inplace_blocks(r, x):
    """``r @ x`` written back through ``x``'s buffer, column block by
    column block (traceable body; callers jit it with ``x`` donated).

    XLA will not alias a GEMM's output onto a donated operand (chip-
    measured: a donated plain dot at 256x6M with a data-sized ballast
    still OOMs), but ``dynamic_update_slice`` on a donated loop carry
    IS aliased — so rotating blocks through the buffer holds the peak
    at one data buffer plus one block instead of two full buffers.
    The contraction is over rows only, so blockwise evaluation keeps
    each output element's reduction order and is BIT-identical to the
    full ``jnp.dot`` (tests/test_whitening.py pins this).

    Only for single-device ``x``: slicing a sample-sharded array by
    column blocks would lower to cross-device gathers.
    """
    n, t = x.shape
    block = min(ROTATE_BLOCK_T, t)
    n_full = t // block

    def body(i, buf):
        sl = lax.dynamic_slice(buf, (0, i * block), (n, block))
        return lax.dynamic_update_slice(
            buf, jnp.dot(r, sl, precision=_HI_PREC), (0, i * block)
        )

    buf = lax.fori_loop(0, n_full, body, x)
    rem = t - n_full * block
    if rem:
        sl = lax.slice(buf, (0, n_full * block), (n, t))
        buf = lax.dynamic_update_slice(
            buf, jnp.dot(r, sl, precision=_HI_PREC), (0, n_full * block)
        )
    return buf


# Jitted donating entry: the caller hands over x's buffer and receives
# the rotated result in (an alias of) it. Callers: the whitening
# refinement re-projection, the solver's pre-rotation, and (fused into
# run_core's program via opts.donate_data) the final Y materialization.
_rotate_rows_inplace_jit = jax.jit(
    rotate_rows_inplace_blocks, donate_argnums=(1,)
)


def call_donating(fn, *args):
    """Dispatch a donating jitted function with the 'donated buffers
    were not usable' warning filtered: backends that cannot alias
    (e.g. the CPU test backend) emit it on every dispatch — pure log
    noise, since results are identical and the donation is a memory
    optimization, not a semantic requirement (ADVICE r4)."""
    import warnings

    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=".*[Dd]onated buffer.*"
        )
        return fn(*args)


def rotate_rows_inplace(r, x):
    return call_donating(_rotate_rows_inplace_jit, r, x)
