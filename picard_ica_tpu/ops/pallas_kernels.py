"""Fused line-search data pass as a Pallas kernel through Triton (GPU).

The core loop's invariant Y = W @ X (W accumulates every line-search
transform from identity) keeps the data matrix read-only: one
line-search try needs the candidate's loss delta and, for the next
iteration, the candidate's raw moments. The XLA formulation
(models/core.data_fused_step) materialises Y_old, dY, Y_new and the
score arrays in device memory, several X-sized passes per try. This
kernel reads each X tile once and keeps everything else in registers:

    rotate (W_old x, (W_new - W_old) x) -> score, derivative and the
    cancellation-free log-lik delta -> moment contractions and row sums

Layout. The grid runs over programs, each owning a contiguous range of
``steps`` column tiles of width ``bt``; a program loops over its tiles
(blocks run in no order on the GPU, so nothing carries between them)
and accumulates its (N, N) and (N,) sums in registers. Each program
writes one partial; the (n_programs, ...) partials are folded outside
the kernel with a pairwise tree (ops/moments.fold_pairwise), so the
accumulation error is a few hundred f32 adds deep, never T/bt deep.

N is padded to a power of two (at least 16, the smallest Triton dot
operand) with zero weight rows; padded rows and out-of-range columns
are masked on load and contribute nothing to the rows kept.

All outputs are UNNORMALIZED sums over the local T axis so that sharded
callers can psum across sample shards before dividing by global T.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .densities import Density
from .moments import fold_pairwise
from .precision import tier_dot

# Largest N the kernel takes. The (N, N) weights and moment sums live
# in registers next to several (N, bt) tiles; at N=128 the exact-f32
# tier (CUDA-core FMA dots) spills and runs ~25x slower than XLA's
# cuBLAS path on an H100, so larger N takes the XLA formulation.
MAX_N = 64

# Column tile width, warps per program and the target number of
# programs (a few per SM of the card, so each SM keeps several in
# flight while the per-program partials stay a few MB). bt=32 with 4
# warps is the fastest or within 6 % of it for every tier at 64 x 4M
# on an H100; bt=64 makes the f32 tier spill (4x slower).
_BT = 32
_NUM_WARPS = 4
_NUM_STAGES = 2
_TARGET_PROGRAMS = 1056

_MM = (((1,), (0,)), ((), ()))  # a @ b
_CT = (((1,), (1,)), ((), ()))  # a @ b.T


def padded_n(n: int) -> int:
    """Row count the kernel computes on: next power of two, >= 16."""
    return max(16, 1 << (n - 1).bit_length())


def _grid(t: int, bt: int, target_programs: int):
    n_tiles = pl.cdiv(t, bt)
    steps = pl.cdiv(n_tiles, min(target_programs, n_tiles))
    return pl.cdiv(n_tiles, steps), steps


def _fused_kernel(
    mn_ref, mo_ref, x_ref, dll_ref, dysq_ref, g_ref, pm_ref, h_ref, ysq_ref,
    *, density, n, need_h, need_ysq, plain, t, bt, steps, precision, acc,
):
    npad = mn_ref.shape[0]
    pid = pl.program_id(0)
    row_ok = (lax.broadcasted_iota(jnp.int32, (npad, 1), 0) < n)
    lane = lax.broadcasted_iota(jnp.int32, (1, bt), 1)
    mn = mn_ref[...]
    dm = None if plain else mn - mo_ref[...]
    mo = None if plain else mo_ref[...]

    def tile(k, sums):
        dll_s, dysq_s, g_s, pm_s, h_s, ysq_s = sums
        start = (pid * steps + k) * bt
        col_ok = (start + lane) < t
        x = pltriton.load(
            x_ref.at[pl.ds(0, npad), pl.ds(start, bt)],
            mask=row_ok & col_ok, other=0.0,
        ).astype(acc)
        if plain:
            # Cheap-tier accept: absolute log-lik row sums of the
            # candidate (one rotation, about half the transcendentals).
            y_new = tier_dot(mn, x, _MM, acc, precision)
            psi, psi_d, ll = density.score_der_loglik(y_new)
            ll = jnp.where(col_ok, ll, 0.0)  # log_lik(0) != 0
            dll_s = dll_s + jnp.sum(ll, axis=1)
            if need_ysq:
                dysq_s = dysq_s + jnp.sum(y_new * y_new, axis=1)
        else:
            # Rotate the current matrix and the candidate DELTA: dy is
            # small near convergence and keeps full relative precision,
            # so the loss delta is cancellation-free (exactly 0 at the
            # masked (0, 0) lanes).
            y_old = tier_dot(mo, x, _MM, acc, precision)
            dy = tier_dot(dm, x, _MM, acc, precision)
            y_new = y_old + dy
            psi, psi_d, dll = density.score_der_loglik_delta(y_old, dy)
            dll_s = dll_s + jnp.sum(dll, axis=1)
            if need_ysq:
                # y_new^2 - y_old^2 = (2 y_old + dy) dy, cancellation-free.
                dysq_s = dysq_s + jnp.sum((2.0 * y_old + dy) * dy, axis=1)
        psi_d = jnp.where(col_ok, psi_d, 0.0)  # psi'(0) != 0
        ysq = y_new * y_new
        g_s = g_s + tier_dot(psi, y_new, _CT, acc, precision)
        pm_s = pm_s + jnp.sum(psi_d, axis=1)
        if need_h:
            h_s = h_s + tier_dot(psi_d, ysq, _CT, acc, precision)
        if need_ysq:
            ysq_s = ysq_s + jnp.sum(ysq, axis=1)
        return dll_s, dysq_s, g_s, pm_s, h_s, ysq_s

    vec = jnp.zeros((npad,), acc)
    mat = jnp.zeros((npad, npad), acc)
    sums = lax.fori_loop(jnp.int32(0), jnp.int32(steps), tile,
                         (vec, vec, mat, vec, mat, vec))
    for ref, val in zip((dll_ref, dysq_ref, g_ref, pm_ref, h_ref, ysq_ref),
                        sums):
        ref[...] = val


@functools.partial(
    jax.jit,
    static_argnames=(
        "density", "need_h", "need_ysq", "interpret", "precision",
        "absolute_ll", "target_programs",
    ),
)
def rotated_fused_sums(
    m_new, m_old, x, density: Density, need_h: bool, need_ysq: bool,
    interpret: bool = False, precision: str = "f32",
    absolute_ll: bool = False, target_programs: int = _TARGET_PROGRAMS,
):
    """Unnormalized fused line-search-try + moments sums.

    Returns ``(dll, dysq, g, pm, h, ysq)``: dll/dysq are the per-row
    sums of ``log_lik(M_new X) - log_lik(M_old X)`` and of the Y^2
    delta; g/pm/h/ysq are the raw moment sums of ``Y = M_new @ X``
    (``psi(Y) Y^T``, ``psi'(Y)`` row sums, ``psi'(Y) (Y^2)^T``, ``Y^2``
    row sums). With ``absolute_ll=True`` the dll/dysq slots hold the
    ABSOLUTE ``log_lik(M_new X)`` / ``(M_new X)^2`` row sums instead
    (the plain cheap-tier accept path; m_old is ignored). Outputs not
    asked for (``need_h``, ``need_ysq``) are zeros. ``target_programs``
    bounds the grid (tests lower it to reach programs past T).
    """
    n, t = x.shape
    if n > MAX_N:
        raise ValueError(f"fused kernel takes N <= {MAX_N}, got {n}")
    acc = jnp.float32 if x.dtype == jnp.bfloat16 else x.dtype
    npad = padded_n(n)
    bt = _BT
    n_programs, steps = _grid(t, bt, target_programs)

    def pad_w(m):
        return jnp.zeros((npad, npad), acc).at[:n, :n].set(m.astype(acc))

    kernel = functools.partial(
        _fused_kernel, density=density, n=n, need_h=need_h,
        need_ysq=need_ysq, plain=absolute_ll, t=t, bt=bt, steps=steps,
        precision=precision, acc=acc,
    )
    vec_spec = pl.BlockSpec((None, npad), lambda i: (i, 0))
    mat_spec = pl.BlockSpec((None, npad, npad), lambda i: (i, 0, 0))
    w_spec = pl.BlockSpec((npad, npad), lambda i: (0, 0))
    vec = jax.ShapeDtypeStruct((n_programs, npad), acc)
    mat = jax.ShapeDtypeStruct((n_programs, npad, npad), acc)
    outs = pl.pallas_call(
        kernel,
        grid=(n_programs,),
        in_specs=[w_spec, w_spec, pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[vec_spec, vec_spec, mat_spec, vec_spec, mat_spec, vec_spec],
        out_shape=[vec, vec, mat, vec, mat, vec],
        compiler_params=pltriton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=_NUM_STAGES),
        interpret=interpret,
        name="picard_fused_step",
    )(pad_w(m_new), pad_w(m_old), x)

    dll, dysq, g, pm, h, ysq = (fold_pairwise(o) for o in outs)
    zeros_v = jnp.zeros((n,), acc)
    return (
        dll[:n],
        dysq[:n] if need_ysq else zeros_v,
        g[:n, :n],
        pm[:n],
        h[:n, :n] if need_h else jnp.zeros((n, n), acc),
        ysq[:n] if need_ysq else zeros_v,
    )
