"""JADE (Joint Approximate Diagonalization of Eigenmatrices) warm start.

Same math as the reference (src/jade.rs) re-architected for an accelerator:

  * The reference builds the 4th-order cumulant matrices with an
    O(N^4 T) scalar loop nest over an N^2 x T intermediate
    (jade.rs:91-120). Here the whole Gram of pair products
    ``Q[(i,j),(k,l)] = E[x_i x_j x_k x_l]`` is ONE (N^2, chunk) x
    (chunk, N^2) matmul accumulated over T chunks; the
    delta corrections for whitened data (jade.rs:114-120) are sparse
    scatter updates rather than materialized N^4 delta tensors.
  * The reference recomputes each Givens angle from the *original*
    cumulants through the current V, an O(P N^2) block build per pair
    (jade.rs:148-159). We maintain the rotated tensor R_m = V^T Q_m V
    in the carry and conjugate it per round — algebraically identical,
    verified in tests against a direct recompute.
  * The reference sweeps pairs sequentially in lexicographic order
    (jade.rs:44-52); here a sweep is N-1 round-robin steps of N/2
    DISJOINT planes rotated together as one batched conjugation
    (see _jacobi_sweeps for why the sequential order is untenable on
    an accelerator at N >= 64).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.linalg import sym_decorrelation_with_mineig

_ANGLE_EPS = 1e-15  # jade.rs:175


def _pair_indices(n: int):
    """All (i, j) with i <= j in the reference's order (jade.rs:101-102)."""
    ps, qs = [], []
    for i in range(n):
        for j in range(i, n):
            ps.append(i)
            qs.append(j)
    return np.asarray(ps, np.int32), np.asarray(qs, np.int32)


def _round_robin_schedule(n: int):
    """Round-robin tournament pairing: (n-1 rounds) x (n/2 disjoint
    pairs) covering every (p, q) pair exactly once per sweep.

    Returns ``(p_idx, q_idx, valid)`` arrays of shape (rounds, n//2+).
    For odd n a phantom player is added; its pairs are marked invalid
    (rotated by the identity).
    """
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    p_rounds, q_rounds, valid_rounds = [], [], []
    for _ in range(m - 1):
        ps, qs, valids = [], [], []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            p, q = min(a, b), max(a, b)
            ok = q < n  # phantom = m-1 when n is odd
            ps.append(p if ok else 0)
            qs.append(q if ok else 0)
            valids.append(ok)
        p_rounds.append(ps)
        q_rounds.append(qs)
        valid_rounds.append(valids)
        players = [players[0], players[-1]] + players[1:-1]
    return (
        np.asarray(p_rounds, np.int32),
        np.asarray(q_rounds, np.int32),
        np.asarray(valid_rounds, bool),
    )


def _pair_product_gram(x, chunk_size: int):
    """Gram of pair products ``sum_t (x_i x_j)_t (x_k x_l)_t``, but
    only the P = N(N+1)/2 rows with i <= j (row (i,j) equals row
    (j,i)): shape (P, N^2), accumulated over T chunks so the
    N^2 x chunk intermediate stays small. The left factor
    being the half-pair slice halves the dominant T*N^4 matmul work, the
    accumulated carry, and the sharded path's psum payload vs the full
    (N^2, N^2) Gram the consumer would discard half of."""
    n, t = x.shape
    dtype = x.dtype
    pair_i, pair_j = _pair_indices(n)
    rows = jnp.asarray(pair_i.astype(np.int32) * n + pair_j, jnp.int32)
    chunk = min(chunk_size, t)
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    xp = jnp.pad(x, ((0, 0), (0, pad)))  # zero samples contribute 0 to sums
    xc = jnp.moveaxis(xp.reshape(n, n_chunks, chunk), 1, 0)  # (n_chunks, n, chunk)

    def accumulate(acc, x_chunk):
        z = (x_chunk[:, None, :] * x_chunk[None, :, :]).reshape(n * n, -1)
        zp = z[rows]  # (P, chunk): the i <= j pair products
        return acc + jnp.dot(
            zp, z.T, preferred_element_type=dtype,
            precision=jax.lax.Precision.HIGHEST,
        ), None

    gram, _ = lax.scan(
        accumulate, jnp.zeros((rows.shape[0], n * n), dtype), xc
    )
    return gram


def compute_cumulant_matrices(x, chunk_size: int = 4096, data_sharding=None):
    """Symmetrized cumulant matrices for all pairs i <= j, shape (P, N, N).

    Assumes whitened input, i.e. E[x_a x_b] = delta_ab, exactly like the
    reference (jade.rs:83-86). With ``data_sharding`` the Gram is an
    explicit per-shard partial + psum over the samples axis (SURVEY.md
    §2.3's JADE row): each shard runs the chunked local accumulation,
    one (N^2, N^2) all-reduce rides ICI.
    """
    n, t = x.shape
    dtype = x.dtype

    if data_sharding is not None:
        from jax.sharding import PartitionSpec as P

        from ..parallel.sharding import shard_map_replicated

        mesh = data_sharding.mesh
        axis = data_sharding.spec[1]

        def local(x_local):
            # The scan's zero-initialized carry is unvarying while the
            # accumulated partial varies over the samples axis; the
            # explicit psum makes the output replicated.
            return lax.psum(_pair_product_gram(x_local, chunk_size), axis)

        gram = shard_map_replicated(
            local, mesh=mesh, in_specs=P(None, axis), out_specs=P()
        )(x)
    else:
        gram = _pair_product_gram(x, chunk_size)

    pair_i, pair_j = _pair_indices(n)
    p_count = pair_i.shape[0]
    # Row p of the half-pair Gram is E[x_i x_j x_k x_l] * T over (k, l).
    q = gram.reshape(p_count, n, n) / t

    # Whitened-data delta corrections (jade.rs:114-120), applied sparsely:
    #   - delta_ij delta_kl: subtract I for diagonal pairs (i == j)
    #   - delta_ik delta_jl: subtract 1 at [i, j]
    #   - delta_il delta_jk: subtract 1 at [j, i]
    eye = jnp.eye(n, dtype=dtype)
    q = q - (pair_i == pair_j)[:, None, None] * eye[None]
    rows = jnp.arange(p_count)
    q = q.at[rows, pair_i, pair_j].add(-1.0)
    q = q.at[rows, pair_j, pair_i].add(-1.0)

    # Symmetrize (jade.rs:124-125).
    return (q + jnp.swapaxes(q, 1, 2)) / 2.0


def _jacobi_sweeps(cumulants, n: int, max_iter: int, tol, verbose: bool):
    """Joint diagonalization by parallel-order Jacobi sweeps.

    Same objective and Givens-angle formula as the reference
    (jade.rs:137-185), re-ordered for an accelerator: instead of the
    reference's N(N-1)/2 *sequential* per-pair rotations per sweep —
    which degenerates into ~12 tiny gather/scatter ops per pair and is
    dispatch-bound at N >= 64 — each sweep is
    N-1 round-robin steps that rotate N/2 DISJOINT pairs at once.
    Disjoint-plane rotations commute, so each step is one orthogonal
    block-rotation matrix G and the update is two batched matmuls:
    R <- G^T R G over all P cumulant matrices, V <- V G. Cyclic and
    parallel pair orders share the Jacobi convergence guarantee; they
    differ only in trajectory (the warm start's output feeds Picard
    either way; tests verify off-diagonal decay and separation).

    NOTE — deliberate fix vs the reference: jade.rs:188-196 applies the
    rotation [[c, s], [-s, c]], the *descent* direction for the angle
    formula at jade.rs:174-179; the mismatch makes the reference's
    sweeps oscillate instead of diagonalizing (its test suite only
    checks orthogonality of the output, jade.rs:246-255, so the defect
    is invisible there). Here V <- V G with G = [[c, -s], [s, c]] on
    each (p, q) plane, which maximizes the joint-diagonality objective.
    Committed exhibit: docs/JADE_ORIENTATION.md (regenerate with
    docs/jade_orientation_exhibit.py) shows the off-diagonal norm per
    sweep on the reference's own 3-source fixture — oscillating under
    the reference orientation, converging in 2 sweeps under this one.
    """
    dtype = cumulants.dtype
    p_sched, q_sched, valid_sched = _round_robin_schedule(n)
    p_sched = jnp.asarray(p_sched)
    q_sched = jnp.asarray(q_sched)
    valid_sched = jnp.asarray(valid_sched)
    n_rounds = p_sched.shape[0]
    rows = jnp.arange(n)

    def round_body(t_idx, carry):
        v, r, max_theta = carry
        p = p_sched[t_idx]          # (n//2,) disjoint plane indices
        q = q_sched[t_idx]
        valid = valid_sched[t_idx]

        # 2x2 objective per pair, accumulated over all rotated
        # cumulants (jade.rs:144-167); R holds V^T Q V.
        h_pq = r[:, p, q] + r[:, q, p]          # (P, n//2)
        h_ppqq = r[:, p, p] - r[:, q, q]
        g00 = jnp.sum(h_pq * h_pq, axis=0)
        g01 = jnp.sum(h_pq * h_ppqq, axis=0)
        g11 = jnp.sum(h_ppqq * h_ppqq, axis=0)

        diff = g11 - g00
        near_zero = (jnp.abs(g01) < _ANGLE_EPS) & (jnp.abs(diff) < _ANGLE_EPS)
        angle = jnp.where(
            valid & ~near_zero,
            0.25 * jnp.arctan2(2.0 * g01, diff),
            jnp.asarray(0.0, dtype),
        )
        c = jnp.cos(angle)
        s = jnp.sin(angle)

        # One orthogonal block-rotation for all planes of this round:
        # diag gets c at p and q (1 elsewhere), off-diag gets +/- s.
        # Built with .add so an invalid (phantom) pair — parked at
        # p = q = 0 with c = 1, s = 0 — contributes exactly nothing
        # instead of colliding with a real plane's scatter.
        diag = jnp.ones((n,), dtype).at[p].add(c - 1.0).at[q].add(c - 1.0)
        g = jnp.zeros((n, n), dtype).at[rows, rows].set(diag)
        g = g.at[q, p].add(s).at[p, q].add(-s)

        hi = jax.lax.Precision.HIGHEST
        v = jnp.dot(v, g, precision=hi)
        # R <- G^T R G, batched over the P cumulant matrices.
        rg = jnp.einsum("pjk,kl->pjl", r, g, precision=hi)
        r = jnp.einsum("ji,pjl->pil", g, rg, precision=hi)

        return v, r, jnp.maximum(max_theta, jnp.max(jnp.abs(angle)))

    def sweep_cond(carry):
        _, _, sweep, last_max = carry
        return (sweep < max_iter) & (last_max >= tol)

    def sweep_body(carry):
        v, r, sweep, _ = carry
        v, r, max_theta = lax.fori_loop(
            0, n_rounds, round_body, (v, r, jnp.asarray(0.0, dtype))
        )
        if verbose:
            jax.debug.print(
                "JADE iteration {it}: max angle = {mt:.4e}", it=sweep + 1, mt=max_theta
            )
        return v, r, sweep + 1, max_theta

    v0 = jnp.eye(n, dtype=dtype)
    init = (v0, cumulants, jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dtype))
    v, _, n_sweeps, _ = lax.while_loop(sweep_cond, sweep_body, init)
    return v, n_sweeps


def jade(x, max_iter: int, tol: float = 1e-6, verbose: bool = False,
         data_sharding=None):
    """Run JADE on whitened data; returns (W, min_eig) (jade.rs:22-72).

    ``min_eig`` is the minimum eigenvalue from the final symmetric
    decorrelation, for the eager caller's singularity check. With
    ``data_sharding`` the cumulant Gram is sample-sharded (psum);
    the Jacobi sweeps stay replicated.
    """
    n = x.shape[0]
    if n < 2:
        return jnp.eye(n, dtype=x.dtype), jnp.asarray(1.0, x.dtype)

    cumulants = compute_cumulant_matrices(x, data_sharding=data_sharding)
    if verbose:
        jax.debug.print(
            "JADE: {k} cumulant matrices computed", k=cumulants.shape[0]
        )

    v, _ = _jacobi_sweeps(cumulants, n, max_iter, jnp.asarray(tol, x.dtype), verbose)

    # V's columns span the (whitened) mixing basis; the unmixing that
    # recovers sources from whitened data is V^T. The reference returns
    # V itself (jade.rs:69-71) — combined with its non-convergent sweeps
    # (see _jacobi_sweeps) its warm start is an arbitrary orthogonal
    # matrix; returning the transpose makes the warm start actually land
    # near the solution (verified by separation tests).
    return sym_decorrelation_with_mineig(v.T)


jade_jit = jax.jit(jade, static_argnames=("max_iter", "verbose", "data_sharding"))
