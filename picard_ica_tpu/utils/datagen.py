"""Synthetic ICA data generators.

``generate_bench_data`` reproduces the reference benchmark generator
bit-for-bit in the integer domain (benches/benchmarks.rs:8-35): an LCG
(``state * 6364136223846793005 + 1`` on wrapping u64), Laplace sources
by inverse CDF, uniform(-0.5, 0.5) mixing — so conformance runs see
the *same* mixtures as the Rust reference.

``generate_test_data`` mirrors the reference test fixture
(src/solver.rs:257-286): Laplace-ish sources ``sign * (-ln u)`` and a
standard-normal mixing matrix (seeded NumPy RNG instead of Rust's
StdRng — same distribution, different stream).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_LCG_MUL = np.uint64(6364136223846793005)
_LCG_INC = np.uint64(1)


def _lcg_stream(state: int, count: int) -> Tuple[np.ndarray, int]:
    """Generate ``count`` u64 LCG states starting after ``state``.

    Vectorized closed form: s_k = A^k s_0 + (1 + A + ... + A^{k-1})
    mod 2^64, using numpy's wrapping uint64 arithmetic — bit-identical
    to the scalar recurrence but O(count) vector work.
    """
    s0 = np.uint64(state)
    with np.errstate(over="ignore"):
        pows = np.multiply.accumulate(np.full(count, _LCG_MUL, dtype=np.uint64))
        geo = np.cumsum(
            np.concatenate([np.ones(1, np.uint64), pows[:-1]]), dtype=np.uint64
        )
        states = pows * s0 + geo
    return states, int(states[-1])


def _lcg_uniform(states: np.ndarray) -> np.ndarray:
    """Map LCG states to [0, 1) doubles exactly as benchmarks.rs:16
    (31 retained bits over 2^31)."""
    return (states >> np.uint64(33)).astype(np.float64) / float(1 << 31)


def generate_bench_data(n_features: int, n_samples: int, seed: int = 42) -> np.ndarray:
    """Mixed Laplace data identical to the reference benchmark harness.

    Uses the native OpenMP generator when available (~50x faster at
    64M samples; identical integer stream, f64 values within 1 ulp of
    the NumPy path — bit-identical after the f32 cast device runs use);
    falls back to the vectorized NumPy closed form.
    """
    from .. import native

    if native.available():
        data_flat, state = native.lcg_laplace(seed, n_features * n_samples)
        data = data_flat.reshape(n_features, n_samples)
        mix_flat, _ = native.lcg_uniform_centered(state, n_features * n_features)
        mixing = mix_flat.reshape(n_features, n_features)
        return mixing @ data

    states, state = _lcg_stream(seed, n_features * n_samples)
    u = _lcg_uniform(states)
    data = np.where(u < 0.5, np.log(np.maximum(2.0 * u, 1e-300)), -np.log(np.maximum(2.0 * (1.0 - u), 1e-300)))
    data = data.reshape(n_features, n_samples)

    states, _ = _lcg_stream(state, n_features * n_features)
    mixing = _lcg_uniform(states).reshape(n_features, n_features) - 0.5

    return mixing @ data


def _lcg_jump(state: int, count: int) -> int:
    """LCG state after ``count`` steps, in O(log count) host work.

    Binary composition of the affine map f(s) = A*s + 1 mod 2^64 —
    bit-identical to ``_lcg_stream(state, count)[1]`` (tested) without
    materializing the stream. Lets the bench take the *mixing* block of
    the reference stream (benches/benchmarks.rs:27-31) without paying
    for the n*t source draws it sits behind.
    """
    m = 1 << 64
    a, c = int(_LCG_MUL), int(_LCG_INC)
    acc_a, acc_c = 1, 0
    k = count
    while k:
        if k & 1:
            acc_a, acc_c = (acc_a * a) % m, (acc_c * a + c) % m
        a, c = (a * a) % m, (a * c + c) % m
        k >>= 1
    return (acc_a * state + acc_c) % m


def reference_mixing_matrix(n_features: int, n_samples: int, seed: int = 42) -> np.ndarray:
    """The reference harness's uniform(-0.5, 0.5) mixing matrix,
    bit-exact: the LCG is jumped past the n*t source draws in closed
    form, then the n*n mixing block is drawn from the exact stream
    position the Rust harness uses (benches/benchmarks.rs:27-31)."""
    state = _lcg_jump(seed, n_features * n_samples)
    states, _ = _lcg_stream(state, n_features * n_features)
    return _lcg_uniform(states).reshape(n_features, n_features) - 0.5


def generate_bench_data_device(
    n_features: int, n_samples: int, seed: int = 42
):
    """On-device f32 bench mixture with the reference harness's
    distributions (benches/benchmarks.rs:8-35).

    Sources are standard Laplace — the same law as the reference's
    inverse-CDF construction (benchmarks.rs:18-24) — drawn on the
    device with the ``rbg`` PRNG (XLA's RngBitGenerator), because host
    LCG generation of n*t samples is O(minutes) of single-core work.
    ``rbg`` keeps the stream every earlier measurement used. The mixing matrix
    IS the bit-exact reference stream block
    (:func:`reference_mixing_matrix`). Returns a committed device
    array of shape (n_features, n_samples).
    """
    import jax
    import jax.numpy as jnp

    mixing = jnp.asarray(
        reference_mixing_matrix(n_features, n_samples, seed), dtype=jnp.float32
    )

    @jax.jit
    def _gen(mixing_dev):
        from ..ops.linalg import rotate_rows_inplace_blocks

        key = jax.random.key(seed, impl="rbg")
        sources = jax.random.laplace(
            key, (n_features, n_samples), dtype=jnp.float32
        )
        # Mix via the blockwise in-place rotation (bit-identical to a
        # HIGHEST dot): XLA aliases the loop carry onto the sources
        # buffer, so generation peaks at ONE data-sized array instead
        # of two (sources + mixture) — 6.1 GB vs 12.3 at 256x6M.
        return rotate_rows_inplace_blocks(mixing_dev, sources)

    return _gen(mixing)


def generate_test_data(n: int, t: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded (sources, mixing, mixed) fixture (solver.rs:257-286)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-12, 1.0, size=(n, t))
    sign = np.where(rng.random((n, t)) < 0.5, 1.0, -1.0)
    sources = sign * (-np.log(u))
    mixing = rng.standard_normal((n, n))
    return sources, mixing, mixing @ sources


def generate_mixed_kurtosis_data(n: int, t: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mixed sub/super-Gaussian fixture for extended-mode tests
    (modeled on jade.rs:209-243): alternating Laplace (super) and
    uniform (sub) sources."""
    rng = np.random.default_rng(seed)
    sources = np.empty((n, t))
    for i in range(n):
        if i % 2 == 0:
            u = rng.uniform(1e-12, 1.0, size=t)
            sign = np.where(rng.random(t) < 0.5, 1.0, -1.0)
            sources[i] = sign * (-np.log(u))
        else:
            sources[i] = rng.uniform(-np.sqrt(3.0), np.sqrt(3.0), size=t)
    mixing = rng.standard_normal((n, n))
    return sources, mixing, mixing @ sources
