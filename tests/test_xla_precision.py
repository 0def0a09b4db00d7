"""Staged precision on the XLA data path.

The solver routes N > 64 (and every f64 fit) to the XLA path, so
`kernel_precision="auto"` must run the same bf16 -> bf16x3 -> f32 tier
schedule there as the fused kernel does (one shared tier definition,
ops/precision.tier_dot), and each tier must name one explicit dot
algorithm. Reference anchor: core.rs:211-276 (the hot contractions
being tiered).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from picard_ica_tpu.models.core import (
    CoreOptions,
    _precision_stages,
    data_fused_step,
    run_core,
)
from picard_ica_tpu.ops.densities import Tanh
from picard_ica_tpu.ops.precision import matmul_tiered
from picard_ica_tpu.utils.metrics import amari_distance


def _opts(**kw):
    defaults = dict(
        density=Tanh(), ortho=True, extended=True, has_cov=True, m=7,
        ls_tries=10, use_pallas=False,
    )
    defaults.update(kw)
    return CoreOptions(**defaults)


def _laplace(n, t, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.001, 0.999, size=(n, t))
    s = np.sign(rng.standard_normal((n, t))) * (-np.log(u))
    s -= s.mean(axis=1, keepdims=True)
    s /= s.std(axis=1, keepdims=True)
    return s


class TestMatmulTiered:
    """The tier ladder's accuracy ordering on plain XLA dots."""

    def setup_method(self, _):
        rng = np.random.default_rng(3)
        self.a = rng.standard_normal((32, 32)).astype(np.float32)
        self.b = rng.standard_normal((32, 5000)).astype(np.float32)

    def _rel_err(self, precision):
        exact = np.asarray(self.a, np.float64) @ np.asarray(self.b, np.float64)
        got = np.asarray(matmul_tiered(
            jnp.asarray(self.a), jnp.asarray(self.b), jnp.float32, precision
        ), np.float64)
        return np.max(np.abs(got - exact) / np.maximum(np.abs(exact), 1.0))

    def test_tier_accuracy_ladder(self):
        e_f32 = self._rel_err("f32")
        e_x3 = self._rel_err("bf16x3")
        e_bf = self._rel_err("bf16")
        # f32 (HIGHEST) ~1e-7 here; bf16x3 keeps ~16 mantissa bits of
        # the OPERANDS so the dot lands within ~1e-4; bf16 rounds the
        # operands to 8 bits (~4e-3 elementwise).
        assert e_f32 < 3e-6
        assert e_x3 < 3e-4
        assert e_bf < 2e-1
        assert e_f32 <= e_x3 <= e_bf
        # bf16x3 must genuinely beat bf16 (three passes buy mantissa).
        assert e_x3 < e_bf / 5

    def test_f64_falls_through_to_highest(self):
        a64 = jnp.asarray(self.a, jnp.float64)
        b64 = jnp.asarray(self.b, jnp.float64)
        exact = jnp.dot(a64, b64, precision=jax_HI())
        for precision in ("bf16", "bf16x3", "f32"):
            got = matmul_tiered(a64, b64, jnp.float64, precision)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))


@pytest.mark.parametrize("tier,algorithm", [
    ("bf16", "BF16_BF16_F32"),
    ("bf16x3", "BF16_BF16_F32_X3"),
    ("f32", "HIGHEST"),
])
def test_tier_names_one_dot_algorithm(tier, algorithm):
    """Each tier is pinned to one explicit dot algorithm or operand
    precision (so that it means the same on every backend and inside
    the Triton kernel), and the lowered f32 dot carries it;
    Precision.HIGH, which XLA:GPU runs as TF32, is used by no tier."""
    import jax

    from picard_ica_tpu.ops.precision import TIER_ALGORITHMS, tier_dot

    expected = (jax.lax.Precision.HIGHEST if algorithm == "HIGHEST"
                else getattr(jax.lax.DotAlgorithmPreset, algorithm))
    assert TIER_ALGORITHMS[tier] == expected
    a = jnp.ones((4, 8), jnp.float32)
    b = jnp.ones((8, 16), jnp.float32)
    dims = (((1,), (0,)), ((), ()))
    jaxpr = str(jax.make_jaxpr(
        lambda p, q: tier_dot(p, q, dims, jnp.float32, tier))(a, b))
    assert algorithm in jaxpr
    assert "Precision.HIGH," not in jaxpr and "Precision.HIGH)" not in jaxpr


def test_f32_tier_survives_sample_sharding(eight_device_mesh):
    """The sample-sharded rotation W @ X keeps the exact f32 tier after
    SPMD partitioning (the partitioner drops a dot's algorithm there but
    keeps its operand precision; on the GPU a dropped tier runs TF32)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from picard_ica_tpu.ops.precision import tier_dot

    x = jax.device_put(
        jnp.ones((8, 4096), jnp.float32),
        NamedSharding(eight_device_mesh, PartitionSpec(None, "samples")))
    w = jnp.eye(8, dtype=jnp.float32)
    dims = (((1,), (0,)), ((), ()))
    hlo = jax.jit(lambda a, b: tier_dot(a, b, dims, jnp.float32, "f32")).lower(
        w, x).compile().as_text()
    dots = [line for line in hlo.splitlines() if " dot(" in line]
    assert dots and all("operand_precision={highest,highest}" in d
                        for d in dots), dots


def jax_HI():
    import jax

    return jax.lax.Precision.HIGHEST


def test_stage_schedule_xla_f32_vs_f64():
    """auto on the XLA path: staged at f32 (the large-N regime),
    single-stage at f64 (the oracle-lockstep conformance surface)."""
    opts = _opts(kernel_precision="auto")
    assert [p for p, _ in _precision_stages(opts, jnp.float32)] == [
        "bf16", "bf16x3", "f32"]
    assert [p for p, _ in _precision_stages(opts, jnp.float64)] == ["f32"]
    # Pinned precisions stay single-stage everywhere.
    assert [p for p, _ in _precision_stages(
        _opts(kernel_precision="f32"), jnp.float32)] == ["f32"]


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
def test_fused_step_xla_tier_tracks_highest(precision):
    """The tiered XLA fused pass returns the same quantities as the
    HIGHEST pass to each tier's expected resolution."""
    rng = np.random.default_rng(11)
    n, t = 8, 4096
    m_old = jnp.asarray(np.eye(n) + 0.1 * rng.standard_normal((n, n)),
                        jnp.float32)
    m_new = jnp.asarray(
        np.asarray(m_old) + 0.05 * rng.standard_normal((n, n)), jnp.float32)
    x = jnp.asarray(rng.standard_normal((n, t)), jnp.float32)

    hi = data_fused_step(m_new, m_old, x, _opts(kernel_precision="f32"),
                         True, True)
    lo = data_fused_step(m_new, m_old, x, _opts(kernel_precision=precision),
                         True, True)
    tol = 2e-3 if precision == "bf16x3" else 1e-1
    for a, b in zip(
        (hi[0], hi[1]) + tuple(hi[2]), (lo[0], lo[1]) + tuple(lo[2])
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_run_core_xla_staged_converges_like_pinned_f32():
    """End-to-end XLA staged fit: same fixed point as the pinned-f32
    run (the tiers only re-order WHERE the iterations are spent), all
    three stages visited, final tier does the converging."""
    n, t = 6, 20000
    rng = np.random.default_rng(7)
    mixing = np.eye(n) + 0.3 * rng.standard_normal((n, n))
    x = jnp.asarray(mixing @ _laplace(n, t, 7), jnp.float32)
    # Whiten so the core sees its contract (unit covariance).
    cov = np.cov(np.asarray(x))
    d, e = np.linalg.eigh(cov)
    k = (e / np.sqrt(d)) @ e.T
    xw = jnp.asarray(k @ np.asarray(x), jnp.float32)
    cov_i = jnp.eye(n, dtype=jnp.float32)

    res_f32 = run_core(xw, cov_i, 1e-7, 0.01, 200,
                       _opts(kernel_precision="f32"))
    res_auto = run_core(xw, cov_i, 1e-7, 0.01, 200,
                        _opts(kernel_precision="auto"))

    assert res_auto.stage_exits.shape == (3,)
    assert bool(res_auto.converged)
    assert float(res_auto.gradient_norm) <= 1e-7
    # Same basin/fixed point as the exact-precision trajectory.
    assert amari_distance(
        np.asarray(res_auto.w), np.linalg.pinv(np.asarray(res_f32.w))
    ) < 1e-4
    # The schedule is genuinely staged: the cheap tier makes progress
    # before the handoff (stage 0 exits after at least one iteration).
    exits = np.asarray(res_auto.stage_exits)
    assert exits[0] >= 1
    assert exits[-1] == int(res_auto.n_iterations)


def test_run_core_xla_f64_auto_single_stage():
    """f64 XLA fits keep the exact single-stage trajectory the C++
    oracle lockstep (tests/test_native.py) was measured against."""
    n, t = 4, 3000
    x = jnp.asarray(_laplace(n, t, 8), jnp.float64)
    cov = jnp.eye(n, dtype=jnp.float64)

    res_auto = run_core(x, cov, 1e-7, 0.01, 100, _opts(kernel_precision="auto"))
    res_f32 = run_core(x, cov, 1e-7, 0.01, 100, _opts(kernel_precision="f32"))

    assert res_auto.stage_exits.shape == (1,)
    assert int(res_auto.n_iterations) == int(res_f32.n_iterations)
    np.testing.assert_array_equal(np.asarray(res_auto.w), np.asarray(res_f32.w))
