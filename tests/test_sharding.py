"""Multi-device SPMD correctness on a forced 8-device CPU mesh.

The fake-cluster backend the reference lacks (SURVEY.md §4d): the same
code runs on 1 device and on 8, and must agree to fp tolerance. Also
checks the explicit shard_map+psum kernels against the implicit GSPMD
path.
"""

import jax
import jax.numpy as jnp
import numpy as np

from picard_ica_tpu import Picard, PicardConfig
from picard_ica_tpu.models.core import CoreOptions, run_core_jit
from picard_ica_tpu.ops.densities import Tanh
from picard_ica_tpu.ops.moments import compute_raw_moments_xla
from picard_ica_tpu.parallel import data_sharding, shard_samples
from picard_ica_tpu.parallel.sharding import (
    compute_raw_moments_psum,
    loglik_rowmeans_psum,
)
from picard_ica_tpu.utils import amari_distance, generate_test_data


def test_eight_devices_available(eight_device_mesh):
    assert eight_device_mesh.devices.size == 8


def test_explicit_psum_moments_match_dense(eight_device_mesh):
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.standard_normal((4, 800)))
    dense = compute_raw_moments_xla(y, Tanh(), need_h=True, need_ysq_mean=True)

    y_sharded = shard_samples(y, eight_device_mesh)
    sharded = compute_raw_moments_psum(
        y_sharded, Tanh(), eight_device_mesh, need_h=True, need_ysq=True
    )

    np.testing.assert_allclose(np.asarray(sharded.g_raw), np.asarray(dense.g_raw), atol=1e-12)
    np.testing.assert_allclose(np.asarray(sharded.pm_raw), np.asarray(dense.pm_raw), atol=1e-12)
    np.testing.assert_allclose(np.asarray(sharded.h_raw), np.asarray(dense.h_raw), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(sharded.ysq_rowmean), np.asarray(dense.ysq_rowmean), atol=1e-12
    )


def test_explicit_psum_loglik_matches_dense(eight_device_mesh):
    rng = np.random.default_rng(1)
    y = jnp.asarray(rng.standard_normal((3, 640)))
    dense = jnp.mean(Tanh().log_lik(y), axis=1)
    sharded = loglik_rowmeans_psum(shard_samples(y, eight_device_mesh), Tanh(), eight_device_mesh)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense), atol=1e-12)


def test_core_loop_single_vs_multi_device(eight_device_mesh):
    """The jitted core loop gives tol-identical results on 1 vs 8 devices."""
    rng = np.random.default_rng(2)
    u = rng.uniform(0.001, 0.999, size=(3, 1600))
    x = np.sign(rng.standard_normal((3, 1600))) * (-np.log(u))
    a = rng.standard_normal((3, 3))
    from picard_ica_tpu.ops.whitening import center, whiten

    centered, _ = center(jnp.asarray(a @ x))
    xw = whiten(centered, 3).data

    opts_single = CoreOptions(
        density=Tanh(), ortho=True, extended=True, has_cov=True, m=7, ls_tries=10
    )
    res_single = run_core_jit(xw, jnp.eye(3), 1e-7, 0.01, 200, opts_single)

    sharding = data_sharding(eight_device_mesh)
    xw_sharded = jax.device_put(xw, sharding)
    opts_multi = CoreOptions(
        density=Tanh(), ortho=True, extended=True, has_cov=True, m=7,
        ls_tries=10, data_sharding=sharding,
    )
    res_multi = run_core_jit(xw_sharded, jnp.eye(3), 1e-7, 0.01, 200, opts_multi)

    assert bool(res_single.converged) == bool(res_multi.converged)
    assert int(res_single.n_iterations) == int(res_multi.n_iterations)
    np.testing.assert_allclose(
        np.asarray(res_single.w), np.asarray(res_multi.w), atol=1e-8
    )


def test_full_fit_single_vs_multi_device(eight_device_mesh):
    """End-to-end fit with mesh= gives the same separation quality."""
    _, a, x = generate_test_data(4, 4000, 42)

    r_single = Picard.fit(x, PicardConfig(random_state=0))
    r_multi = Picard.fit(x, PicardConfig(random_state=0), mesh=eight_device_mesh)

    assert r_multi.converged
    am_s = amari_distance(np.asarray(r_single.full_unmixing()), a)
    am_m = amari_distance(np.asarray(r_multi.full_unmixing()), a)
    assert abs(am_s - am_m) < 1e-6
    np.testing.assert_allclose(
        np.asarray(r_single.unmixing), np.asarray(r_multi.unmixing), atol=1e-6
    )


def test_sources_stay_sharded(eight_device_mesh):
    """The returned sources keep the (None, samples) layout — no
    gather-to-host on the hot output."""
    _, _, x = generate_test_data(3, 1600, 7)
    r = Picard.fit(x, PicardConfig(random_state=0), mesh=eight_device_mesh)
    sharding = r.sources.sharding
    assert not sharding.is_fully_replicated


def test_sharded_pallas_path_matches_single(eight_device_mesh):
    """shard_map-wrapped Pallas kernels (interpret on CPU) == single device."""
    from picard_ica_tpu import PicardConfig

    _, a, x = generate_test_data(4, 4000, 42)
    cfg = PicardConfig(random_state=0, use_pallas=True, tol=1e-6)
    r_single = Picard.fit(x, cfg)
    r_mesh = Picard.fit(x, cfg, mesh=eight_device_mesh)
    assert r_mesh.converged
    np.testing.assert_allclose(
        np.asarray(r_single.unmixing), np.asarray(r_mesh.unmixing), atol=1e-5
    )


def _variant_data(law, n, t, seed):
    rng = np.random.default_rng(seed)
    if law == "uniform":
        s = rng.uniform(-np.sqrt(3.0), np.sqrt(3.0), size=(n, t))
    else:
        u = rng.uniform(1e-6, 1.0, size=(n, t))
        s = np.sign(rng.standard_normal((n, t))) * (-np.log(u))
    return rng.standard_normal((n, n)) @ s


def test_nonortho_fastica_sharded_matches_unsharded(eight_device_mesh):
    """Non-ortho under the mesh: the sharded H moment psi'(Y)·(Y²)ᵀ/T
    (core.rs:274) + regularize_hessian, with a FastICA warm start
    (solver.rs:218's moment psum) — the SURVEY §2.3 rows the flagship
    ortho config never exercises."""
    x = _variant_data("laplace", 4, 4000, 5)
    cfg = PicardConfig(random_state=0, ortho=False, extended=True,
                       fastica_it=2, tol=1e-6, max_iter=200)
    r_single = Picard.fit_with_config(x, cfg)
    r_mesh = Picard.fit_with_config(x, cfg, mesh=eight_device_mesh)
    assert r_single.converged and r_mesh.converged
    np.testing.assert_allclose(
        np.asarray(r_single.unmixing), np.asarray(r_mesh.unmixing), atol=1e-5
    )


def test_cube_and_exp_densities_sharded_match_unsharded(eight_device_mesh):
    """The cube (sub-Gaussian, on uniform sources) and exp score
    kernels under the mesh (density.rs:91-130)."""
    from picard_ica_tpu import Cube, Exp

    for law, kw in (
        ("uniform", dict(density=Cube(), extended=False)),
        ("laplace", dict(density=Exp(), extended=True)),
    ):
        x = _variant_data(law, 4, 4000, 9)
        cfg = PicardConfig(random_state=0, ortho=True, tol=1e-6,
                           max_iter=200, **kw)
        r_single = Picard.fit_with_config(x, cfg)
        r_mesh = Picard.fit_with_config(x, cfg, mesh=eight_device_mesh)
        assert r_single.converged and r_mesh.converged, law
        np.testing.assert_allclose(
            np.asarray(r_single.unmixing), np.asarray(r_mesh.unmixing),
            atol=1e-5, err_msg=law,
        )


def test_three_device_mesh_matches_unsharded():
    """A non-power-of-2 device count: GSPMD partitioning and the psum
    reduction tree must not assume 2^k devices."""
    from picard_ica_tpu.parallel import sample_mesh

    mesh3 = sample_mesh(jax.devices("cpu")[:3])
    x = _variant_data("laplace", 3, 3 * 1024, 13)
    cfg = PicardConfig(random_state=0, tol=1e-6, max_iter=200)
    r_single = Picard.fit_with_config(x, cfg)
    r_mesh = Picard.fit_with_config(x, cfg, mesh=mesh3)
    assert r_single.converged and r_mesh.converged
    np.testing.assert_allclose(
        np.asarray(r_single.unmixing), np.asarray(r_mesh.unmixing), atol=1e-5
    )


def test_non_divisible_samples_rejected(eight_device_mesh):
    """A clear error (not an obscure device_put failure) for odd T."""
    from picard_ica_tpu import PicardConfig
    from picard_ica_tpu.errors import InvalidDimensionsError
    import pytest

    _, _, x = generate_test_data(3, 4001, 7)
    with pytest.raises(InvalidDimensionsError, match="divisible by the mesh size"):
        Picard.fit(x, PicardConfig(random_state=0), mesh=eight_device_mesh)


def test_jade_sharded_matches_unsharded(eight_device_mesh):
    """JADE warm start: explicit psum cumulant Gram on the mesh equals
    the single-device computation."""
    import jax

    from picard_ica_tpu.models.jade import compute_cumulant_matrices, jade_jit
    from picard_ica_tpu.ops.whitening import center, whiten
    from picard_ica_tpu.parallel import data_sharding
    from picard_ica_tpu.utils.datagen import generate_mixed_kurtosis_data

    n, t = 4, 8192
    _, _, x = generate_mixed_kurtosis_data(n, t, seed=5)
    xw = whiten(center(jnp.asarray(x))[0], n).data

    sharding = data_sharding(eight_device_mesh)
    xw_sharded = jax.device_put(xw, sharding)

    cum_plain = compute_cumulant_matrices(xw)
    cum_shard = compute_cumulant_matrices(xw_sharded, data_sharding=sharding)
    np.testing.assert_allclose(
        np.asarray(cum_shard), np.asarray(cum_plain), rtol=1e-10, atol=1e-10
    )

    w_plain, _ = jade_jit(xw, 30, 1e-6, False)
    w_shard, _ = jade_jit(xw_sharded, 30, 1e-6, False, data_sharding=sharding)
    np.testing.assert_allclose(
        np.asarray(w_shard), np.asarray(w_plain), rtol=1e-8, atol=1e-9
    )


def test_transform_on_sharded_data(eight_device_mesh):
    """Picard.transform applied to mesh-sharded new data matches the
    unsharded transform (GSPMD handles the K/W application)."""
    import jax

    from picard_ica_tpu import Picard, PicardConfig
    from picard_ica_tpu.parallel import data_sharding
    from picard_ica_tpu.utils.datagen import generate_test_data

    _, _, x = generate_test_data(4, 16000, seed=13)
    result = Picard.fit(x, PicardConfig(random_state=0, max_iter=100))

    y_plain = Picard.transform(x, result)
    x_sharded = jax.device_put(jnp.asarray(x, y_plain.dtype),
                               data_sharding(eight_device_mesh))
    y_shard = Picard.transform(x_sharded, result)
    np.testing.assert_allclose(
        np.asarray(y_shard), np.asarray(y_plain), rtol=1e-10, atol=1e-10
    )


def test_accept_psum_separate_from_moments(eight_device_mesh):
    """The fused line-search pass's accept-critical psums (dll, dysq)
    must not share an all-reduce with the N x N moment psums — the
    optimization barrier in core._shard_mapped orders the moment
    reductions after the accept payload so no combiner pass can merge
    them (BASELINE north-star overlap clause; docs/DESIGN.md §4)."""
    import re

    from picard_ica_tpu.models.core import data_fused_step
    from picard_ica_tpu.parallel import data_sharding as _ds

    n, t = 8, 4096
    sharding = _ds(eight_device_mesh)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((n, t)), jnp.float32)
    x = jax.device_put(x, sharding)
    m_new = jnp.eye(n, dtype=jnp.float32) * 1.01
    m_old = jnp.eye(n, dtype=jnp.float32)

    opts = CoreOptions(
        density=Tanh(), ortho=True, extended=True, has_cov=True, m=7,
        ls_tries=10, use_pallas=True, data_sharding=sharding,
        kernel_precision="f32",
    )
    fn = jax.jit(
        lambda mn, mo, x_: data_fused_step(mn, mo, x_, opts, False, False)
    )
    hlo = fn.lower(m_new, m_old, x).compile().as_text()

    # Every actual all-reduce OP (not get-tuple-element consumers),
    # with its result-shape prefix.
    ars = re.findall(
        r"= ((?:\([^)]*\)|f32\[[^=\n]*?)) all-reduce\(", hlo
    )
    assert ars, "expected at least one all-reduce in the sharded pass"
    small = f"f32[{n}]"          # dll/dysq row vectors
    big = f"f32[{n},{n}]"        # moment matrices (g, h; pm/ysq are [n])
    shape_lists = [re.findall(r"f32\[[\d,]*\]", s) for s in ars]
    # The accept payload (dll, dysq) must ride its own collective:
    # exactly two [n] tensors, no [n, n] moment matrix.
    assert any(
        len(sl) == 2 and all(s == small for s in sl) for sl in shape_lists
    ), f"no dedicated (dll, dysq) all-reduce found: {shape_lists}"
    # ... and no collective carries all six outputs (a full merge would
    # make the accept branch wait on the moment payload).
    assert all(len(sl) <= 4 for sl in shape_lists), (
        f"accept-path psum merged with the moment psums: {shape_lists}"
    )


def test_graft_dryrun_multichip_8_devices():
    """The driver's exact invocation: ``dryrun_multichip(8)`` in a fresh
    process (x64 OFF, unlike this suite). Guards the full sharded
    pipeline — whiten + JADE + staged core — converging to the same
    fixed point as the unsharded fit at the driver's device count; an
    unconverged comparison forks with psum reduction order (the 8-device
    regression this test pins)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "__graft_entry__.py"), "dryrun", "8"],
        capture_output=True, text=True, timeout=420, cwd=repo,
    )
    assert proc.returncode == 0, (
        f"dryrun_multichip(8) failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    )
