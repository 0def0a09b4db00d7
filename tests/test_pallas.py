"""The fused Triton kernel (interpret mode on CPU) and the XLA data
passes, each against plain NumPy, and the full optimizer trajectory
on both paths.

On the GPU the same kernel compiles through Triton; tests/test_gpu.py
checks it there against the XLA formulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from picard_ica_tpu.models.core import (
    CoreOptions,
    compute_loss,
    data_fused_step,
    data_loglik,
    data_moments,
    run_core,
)
from picard_ica_tpu.ops import pallas_kernels as pk
from picard_ica_tpu.ops.densities import Cube, Exp, Tanh
from picard_ica_tpu.ops.pallas_kernels import rotated_fused_sums


def _make_opts(use_pallas, **kw):
    defaults = dict(
        density=Tanh(), ortho=True, extended=True, has_cov=True, m=7,
        ls_tries=10, use_pallas=use_pallas,
    )
    defaults.update(kw)
    return CoreOptions(**defaults)


def _dense_fused(m_new, m_old, x, density, plain):
    """NumPy reference of the fused pass's unnormalized sums."""
    y_new = np.asarray(m_new) @ np.asarray(x)
    y_old = np.asarray(m_old) @ np.asarray(x)
    ll_new = np.asarray(density.log_lik(jnp.asarray(y_new)))
    ll_old = np.asarray(density.log_lik(jnp.asarray(y_old)))
    psi, psi_d = (np.asarray(v) for v in density.score_and_der(jnp.asarray(y_new)))
    if plain:
        dll, dysq = ll_new.sum(axis=1), (y_new**2).sum(axis=1)
    else:
        dll = (ll_new - ll_old).sum(axis=1)
        dysq = (y_new**2 - y_old**2).sum(axis=1)
    return (dll, dysq, psi @ y_new.T, psi_d.sum(axis=1),
            psi_d @ (y_new * y_new).T, (y_new * y_new).sum(axis=1))


@pytest.mark.parametrize("density", [Tanh(), Exp(0.5), Cube()], ids=str)
@pytest.mark.parametrize("shape", [(3, 256), (5, 1000), (8, 4096)])
def test_rotated_moments_match_dense(density, shape):
    """The moments pass (XLA; it runs at init and at stage boundaries
    only) against NumPy."""
    n, t = shape
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((n, n)) * 0.5)
    x = jnp.asarray(rng.standard_normal((n, t)))

    g, pm, h, ysq = data_moments(
        w, x, _make_opts(False, density=density, ortho=False), True, True)

    y = np.asarray(w) @ np.asarray(x)
    psi, psi_d = density.score_and_der(jnp.asarray(y))
    psi, psi_d = np.asarray(psi), np.asarray(psi_d)
    np.testing.assert_allclose(np.asarray(g) * t, psi @ y.T, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(pm) * t, psi_d.sum(axis=1), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(h) * t, psi_d @ (y * y).T, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ysq) * t, (y * y).sum(axis=1), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("density", [Tanh(), Cube()], ids=str)
@pytest.mark.parametrize("t", [255, 256, 1000])
def test_rotated_loglik_match_dense(density, t):
    """The log-lik pass (XLA; init and sign-change re-baselines)
    against NumPy."""
    n = 4
    rng = np.random.default_rng(1)
    m = jnp.asarray(rng.standard_normal((n, n)) * 0.5)
    x = jnp.asarray(rng.standard_normal((n, t)))

    ll, ysq = data_loglik(m, x, _make_opts(False, density=density), True)

    y = np.asarray(m) @ np.asarray(x)
    ll_ref = np.asarray(density.log_lik(jnp.asarray(y))).mean(axis=1)
    np.testing.assert_allclose(np.asarray(ll), ll_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ysq), (y * y).mean(axis=1), rtol=1e-9, atol=1e-9)


def test_partial_tile_masking():
    """T not divisible by the tile, and programs whose last tiles lie
    wholly past T: the padding must contribute nothing, including to
    the psi'(0) != 0 and log_lik(0) != 0 terms."""
    n, t = 3, 300
    rng = np.random.default_rng(2)
    w = jnp.asarray(np.eye(n) + 0.3 * rng.standard_normal((n, n)))
    x = jnp.asarray(rng.standard_normal((n, t)))
    # 32-column tiles -> 10 tiles; 4 target programs -> 3 tiles each,
    # so the last program's third tile starts past T.
    assert pk._BT == 32 and pk._grid(t, pk._BT, 4) == (4, 3)
    for plain in (False, True):
        got = rotated_fused_sums(w, w, x, Tanh(), True, True, interpret=True,
                                 absolute_ll=plain, target_programs=4)
        want = _dense_fused(w, w, x, Tanh(), plain)
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize(
    "mode_kw",
    [
        dict(ortho=True, extended=True),
        dict(ortho=False, extended=False),
        dict(ortho=False, extended=True),
        dict(ortho=True, extended=False),
    ],
    ids=["ortho-ext", "plain", "ext-nonortho", "ortho-plain"],
)
def test_full_core_loop_pallas_vs_xla(mode_kw):
    """The entire optimizer trajectory agrees between kernel paths."""
    rng = np.random.default_rng(3)
    u = rng.uniform(0.001, 0.999, size=(4, 2000))
    x = np.sign(rng.standard_normal((4, 2000))) * (-np.log(u))
    x -= x.mean(axis=1, keepdims=True)
    x /= x.std(axis=1, keepdims=True)
    x = jnp.asarray(x)
    cov = jnp.eye(4)

    res_xla = run_core(x, cov, 1e-7, 0.01, 60, _make_opts(False, **mode_kw))
    res_pal = run_core(x, cov, 1e-7, 0.01, 60, _make_opts(True, **mode_kw))

    assert int(res_xla.n_iterations) == int(res_pal.n_iterations)
    assert bool(res_xla.converged) == bool(res_pal.converged)
    np.testing.assert_allclose(
        np.asarray(res_xla.w), np.asarray(res_pal.w), rtol=1e-8, atol=1e-10
    )


@pytest.mark.parametrize("density", [Tanh(), Exp(0.5), Cube()], ids=str)
@pytest.mark.parametrize("t", [255, 1000])  # partial + exact tiles
def test_rotated_fused_match_dense(density, t):
    """The fused line-search+moments kernel against plain NumPy."""
    n = 4
    rng = np.random.default_rng(6)
    m_old = jnp.asarray(np.eye(n) + 0.1 * rng.standard_normal((n, n)))
    m_new = jnp.asarray(np.asarray(m_old) + 0.05 * rng.standard_normal((n, n)))
    x = jnp.asarray(rng.standard_normal((n, t)))

    got = rotated_fused_sums(m_new, m_old, x, density, True, True, interpret=True)
    want = _dense_fused(m_new, m_old, x, density, plain=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-9, atol=1e-9)


# Tier -> tolerance of the f32 kernel against the f64 NumPy reference
# on O(1) data: f32 accumulation for "f32"; the interpreter's CPU dots
# compute the bf16 algorithms in f32 as well, so only the "bf16" tier's
# own operand rounding (8 mantissa bits) widens the bound.
_TIER_RTOL = {"f32": 2e-5, "bf16x3": 2e-5, "bf16": 3e-2}


@pytest.mark.parametrize("density", [Tanh(), Exp(), Cube()], ids=str)
@pytest.mark.parametrize("precision", ["f32", "bf16x3", "bf16"])
@pytest.mark.parametrize("flags", [(True, True), (False, False)],
                         ids=["h-ysq", "no-h-ysq"])
@pytest.mark.parametrize("t", [777, 1024], ids=["partial", "exact"])
def test_fused_kernel_tiers_f32(density, precision, flags, t):
    """The f32 kernel at every precision tier, with and without the
    optional outputs, on partial and exact tiles (bt=32)."""
    need_h, need_ysq = flags
    n = 6
    rng = np.random.default_rng(21)
    m_old = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    m_new = m_old + 0.05 * rng.standard_normal((n, n))
    x = rng.standard_normal((n, t))
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731

    got = rotated_fused_sums(f32(m_new), f32(m_old), f32(x), density, need_h,
                             need_ysq, interpret=True, precision=precision)
    want = list(_dense_fused(m_new, m_old, x, density, plain=False))
    if not need_h:
        want[4] = np.zeros((n, n))
    if not need_ysq:
        want[1] = want[5] = np.zeros(n)
    for name, a, b in zip(("dll", "dysq", "g", "pm", "h", "ysq"), got, want):
        assert a.dtype == jnp.float32, name
        scale = max(np.max(np.abs(b)), 1.0)
        np.testing.assert_allclose(np.asarray(a, np.float64), b,
                                   rtol=0, atol=_TIER_RTOL[precision] * scale,
                                   err_msg=name)


def test_data_moments_dispatch_equivalence():
    """An accepted line-search try hands the next iteration its moments:
    the kernel's moments of the candidate equal the standalone moments
    pass at the same W."""
    rng = np.random.default_rng(4)
    w_old = jnp.asarray(np.eye(5) + 0.2 * rng.standard_normal((5, 5)))
    w = jnp.asarray(np.asarray(w_old) + 0.05 * rng.standard_normal((5, 5)))
    x = jnp.asarray(rng.standard_normal((5, 777)))
    mx = data_moments(w, x, _make_opts(False, ortho=False), True, True)
    _, _, mp = data_fused_step(w, w_old, x, _make_opts(True, ortho=False), True, True)
    for a, b in zip(mx, mp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_loss_pallas_vs_xla():
    """The plain-accept kernel's absolute row means rebuild the same
    loss as compute_loss."""
    rng = np.random.default_rng(5)
    w = jnp.asarray(rng.standard_normal((4, 4)))
    x = jnp.asarray(rng.standard_normal((4, 500)))
    signs = jnp.asarray([1.0, -1.0, 1.0, -1.0])
    for kw in [dict(ortho=True, extended=True), dict(ortho=False, extended=True)]:
        opts = _make_opts(True, plain_ls=True, **kw)
        need_ysq = opts.extended and not opts.ortho
        ll, ysq, _ = data_fused_step(w, w, x, opts, not opts.ortho, need_ysq)
        lp = jnp.sum(signs * ll) + (0.5 * jnp.sum(ysq) if need_ysq else 0.0)
        if not opts.ortho:
            lp = lp - jnp.linalg.slogdet(w)[1]
        lx = compute_loss(w, x, signs, _make_opts(False, **kw))
        np.testing.assert_allclose(float(lx), float(lp), rtol=1e-10)


def test_auto_precision_stages_identical_at_f64():
    """kernel_precision="auto" resolves to the single exact stage at f64
    on both paths, so the trajectory matches a pinned "f32" run."""
    rng = np.random.default_rng(8)
    u = rng.uniform(0.001, 0.999, size=(4, 3000))
    x = np.sign(rng.standard_normal((4, 3000))) * (-np.log(u))
    x -= x.mean(axis=1, keepdims=True)
    x /= x.std(axis=1, keepdims=True)
    x = jnp.asarray(x)
    cov = jnp.eye(4)

    res_f32 = run_core(x, cov, 1e-7, 0.01, 100, _make_opts(True, kernel_precision="f32"))
    res_auto = run_core(x, cov, 1e-7, 0.01, 100, _make_opts(True, kernel_precision="auto"))

    assert int(res_f32.n_iterations) == int(res_auto.n_iterations)
    assert bool(res_f32.converged) == bool(res_auto.converged)
    assert res_auto.stage_exits.shape == (1,)
    np.testing.assert_allclose(
        np.asarray(res_f32.w), np.asarray(res_auto.w), rtol=1e-8, atol=1e-9
    )


@pytest.mark.parametrize("density", [Tanh(), Exp(), Cube()])
def test_rotated_fused_plain_mode_match_dense(density):
    """absolute_ll=True: the plain cheap-tier accept path returns the
    candidate's ABSOLUTE log-lik / Y^2 row sums and the same moments."""
    n, t = 4, 700  # partial last tile exercises the ll masking
    rng = np.random.default_rng(8)
    m_old = jnp.asarray(np.eye(n) + 0.1 * rng.standard_normal((n, n)))
    m_new = jnp.asarray(np.asarray(m_old) + 0.05 * rng.standard_normal((n, n)))
    x = jnp.asarray(rng.standard_normal((n, t)))

    got = rotated_fused_sums(m_new, m_old, x, density, True, True,
                             interpret=True, absolute_ll=True)
    want = _dense_fused(m_new, m_old, x, density, plain=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-9, atol=1e-9)


def test_core_plain_ls_matches_delta_fixed_point():
    """A core run whose line search uses the plain accept converges to
    the same separation as the delta-form run (the two accept tests
    order the same candidates whenever the loss resolution suffices)."""
    import dataclasses

    from picard_ica_tpu.models.core import run_core_jit
    from picard_ica_tpu.ops.whitening import center, whiten
    from picard_ica_tpu.utils import amari_distance, generate_test_data

    _, a, x = generate_test_data(4, 6000, seed=12)
    xc, _ = center(jnp.asarray(x))
    xw = whiten(xc, 4).data
    cov = jnp.eye(4, dtype=xw.dtype)

    base = CoreOptions(density=Tanh(), ortho=True, extended=True, has_cov=True,
                       m=7, ls_tries=10, use_pallas=True)
    r_delta = run_core_jit(xw, cov, 1e-6, 0.01, 200, base)
    r_plain = run_core_jit(
        xw, cov, 1e-6, 0.01, 200, dataclasses.replace(base, plain_ls=True)
    )
    assert bool(r_delta.converged) and bool(r_plain.converged)
    am = amari_distance(
        np.asarray(r_plain.w), np.linalg.inv(np.asarray(r_delta.w))
    )
    assert am < 1e-6, am


def test_fused_kernel_accepts_bf16_x():
    """bf16 X copy (the cheap tier's halved read): outputs stay f32 and
    match the f32-input run to bf16 rounding."""
    n, t = 4, 512
    rng = np.random.default_rng(9)
    m_old = jnp.asarray(np.eye(n, dtype=np.float32))
    m_new = jnp.asarray(
        np.eye(n, dtype=np.float32) + 0.05 * rng.standard_normal((n, n)).astype(np.float32)
    )
    x32 = jnp.asarray(rng.standard_normal((n, t)).astype(np.float32))
    x16 = x32.astype(jnp.bfloat16)

    out32 = rotated_fused_sums(m_new, m_old, x32, Tanh(), False, False,
                               interpret=True, precision="bf16",
                               absolute_ll=True)
    out16 = rotated_fused_sums(m_new, m_old, x16, Tanh(), False, False,
                               interpret=True, precision="bf16",
                               absolute_ll=True)
    for a, b in zip(out32, out16):
        assert b.dtype == jnp.float32
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-2, atol=2e-2
        )


@pytest.mark.parametrize("n,npad", [(1, 16), (4, 16), (16, 16), (17, 32),
                                    (64, 64), (100, 128), (128, 128)])
def test_padded_n(n, npad):
    """N is padded to a power of two >= 16 (Triton's smallest dot)."""
    assert pk.padded_n(n) == npad


@pytest.mark.parametrize("t,bt,target", [(4_000_000, 32, 1056), (300, 32, 4),
                                         (31, 32, 1056), (10**6, 64, 7)])
def test_grid_covers_every_tile_once(t, bt, target):
    """Programs own contiguous tile ranges that cover every column
    tile, at most ``target`` programs, and only the last program runs
    past the final tile."""
    n_programs, steps = pk._grid(t, bt, target)
    n_tiles = -(-t // bt)
    assert n_programs <= target
    assert n_programs * steps >= n_tiles
    assert (n_programs - 1) * steps < n_tiles


def test_kernel_rejects_n_above_cap():
    x = jnp.zeros((pk.MAX_N + 1, 64), jnp.float32)
    w = jnp.eye(pk.MAX_N + 1, dtype=jnp.float32)
    with pytest.raises(ValueError, match="N <="):
        rotated_fused_sums(w, w, x, Tanh(), False, False, interpret=True)
