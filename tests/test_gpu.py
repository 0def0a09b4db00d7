"""Tests that run only on the card: the fused Triton kernel compiled
for the GPU (it has no interpret mode there) and the solver's route to
it. They skip elsewhere (see the ``gpu`` fixture in conftest.py);
``python chip_smoke.py`` runs them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from picard_ica_tpu import Picard, PicardConfig
from picard_ica_tpu.models.core import CoreOptions, _interpret, data_fused_step
from picard_ica_tpu.ops.densities import Cube, Tanh
from picard_ica_tpu.ops.pallas_kernels import rotated_fused_sums
from picard_ica_tpu.solver import _kernel_route
from picard_ica_tpu.utils import generate_test_data

pytestmark = pytest.mark.gpu


def test_gpu_kernel_is_compiled_not_interpreted(gpu):
    assert _interpret() is False
    assert _kernel_route(64, jnp.float32)
    assert not _kernel_route(64, jnp.float64)
    assert not _kernel_route(65, jnp.float32)


@pytest.mark.parametrize("density", [Tanh(), Cube()], ids=str)
@pytest.mark.parametrize("n,t", [(5, 3001), (64, 65_536)])
def test_gpu_kernel_matches_xla_f32(gpu, density, n, t):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.laplace(size=(n, t)), jnp.float32)
    mo = jnp.asarray(np.eye(n) + 0.05 * rng.standard_normal((n, n)), jnp.float32)
    mn = jnp.asarray(np.asarray(mo) + 0.02 * rng.standard_normal((n, n)),
                     jnp.float32)
    opts = CoreOptions(density=density, ortho=False, extended=True,
                       has_cov=True, m=7, ls_tries=10)
    dll_x, dysq_x, mom_x = data_fused_step(mn, mo, x, opts, True, True)
    dll, dysq, g, pm, h, ysq = rotated_fused_sums(
        mn, mo, x, density, True, True, interpret=False, precision="f32")
    for got, want in [(g, mom_x.g_raw), (h, mom_x.h_raw), (pm, mom_x.pm_raw),
                      (ysq, mom_x.ysq_rowmean), (dysq, dysq_x), (dll, dll_x)]:
        np.testing.assert_allclose(np.asarray(got) / t, np.asarray(want),
                                   rtol=1e-4, atol=1e-6)


def test_gpu_fit_takes_the_kernel_and_converges(gpu):
    _, a, x = generate_test_data(16, 50_000, 3)
    r = Picard.fit(x.astype(np.float32), PicardConfig(random_state=0, tol=1e-6))
    assert r.converged
    from picard_ica_tpu.utils.metrics import amari_distance

    assert amari_distance(np.asarray(r.full_unmixing(), np.float64), a) < 1e-2
    assert next(iter(r.sources.devices())).platform == "gpu"
