"""picard_ica_tpu — a Picard ICA framework for accelerators.

A from-scratch JAX/XLA/Pallas implementation of the Picard and Picard-O
ICA algorithms (Ablin, Cardoso, Gramfort, IEEE TSP 2018,
arXiv:1706.08171) with the full capability surface of the reference
``lmmx/picard-ica`` Rust crate, re-designed for an accelerator:

  * a single jitted ``lax.while_loop`` optimizer with fixed-shape
    L-BFGS state,
  * sample-sharded data over a ``jax.sharding.Mesh`` with psum moment
    reductions (multi-device / multi-host via ``parallel``),
  * a fused Triton kernel for the hot N x T pass on the GPU,
  * tanh/exp/cube densities, extended sub/super-Gaussian mode,
    PCA whitening, JADE and FastICA warm starts.

Example::

    import numpy as np
    from picard_ica_tpu import Picard, PicardConfig

    x = np.random.randn(10, 1000)          # (n_features, n_samples)
    result = Picard.fit(x)                  # defaults: Picard-O, tanh

    config = (PicardConfig.builder()
              .n_components(5).max_iter(200).ortho(True).build())
    result = Picard.fit_with_config(x, config)
    sources, unmixing = result.sources, result.unmixing
"""

from .config import ConfigBuilder, PicardConfig
from .errors import (
    ComputationError,
    InvalidConfigError,
    InvalidDimensionsError,
    NotConvergedError,
    PicardError,
    SingularMatrixError,
)
from .ops.densities import Cube, Density, DensityType, Exp, Tanh
from .results import PicardResult
from .solver import Picard

from . import checkpoint, ops, parallel, utils  # noqa: E402  (public subpackages)
from .checkpoint import load_result, resume_config, save_result

__version__ = "0.1.0"

__all__ = [
    "Picard",
    "PicardConfig",
    "ConfigBuilder",
    "PicardResult",
    "PicardError",
    "NotConvergedError",
    "InvalidDimensionsError",
    "SingularMatrixError",
    "ComputationError",
    "InvalidConfigError",
    "Density",
    "DensityType",
    "Tanh",
    "Exp",
    "Cube",
    "ops",
    "parallel",
    "utils",
    "checkpoint",
    "save_result",
    "load_result",
    "resume_config",
]
