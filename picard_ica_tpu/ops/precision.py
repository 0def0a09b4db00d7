"""Matmul precision tiers shared by the fused kernel and the XLA path.

Each tier names one explicit dot algorithm, so that it means the same
thing on every backend and inside the Triton kernel (reference
precision context: core.rs:211-276 runs every contraction at f64):

  * ``"bf16"``   — ``BF16_BF16_F32``: operands rounded to bf16 (8
    mantissa bits), one tensor-core product, f32 accumulation;
  * ``"bf16x3"`` — ``BF16_BF16_F32_X3``: each f32 operand split into a
    bf16 hi and lo part, three tensor-core products (hi*hi + hi*lo +
    lo*hi), ~16 mantissa bits;
  * ``"f32"``    — ``Precision.HIGHEST``: IEEE f32 products outside
    the tensor cores (the ``F32_F32_F32`` algorithm). Named by operand
    precision rather than by algorithm because XLA's SPMD partitioner
    keeps operand precision but drops the algorithm of a dot whose
    non-contracting dimension is sharded — the sample-sharded rotation
    ``W @ X`` — which on the GPU would turn the exact tier into TF32
    and stall a sharded fit near gnorm 1e-5. (The bf16x3 algorithm is
    dropped there the same way: a sharded bf16x3 stage rotates at
    TF32, ROADMAP.)

All tiers fall through to ``Precision.HIGHEST`` at f64 (the conformance
surface), where a bf16 split would LOSE precision. The XLA CPU backend
computes the two bf16 algorithms in plain f32; the bf16 tier therefore
also casts its operands, so that its rounding is the same everywhere.

``Precision.HIGH`` is deliberately not used: XLA:GPU runs it as TF32
(10 mantissa bits), not as the three-pass split the middle tier's
handoff threshold assumes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST
_ALGO = jax.lax.DotAlgorithmPreset

# Standard 2-D matmul dimension numbers for dot_general.
_MM_DIMS = (((1,), (0,)), ((), ()))

TIER_ALGORITHMS = {
    "bf16": _ALGO.BF16_BF16_F32,
    "bf16x3": _ALGO.BF16_BF16_F32_X3,
    "f32": _HI,
}


def tier_dot(a, b, dims, acc, precision: str):
    """``dot_general(a, b, dims)`` at the requested precision tier,
    returned in ``acc`` (f32 for f32 and bf16 inputs, f64 at f64)."""
    if acc == jnp.float64:
        return jax.lax.dot_general(a, b, dims, preferred_element_type=acc,
                                   precision=_HI)
    if precision == "bf16":
        a = a.astype(jnp.bfloat16)
        b = b.astype(jnp.bfloat16)
    else:
        a = a.astype(jnp.float32)
        b = b.astype(jnp.float32)
    return jax.lax.dot_general(
        a, b, dims, precision=TIER_ALGORITHMS[precision],
        preferred_element_type=jnp.float32,
    ).astype(acc)


def matmul_tiered(a, b, acc, precision: str):
    """2-D ``a @ b`` at the requested tier — the XLA data path's hot
    dot (models/core.data_fused_step)."""
    return tier_dot(a, b, _MM_DIMS, acc, precision)
