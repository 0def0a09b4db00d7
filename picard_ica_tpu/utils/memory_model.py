"""Single-device memory peak model for a full bench/fit pipeline.

Turns the pipeline's buffer anatomy into arithmetic a test can pin, so
a buffer-structure change that would lower the largest T one device
can fit shows up as a failing test instead of an out-of-memory error.

Phase anatomy (f32 data; ``nf`` = n_features of the raw data, ``n`` =
n_components, usually equal on the bench path):

  datagen     1 data buffer — sources are mixed IN PLACE via the
              blockwise aliased rotation (utils/datagen.py:_gen).
  stats       x + the chunked covariance partials (pairwise fold,
              ~n_chunks * nf^2 — KB-scale). As XLA:GPU compiles it,
              this phase also materializes the centered copy and the
              padded chunk transpose, which this model does not count
              yet (PERF.md: measured peaks run above the model).
  projection  x (nf, T) + x1 (n, T): the whitened copy materializes
              while the raw data is still alive — THE binding phase
              at 2 full data buffers (ops/whitening._project_centered).
  refine      x1 rotated in place + one rotation block
              (ops/linalg.rotate_rows_inplace_blocks).
  core        x1 donated (aliased onto the final Y) + either the
              kernel path's bf16 X copy for the staged schedule's
              first tier (half a buffer, models/core.py; the kernel's
              per-program partials are a few MB) or the XLA path's
              rotated-Y materialization (one buffer).

The arena is what the allocator may hand out on the device
(``memory_stats()["bytes_limit"]``): the model predicts, the device
decides. chip_smoke.py prints both beside the measured peak.
"""

from __future__ import annotations

_ELEM = 4  # f32 bytes; the device pipeline is f32 end to end


def device_arena_bytes(device=None) -> int:
    """The allocator limit of ``device`` (default: the first device)."""
    import jax

    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device.device_kind} reports no bytes_limit; pass arena_bytes"
        )
    return int(stats["bytes_limit"])


def phase_peak_bytes(
    n: int,
    t: int,
    n_features: int | None = None,
    cheap_tier: bool = True,
    use_pallas: bool = True,
) -> dict:
    """Per-phase device-memory peaks (bytes) for a
    datagen→whiten→fit pipeline.

    ``cheap_tier``: the staged-precision schedule's first tier keeps a
    bf16 copy of X on the kernel path. ``use_pallas``: the fused kernel
    path; the XLA path's moment temporaries are fusion-managed instead
    (modeled at one extra data buffer for the rotated-Y
    materialization).
    """
    nf = n_features if n_features is not None else n
    data = nf * t * _ELEM      # raw (n_features, T) buffer
    comp = n * t * _ELEM       # whitened (n_components, T) buffer

    from ..ops.linalg import ROTATE_BLOCK_T

    block = n * min(ROTATE_BLOCK_T, t) * _ELEM

    if use_pallas:
        core_extra = comp // 2 if cheap_tier else 0
    else:
        core_extra = comp

    return {
        "datagen": data + block,                 # in-place mix + block
        "stats": data + 64 * nf * nf * _ELEM,    # chunked cov partials
        "projection": data + comp,               # raw + whitened alive
        "refine": comp + block,                  # in-place re-rotation
        "core": comp + core_extra,
    }


def fit_peak_bytes(n: int, t: int, **kw) -> int:
    """Pipeline peak: the max over phase peaks."""
    return max(phase_peak_bytes(n, t, **kw).values())


def binding_phase(n: int, t: int, **kw) -> str:
    """Name of the phase that sets the pipeline peak."""
    phases = phase_peak_bytes(n, t, **kw)
    return max(phases, key=phases.get)


def max_t(
    n: int,
    arena_bytes: float | None = None,
    step: int = 1_000_000,
    **kw,
) -> int:
    """Largest T (multiple of ``step``) whose pipeline peak fits in
    ``arena_bytes`` (default: the first device's allocator limit)."""
    if arena_bytes is None:
        arena_bytes = device_arena_bytes()
    t = step
    while fit_peak_bytes(n, t + step, **kw) <= arena_bytes:
        t += step
    return t
