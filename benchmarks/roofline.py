"""Published peak rates of the cards the benchmarks divide by.

One table, keyed by ``jax.Device.device_kind``. A device that is not in
it is an error, not a default: a fraction of the wrong card's peak
would read as a measurement.

Each tier's dots run at one of these rates (ops/precision.py):
``bf16`` one bf16 tensor-core product, ``bf16x3`` three of them,
``f32`` IEEE f32 outside the tensor cores. GEMM work is charged in
products of the tier's kind before dividing by that kind's peak.
"""

from __future__ import annotations

PEAKS = {
    # NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
    # full 700 W power limit; a card set lower cannot hold them.
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet (dense, 700 W)",
    },
}

# Tier -> (peak the tier's products run at, products per dot).
TIER_RATE = {
    "bf16": ("bf16_flops", 1),
    "bf16x3": ("bf16_flops", 3),
    "f32": ("f32_flops", 1),
    "f64": ("f32_flops", 1),
}


def peaks(device_kind: str) -> dict:
    """The published peaks of ``device_kind``; KeyError if unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add its "
            f"data-sheet rates to benchmarks/roofline.py"
        ) from None
