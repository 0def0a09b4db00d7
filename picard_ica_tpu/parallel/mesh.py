"""Device mesh construction and multi-host initialization.

The reference has no distributed layer at all (SURVEY.md §2.3); this is
its equivalent here. Picard ICA has exactly one shardable axis — the
i.i.d. samples axis — so the canonical mesh is 1-D over every device
(the cards of a host are joined all to all, so no device order is
preferred), with all N x N optimizer state replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

SAMPLE_AXIS = "samples"


def distributed_init(**kwargs) -> None:
    """Initialize the multi-host JAX runtime (idempotent wrapper).

    Call once per process on a multi-host run before building a mesh.
    No-op if already initialized or single-process.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # Already initialized, or single-process without a coordinator
        # (jax raises ValueError when no coordinator can be inferred).
        pass


def sample_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (default: all) with axis "samples"."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (SAMPLE_AXIS,))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """(N replicated, T sharded) layout for (n_components, n_samples)."""
    return NamedSharding(mesh, PartitionSpec(None, SAMPLE_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_samples(x, mesh: Mesh):
    """Place an (N, T) array with the samples axis sharded."""
    return jax.device_put(x, data_sharding(mesh))
