"""Multi-device scaling harness (BASELINE.md: >= 80% linear throughput
scaling from 1 device to many).

Shards the samples axis over 1, 2, 4, ... all available devices and
reports grad-loop samples/s plus scaling efficiency vs the 1-device
run. T scales WITH the mesh (weak scaling — the regime the north star
describes: a fixed per-chip shard of an ever-larger recording).

On several hosts, launch one process per host with
``picard_ica_tpu.parallel.distributed_init()`` (the harness calls it;
it is a no-op single-process). On one card the harness degenerates to
the 1-device row — the sharded code path itself is exercised on an
8-device CPU mesh by tests/test_sharding.py and by
__graft_entry__.dryrun_multichip, and on four cards by
``chip_smoke.py --four``.

Usage:
    python benchmarks/scaling.py [--n 64] [--t-per-chip 1000000] [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_at(n_devices: int, n: int, t_per_chip: int, reps: int) -> dict:
    import jax
    import jax.numpy as jnp

    from picard_ica_tpu.models.core import CoreOptions, run_core_jit
    from picard_ica_tpu.ops.densities import Tanh
    from picard_ica_tpu.ops.whitening import center_whiten
    from picard_ica_tpu.parallel import data_sharding, sample_mesh, shard_samples
    from picard_ica_tpu.solver import _kernel_route
    from picard_ica_tpu.utils.datagen import generate_bench_data

    t = t_per_chip * n_devices
    x = generate_bench_data(n, t, seed=42).astype(np.float32)

    mesh = sample_mesh(jax.devices()[:n_devices])
    sharding = data_sharding(mesh)

    xs = shard_samples(jnp.asarray(x), mesh)
    xw, _, _ = center_whiten(xs, n)
    xw = jax.device_put(xw, sharding)
    jax.block_until_ready(xw)

    opts = CoreOptions(
        density=Tanh(), ortho=True, extended=True, has_cov=True,
        m=7, ls_tries=10,
        use_pallas=_kernel_route(n, jnp.float32),
        kernel_precision="auto",
        data_sharding=sharding,
    )
    cov = jnp.eye(n, dtype=jnp.float32)

    res = run_core_jit(xw, cov, 1e-7, 0.01, 50, opts)
    jax.block_until_ready(res)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run_core_jit(xw, cov, 1e-7, 0.01, 50, opts)
        jax.block_until_ready(res)
        best = min(best, time.perf_counter() - t0)
    iters = int(res.n_iterations)
    return {
        "n_devices": n_devices,
        "t_total": t,
        "iters": iters,
        "samples_per_s": t * iters / best,
        "samples_per_s_per_chip": t * iters / best / n_devices,
        "wall_s": best,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--t-per-chip", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--devices", type=int, default=None,
                    help="with --cpu: force this many virtual host devices")
    args = ap.parse_args()

    if args.devices:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        )
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from picard_ica_tpu.parallel import distributed_init

    distributed_init()

    import jax

    n_avail = len(jax.devices())
    print(f"backend: {jax.default_backend()}, devices: {n_avail}", file=sys.stderr)

    counts = []
    c = 1
    while c <= n_avail:
        counts.append(c)
        c *= 2
    if counts[-1] != n_avail:
        counts.append(n_avail)

    rows = [run_at(c, args.n, args.t_per_chip, args.reps) for c in counts]
    base = rows[0]["samples_per_s_per_chip"]
    for r in rows:
        r["scaling_efficiency"] = r["samples_per_s_per_chip"] / base
        print(
            f"devices={r['n_devices']:3d} T={r['t_total']:>10d} "
            f"{r['samples_per_s']:.3e} samples/s "
            f"({r['scaling_efficiency']*100:.1f}% efficiency)",
            file=sys.stderr,
        )

    out = {"backend": jax.default_backend(), "n": args.n, "rows": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, default=float)
    else:
        json.dump(out, sys.stdout, indent=2, default=float)
        print()


if __name__ == "__main__":
    main()
