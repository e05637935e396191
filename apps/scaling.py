#!/usr/bin/env python
"""Strong/weak scaling benchmark over device counts.

Capability match for the reference's scalability scripts
(`apps/bin/strong_scalability.sh:1-18`, `weak_scalability.sh`: mpirun -np 1..N
sweeps). Here: the distributed PR/SSSP/BFS steps run over an n-device mesh for
n in a sweep; on hardware with one chip, set JAX_PLATFORMS=cpu with
--xla_force_host_platform_device_count to validate scaling structure (the
reference requires a real cluster; the CPU mesh is the fake-cluster upgrade)."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", default="1,2,4,8")
    p.add_argument("-s", type=int, default=14)
    p.add_argument("-e", type=int, default=16)
    p.add_argument("--weak", action="store_true",
                   help="weak scaling: scale grows with device count")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = p.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=" +
                                   args.devices.split(",")[-1]).strip()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    from vectorgraphlibrary.io import generation
    from vectorgraphlibrary.parallel import sharded
    from vectorgraphlibrary.parallel.shard_build import import_sharded
    from vectorgraphlibrary.parallel.mesh import make_mesh

    counts = [int(x) for x in args.devices.split(",")]
    avail = len(jax.devices())
    results = []
    base_eps = None
    for n in counts:
        if n > avail:
            print(f"skip n={n}: only {avail} devices")
            continue
        scale = args.s + (n.bit_length() - 1 if args.weak else 0)
        ec = generation.rmat(scale=scale, avg_degree=args.e, seed=42)
        # the FLAGSHIP distributed path: sharded TILE_CSR, one dst-range shard
        # per device, tiled advance per shard, full loop inside shard_map
        sg = import_sharded(ec, n)
        mesh = make_mesh(n, 1, jax.devices()[:n])
        run = sharded.make_pr_sharded(sg, mesh, ec,
                                      max_iterations=args.iters)
        jax.block_until_ready(run())          # compile
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        dt = (time.perf_counter() - t0) / args.iters
        eps = ec.edges_count / dt
        if base_eps is None:
            base_eps = eps / n if args.weak else eps
            base_dt = dt
        if args.cpu:
            # virtual mesh on shared physical cores: n devices cannot run
            # faster in aggregate. Ideal STRONG scaling is CONSTANT wall
            # time while per-device work drops n-fold → eff = t_1/t_n.
            # Ideal WEAK scaling grows aggregate work n-fold on the same
            # fixed cores, so wall time grows ~n-fold → eff = n·t_1/t_n
            # (1.0 when t_n = n·t_1; collective overhead shows as <1).
            eff = (n * base_dt) / dt if args.weak else base_dt / dt
        else:
            eff = eps / (base_eps * n)
        results.append(dict(devices=n, scale=scale, edges=ec.edges_count,
                            edges_per_device=ec.edges_count // n,
                            s_per_iter=round(dt, 5), mteps=round(eps / 1e6, 1),
                            efficiency=round(eff, 3)))
        print(results[-1])
    print(json.dumps({"mode": "weak" if args.weak else "strong",
                      "virtual_mesh": bool(args.cpu),
                      "results": results}))


if __name__ == "__main__":
    main()
