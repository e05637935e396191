#!/usr/bin/env python
"""SSSP + CC + BFS on the LiveJournal-scale replica (one import, the
small-graph batch protocols from bench.py's real-graph block, one JSON line
per row on stdout). This is the BASELINE "SSSP + CC on soc-LiveJournal, single
chip" config run on `lj-replica` (apps/make_lj_replica.py — zero egress
blocks the real download; same scale, Chung-Lu degree mix)."""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def main():
    import numpy as np
    import jax
    import jax.numpy as jnp
    from vectorgraphlibrary.runtime.cache import enable_persistent_cache
    enable_persistent_cache()
    from vectorgraphlibrary.io import corpus
    from vectorgraphlibrary.graph.device import import_graph
    from vectorgraphlibrary.graph.edges import build_edge_array_from_host
    from vectorgraphlibrary.models import bfs, sssp, cc, common

    name = "lj-replica"
    ec = corpus.load(name, fetch=False)
    if ec is None:
        print(json.dumps({"note": "run apps/make_lj_replica.py first"}))
        return 1
    metrics = []

    def emit(metric, value, unit, **extra):
        rec = {"metric": metric, "value": round(value, 1), "unit": unit,
               "graph": name, "v": ec.vertices_count, "e": ec.edges_count}
        rec.update(extra)
        metrics.append(rec)
        print(json.dumps(rec), flush=True)

    sync = jax.block_until_ready

    t0 = time.time()
    log(f"importing {name}: |V|={ec.vertices_count:,} |E|={ec.edges_count:,}")
    if ec.weights is None:
        ec = ec.with_random_weights(7)
    host = []
    g = import_graph(ec, _host_out=host)
    ea = build_edge_array_from_host(ec.weights, g, host[0], host[1])
    del host
    log(f"imported ({time.time()-t0:.0f}s)")

    # SSSP: 8 sources in one dispatch (69M edges is ABOVE the all-active
    # crossover; vgl_dijkstra_multi picks per-size strategy itself)
    k = 8
    srcs_w = [common.select_random_source(ec, seed=s) for s in range(k)]
    srcs_m = [common.select_random_source(ec, seed=100 + s) for s in range(k)]
    log("SSSP compile+warmup ...")
    sync(sssp.vgl_dijkstra_multi(g, ea, srcs_w).values)
    t0 = time.perf_counter()
    sync(sssp.vgl_dijkstra_multi(g, ea, srcs_m).values)
    dt = (time.perf_counter() - t0) / k
    emit(f"sssp_{name}_mteps", ec.edges_count / dt / 1e6, "MTEPS", sources=k)

    log("CC compile+warmup ...")
    rngh = np.random.default_rng(3)
    hubs_w = rngh.integers(0, ec.vertices_count, 4).tolist()
    hubs_m = rngh.integers(0, ec.vertices_count, 4).tolist()
    sync(cc.vgl_cc_hybrid_multi(g, hubs_w).values)
    t0 = time.perf_counter()
    labels = cc.vgl_cc_hybrid_multi(g, hubs_m).values
    sync(labels)
    dt = (time.perf_counter() - t0) / 4
    ncomp = int(jnp.unique(labels[0][:g.v]).shape[0])
    emit(f"cc_{name}_mteps", ec.edges_count / dt / 1e6, "MTEPS", runs=4,
         components=ncomp)

    log("MS-BFS compile+warmup ...")
    kb = 64
    rw = [common.select_random_source(ec, seed=s) for s in range(kb)]
    rm = [common.select_random_source(ec, seed=300 + s) for s in range(kb)]
    sync(bfs.vgl_msbfs(g, rw).values)
    t0 = time.perf_counter()
    lv = bfs.vgl_msbfs(g, rm).values
    sync(lv)
    dt = time.perf_counter() - t0
    outdeg = g.outgoing.degrees.astype(jnp.float32)
    etr = float(jnp.sum((lv > 0).astype(jnp.float32) @ outdeg))
    emit(f"bfs_msbfs_{name}_gteps", etr / dt / 1e9, "GTEPS", roots=kb,
         edges_traversed=int(etr))
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
