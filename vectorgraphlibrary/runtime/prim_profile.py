"""Per-primitive performance accrual (the reference's detailed advance split).

The reference accrues wall/bytes/edges inside every abstraction call
(`vgl_runtime/helpers/performance_stats/performance_stats.hpp:259-316,471-479`,
`advance_worker.hpp:347-360`). Here the algorithm loop is one fused XLA program
— per-call host timers inside it would measure trace time, not device time — so
each app instead runs ONE measured profiling pass over the framework primitives
on the *actual benchmark graph*, eagerly, with explicit memory bytes models. That
yields the same table (ms / GB/s / %roofline / MTEPS per primitive) from real
device timings.

Bytes models (all f32/int32 = 4 B/elem; e = edges, v = v_pad; tile padding
is not counted, so the rates are lower bounds):
- vertex reorder (one gather over v): permutation v·4 + values v·4 + output v·4;
- advance (pull): adjacency e·4 + gathered values e·4 + output v·4 (+e·4 when
  weighted);
- advance (push, sparse): frontier expansion cap·4·6 + scatter.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from .perf_stats import performance_stats

G, S = TraversalDirection.GATHER, TraversalDirection.SCATTER


def _timeit(fn, *args, reps: int = 3):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def profile_graph_primitives(graph: VGLGraph, weights=None,
                             stats=performance_stats, reps: int = 3) -> None:
    """Measure the core primitives on `graph` and accrue into `stats` so
    print_timers_stats shows the reference-style per-primitive breakdown."""
    from ..ops.advance import advance_pull_value, advance_push_sparse
    from ..models.common import to_direction

    v_pad, e = graph.v_pad, graph.e
    x = jnp.arange(v_pad, dtype=jnp.float32) / v_pad

    # every jit below takes `graph` as an ARGUMENT — closing over it would
    # embed the full graph as HLO constants

    # --- reorder (VerticesArray ordering change) ---
    vr = jax.jit(lambda g, a: to_direction(g, a, G, S))
    dt = _timeit(vr, graph, x, reps=reps)
    stats.update("reorder (gather)", dt, 3 * v_pad * 4, v_pad)

    # --- advance: pull over incoming, unweighted add (PR/HITS shape) ---
    adv = jax.jit(lambda g, a: advance_pull_value(g, a, "add", direction=G))
    dt = _timeit(adv, graph, x, reps=reps)
    abytes = (2 * e + v_pad) * 4
    stats.update("advance (pull add)", dt, abytes, e)

    # --- advance: pull min (CC/SSSP shape, weighted when available) ---
    if weights is not None:
        advw = jax.jit(lambda g, w, a: advance_pull_value(
            g, a, "min", edge_values=w, weight_op="add", direction=G))
        dt = _timeit(advw, graph, weights.incoming, x, reps=reps)
        stats.update("advance (pull min+w)", dt, abytes + e * 4, e)
    else:
        advm = jax.jit(lambda g, a: advance_pull_value(g, a, "min",
                                                       direction=G))
        dt = _timeit(advm, graph, x, reps=reps)
        stats.update("advance (pull min)", dt, abytes, e)

    # --- advance: sparse push from a small frontier (BFS top-down shape) ---
    cap = 1024
    ecap = min(1 << 17, max(graph.e, 8))
    ids = jnp.arange(cap, dtype=jnp.int32)
    valid = ids < min(cap, graph.v)
    out0 = jnp.full(v_pad, jnp.inf, jnp.float32)
    push = jax.jit(lambda g, xv, i, va, o: advance_push_sparse(
        g, i, va, ecap, {"d": xv},
        lambda s, d, w: s["d"], "min", o, direction=S))
    dt = _timeit(push, graph, x, ids, valid, out0, reps=reps)
    stats.update("advance (push sparse)", dt, 6 * ecap * 4, ecap)

    # --- generate_new_frontier (classify + compact) ---
    from ..graph.frontier import from_mask, compact_ids, Frontier
    mask = (jnp.arange(v_pad) % 7) == 0
    gnf = jax.jit(lambda m: compact_ids(
        Frontier(mask=m, size=jnp.sum(m, dtype=jnp.int32),
                 neighbours_count=jnp.int32(0), direction=S), 1 << 15))
    dt = _timeit(gnf, mask, reps=reps)
    stats.update("generate_new_frontier", dt, 3 * v_pad * 4, v_pad)
