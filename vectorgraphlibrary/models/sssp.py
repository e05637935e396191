"""SSSP — Bellman-Ford family (the reference names it "dijkstra").

Capability match for the reference SSSP (`algorithms/sssp/shortest_paths.hpp:5-317`):
all-active push (:85-162), all-active pull (:170-280), and partial-active
work-frontier variants. Design:
- all-active relaxations are a single tiled pull over incoming edges with
  min-combine, iterated inside a jitted `lax.while_loop` whose condition is the
  reduce-changes test the reference performs (:143-152) — no host sync per iteration;
- the partial-active variant keeps a changed-vertex frontier and uses compacted
  sparse push when the frontier is small, dense pull otherwise (the reference's
  DENSE/SPARSE threshold switch, settings.h:111-125).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.edges import EdgeArray
from ..graph.frontier import Frontier, compact_ids
from ..graph.vertices import VertexArray
from ..ops.advance import advance_pull_value, advance_push_sparse
from . import common

S, G = TraversalDirection.SCATTER, TraversalDirection.GATHER


@functools.partial(jax.jit, static_argnums=(4,))
def _all_active_run(graph: VGLGraph, weights_in, source_sorted_gather,
                    dist0, max_iterations: int):
    """Bellman-Ford to fixpoint, fully on device (GATHER ordering)."""

    def relax(dist):
        cand = advance_pull_value(graph, dist, "min", edge_values=weights_in,
                                  weight_op="add", direction=G)
        return jnp.minimum(dist, cand)

    def cond(state):
        dist, prev, it = state
        return (it < max_iterations) & jnp.any(dist != prev)

    def body(state):
        dist, _, it = state
        return relax(dist), dist, it + 1

    dist0 = dist0.at[source_sorted_gather].set(0.0)
    dist, _, iters = jax.lax.while_loop(
        cond, body, (relax(dist0), dist0, jnp.int32(1)))
    return dist, iters


def vgl_dijkstra_all_active(graph: VGLGraph, weights: EdgeArray,
                            source_vertex: int,
                            max_iterations: int = 10_000
                            ) -> tuple[VertexArray, int]:
    """All-active Bellman-Ford (push and pull are the same tiled pull here —
    the reference's push (:85) and pull (:170) variants differ only in which
    container they traverse; we traverse incoming)."""
    sid = graph.incoming.orig_to_sorted[source_vertex]
    dist0 = jnp.full(graph.v_pad, jnp.inf, jnp.float32)
    dist, iters = _all_active_run(graph, weights.incoming, sid, dist0,
                                  max_iterations)
    return VertexArray(values=dist, direction=G), int(iters)


def _sssp_partial_device(graph: VGLGraph, w_in, w_out, source_sorted_g,
                         id_cap: int, edge_cap: int,
                         max_iterations: int = 10_000):
    """Device-resident partial-active Bellman-Ford: the whole relaxation loop
    is ONE lax.while_loop; each iteration a traced test picks compacted sparse
    push (small changed set, tiered static capacities) or dense pull
    restricted to changed sources (src_active masks values BEFORE routing, so
    the dense branch costs the same as one all-active sweep), mirroring the
    device DO-BFS state machine (models/bfs.py _do_bfs_levels). State (dist,
    changed) lives in GATHER ordering; push steps route to/from SCATTER."""
    v, v_pad = graph.v, graph.v_pad
    outdeg_s = graph.outgoing.degrees
    outdeg_g = common.to_direction(graph, outdeg_s, S, G)

    dist0 = jnp.full(v_pad, jnp.inf, jnp.float32).at[source_sorted_g].set(0.0)
    changed0 = jnp.zeros(v_pad, bool).at[source_sorted_g].set(True)

    tiers = []
    ic, ec_ = id_cap, edge_cap
    while len(tiers) < 3:
        tiers.append((max(ic, 8), max(ec_, 64)))
        ic //= 8
        ec_ //= 8
    tiers = tiers[::-1]

    def make_push(ic, ecap):
        def push_branch(args):
            dist_g, changed_g = args
            dist_s = common.to_direction(graph, dist_g, G, S)
            changed_s = common.to_direction(graph, changed_g, G, S)
            fr = Frontier(mask=changed_s,
                          size=jnp.sum(changed_s, dtype=jnp.int32),
                          neighbours_count=jnp.int32(0), direction=S)
            ids, valid = compact_ids(fr, ic)
            out_s = advance_push_sparse(
                graph, ids, valid, ecap, {"d": dist_s},
                lambda s, d, w: s["d"] + w, "min", dist_s,
                edge_values=w_out, direction=S)
            out_g = common.to_direction(graph, out_s, S, G)
            return out_g, out_g < dist_g
        return push_branch

    def dense_branch(args):
        dist_g, changed_g = args
        cand = advance_pull_value(graph, dist_g, "min", edge_values=w_in,
                                  weight_op="add", src_active=changed_g,
                                  direction=G)
        out = jnp.minimum(dist_g, cand)
        return out, out < dist_g

    branches = [make_push(ic, ecap) for ic, ecap in tiers] + [dense_branch]

    def cond(state):
        dist, changed, size, nbrs, it = state
        # iteration cap mirrors the sharded variant: a non-terminating input (negative-weight cycle) must not
        # hang inside one un-interruptible device dispatch
        return (it < max_iterations) & (size > 0)

    def body(state):
        dist, changed, size, nbrs, it = state
        idx = jnp.int32(len(tiers))
        for i in range(len(tiers) - 1, -1, -1):
            ic, ecap = tiers[i]
            fits = (size < ic) & (nbrs < ecap)
            idx = jnp.where(fits, jnp.int32(i), idx)
        dist2, changed2 = jax.lax.switch(idx, branches, (dist, changed))
        size2 = jnp.sum(changed2, dtype=jnp.int32)
        nbrs2 = jnp.sum(jnp.where(changed2, outdeg_g, 0), dtype=jnp.int32)
        return dist2, changed2, size2, nbrs2, it + 1

    nbrs0 = jnp.take(outdeg_g, source_sorted_g)
    dist, _, _, _, iters = jax.lax.while_loop(
        cond, body, (dist0, changed0, jnp.int32(1), nbrs0, jnp.int32(0)))
    return dist, iters


@functools.partial(jax.jit, static_argnums=(4, 5))
def _sssp_partial_device_run(graph, w_in, w_out, sid, id_cap, edge_cap):
    return _sssp_partial_device(graph, w_in, w_out, sid, id_cap, edge_cap)


def vgl_dijkstra_partial_device(graph: VGLGraph, weights: EdgeArray,
                                source_vertex: int, id_cap: int = 1 << 12,
                                edge_cap: int = 1 << 16
                                ) -> tuple[VertexArray, int]:
    """Work-efficient SSSP as ONE device program (one dispatch per run)."""
    sid = jnp.take(graph.incoming.orig_to_sorted, source_vertex)
    ec2 = min(common.next_pow2(max(graph.e, 8)), edge_cap)
    dist, iters = _sssp_partial_device_run(
        graph, weights.incoming, weights.outgoing, sid,
        min(id_cap, graph.v_pad), ec2)
    return VertexArray(values=dist, direction=G), int(iters)


@functools.partial(jax.jit, static_argnums=(4, 5))
def _sssp_partial_multi(graph, w_in, w_out, sids, id_cap: int, edge_cap: int):
    return jax.lax.map(
        lambda s: _sssp_partial_device(graph, w_in, w_out, s, id_cap,
                                       edge_cap)[0], sids)


@jax.jit
def _sssp_aa_multi(graph, w_in, sids):
    dist0 = jnp.full(graph.v_pad, jnp.inf, jnp.float32)
    return jax.lax.map(
        lambda s: _all_active_run(graph, w_in, s, dist0, 10_000)[0], sids)


# all-active beats partial-active below this edge count: one pull per
# iteration with zero compaction/switch machinery — work-efficiency only
# pays once the full-graph sweep costs more than the frontier bookkeeping.
# The crossover has not been measured on an H100 yet (PERF.md, open questions)
_AA_EDGE_THRESHOLD = 1 << 22


def vgl_dijkstra_multi(graph: VGLGraph, weights: EdgeArray, source_vertices,
                       id_cap: int = 1 << 12, edge_cap: int = 1 << 16,
                       all_active: Optional[bool] = None) -> VertexArray:
    """k independent SSSP runs in ONE device program — the multi-root batch
    protocol (mirrors bfs.vgl_bfs_device_multi): one dispatch for the batch,
    so small-graph benchmarks measure kernels, not dispatch. Picks all-active
    iterations for small graphs (see _AA_EDGE_THRESHOLD) and the tiered
    partial-active work frontier for large ones; `all_active` overrides.
    Returns dist [k, v_pad] in GATHER ordering."""
    sids = jnp.take(graph.incoming.orig_to_sorted,
                    jnp.asarray(source_vertices, jnp.int32))
    if all_active is None:
        all_active = graph.e < _AA_EDGE_THRESHOLD
    if all_active:
        dist = _sssp_aa_multi(graph, weights.incoming, sids)
    else:
        ec2 = min(common.next_pow2(max(graph.e, 8)), edge_cap)
        dist = _sssp_partial_multi(graph, weights.incoming, weights.outgoing,
                                   sids, min(id_cap, graph.v_pad), ec2)
    return VertexArray(values=dist, direction=G)


def seq_dijkstra(ec, source_vertex: int) -> np.ndarray:
    """Sequential oracle via SciPy Dijkstra; unreachable = +inf."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    # parallel edges: keep the minimum weight (matches relaxation semantics);
    # csr_matrix would SUM duplicates, so dedupe first
    order = np.lexsort((ec.weights, ec.dst_ids, ec.src_ids))
    s, d, w = ec.src_ids[order], ec.dst_ids[order], ec.weights[order]
    first = np.ones(len(s), bool)
    first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    m = sp.csr_matrix((w[first], (s[first], d[first])), shape=(v, v))
    dist = csg.dijkstra(m, directed=True, indices=source_vertex)
    return dist.astype(np.float32)
