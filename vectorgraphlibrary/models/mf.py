"""Maximum flow — Edmonds-Karp (BFS-augmenting Ford-Fulkerson), fully on device.

Capability match for the reference MF (`algorithms/mf/mf.h:10-38`, `mf.hpp`):
the reference drives augmentation with its BFS abstraction (`mf_bfs`,
mf.hpp:5-50) and updates path flow host-side per edge. Here the WHOLE algorithm
is one jitted program over a static residual-arc graph:

- residual structure: 2e arcs (forward copy + backward copy of every edge),
  imported once as a CSR graph — the structure never changes, only the
  per-arc residual capacities do;
- outer lax.while_loop = augmentations; inner loop 1 = level-synchronous BFS
  over arcs with positive residual, tracking a PARENT ARC per vertex via a
  min-combine advance whose per-edge value is the arc id (masked to BIG where
  residual is exhausted);
- inner loop 2 = the path walk: O(path) scalar steps following parent arcs
  from sink to source, accumulating the bottleneck and an arc mask;
- the residual update is two fused vector ops (subtract along the path, add
  on the reverse arcs) — no CSR rebuild, no host round-trips at all.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GraphFormat, TraversalDirection
from ..graph.device import VGLGraph, import_graph
from ..graph.edges import DirectedEdgeValues, _tile_values
from ..io.edges_container import EdgesContainer
from ..ops.advance import advance_pull
from . import common

S, G, O = (TraversalDirection.SCATTER, TraversalDirection.GATHER,
           TraversalDirection.ORIGINAL)
_BIG = jnp.int32(2**30)
_EPS = 1e-6


def build_residual(ec: EdgesContainer):
    """Residual structure for the device Edmonds-Karp: import the 2e-arc
    graph once as a CSR container and precompute static per-slot maps over
    its INCOMING CSR slots (arc source in GATHER ordering, reverse-arc slot,
    initial residual). Cached on the container instance — the structure is
    independent of source/sink, and benchmark apps run many rounds over one
    container."""
    cached = getattr(ec, "_mf_residual", None)
    if cached is not None:
        return cached
    v, e = ec.vertices_count, ec.edges_count
    src2 = np.concatenate([ec.src_ids, ec.dst_ids]).astype(np.int32)
    dst2 = np.concatenate([ec.dst_ids, ec.src_ids]).astype(np.int32)
    host = []
    g2 = import_graph(EdgesContainer(src2, dst2, v), _host_out=host,
                      graph_format=GraphFormat.CSR, keep_edge_slots=False)
    _, h_in = host
    e2 = 2 * e
    slot = np.empty(e2, np.int64)             # coo arc -> incoming CSR slot
    slot[h_in.edge_perm[:e2]] = np.arange(e2)
    rev = np.concatenate([np.arange(e, e2), np.arange(0, e)])
    rev_slot = np.zeros(h_in.edges_pad, np.int32)
    rev_slot[slot] = slot[rev]
    res0_slot = np.zeros(h_in.edges_pad, np.float32)
    res0_slot[slot[:e]] = ec.weights.astype(np.float32)
    built = (g2, jnp.asarray(res0_slot), jnp.asarray(rev_slot))
    ec._mf_residual = built
    return built


@functools.partial(jax.jit, static_argnums=(4, 5))
def _ek_run(g2: VGLGraph, res_slot0, rev_slot, src_sink,
            max_augmentations: int, max_path: int):
    """Device Edmonds-Karp: residual capacities live in incoming CSR slot
    order, so the per-augmentation BFS is a min-pull whose per-arc message
    is the arc's SLOT id (weight_op="max" with a zero source value) and the
    path update is two sparse scatters over <= max_path slots. The arc
    source of a slot is the incoming container's col_idx (GATHER ids)."""
    from ..ops.advance import advance_pull_value
    v_pad = g2.v_pad
    n = res_slot0.shape[0]
    INF = jnp.iinfo(jnp.int32).max
    sid = jnp.take(g2.incoming.orig_to_sorted, src_sink[0])
    tid = jnp.take(g2.incoming.orig_to_sorted, src_sink[1])
    iota = jnp.arange(n, dtype=jnp.int32)
    src_g_slot = g2.incoming.col_idx

    def augment(state):
        res, total, aug, go = state
        w = jnp.where(res > _EPS, iota, _BIG)
        ev = DirectedEdgeValues(flat=w, bucket_tiles=(), huge_tile=None)
        levels0 = jnp.full(v_pad, INF, jnp.int32).at[sid].set(1)
        parent0 = jnp.full(v_pad, _BIG, jnp.int32)

        def bfs_cond(s):
            levels, parent, cur, grew = s
            return grew & (levels[tid] == INF)

        def bfs_body(s):
            levels, parent, cur, _ = s
            on = levels == cur
            cand = advance_pull_value(g2, jnp.zeros(v_pad, jnp.int32), "min",
                                      edge_values=ev, weight_op="max",
                                      src_active=on, direction=G)
            newly = (levels == INF) & (cand < _BIG)
            return (jnp.where(newly, cur + 1, levels),
                    jnp.where(newly, cand, parent),
                    cur + 1, jnp.any(newly))

        levels, parent_g, _, _ = jax.lax.while_loop(
            bfs_cond, bfs_body, (levels0, parent0, jnp.int32(1), True))
        found = levels[tid] < INF

        def walk_cond(s):
            i, u, b, slots = s
            return (u != sid) & (i < max_path)

        def walk_body(s):
            i, u, b, slots = s
            arc = jnp.take(parent_g, u)
            b = jnp.minimum(b, jnp.take(res, arc))
            slots = slots.at[i].set(arc)
            return i + 1, jnp.take(src_g_slot, arc), b, slots

        u0 = jnp.where(found, tid, sid)
        _, u_end, bottleneck, slots = jax.lax.while_loop(
            walk_cond, walk_body,
            (jnp.int32(0), u0, jnp.float32(jnp.inf),
             jnp.full(max_path, n, jnp.int32)))      # sentinel n -> dropped
        found = found & (u_end == sid)
        bottleneck = jnp.where(found, bottleneck, 0.0)
        res = res.at[slots].add(-bottleneck, mode="drop")
        rev_of = jnp.where(slots < n, jnp.take(rev_slot, slots,
                                               mode="clip"), n)
        res = res.at[rev_of].add(bottleneck, mode="drop")
        return res, total + bottleneck, aug + 1, found

    def cond(state):
        res, total, aug, go = state
        return go & (aug < max_augmentations)

    _, total, aug, _ = jax.lax.while_loop(
        cond, augment, (res_slot0, jnp.float32(0.0), jnp.int32(0), True))
    return total, aug


def vgl_ford_fulkerson(ec: EdgesContainer, graph: VGLGraph, source: int,
                       sink: int, max_augmentations: int = 10_000,
                       max_path: Optional[int] = None) -> float:
    """Edmonds-Karp max flow source→sink; returns the flow value.
    `graph` is unused (kept for the reference-shaped API); the residual-arc
    structure is built once per container (cites mf.hpp:5-50 for the BFS
    split) and the whole algorithm runs as ONE device program.

    max_path bounds the static augmenting-path walk buffer. It defaults to
    the VERTEX COUNT: EK augmenting paths are BFS-shortest, so ≤ v-1 arcs —
    the bound genuinely cannot be exceeded and the result is never silently
    truncated (a caller-supplied smaller cap re-enables the early-stop
    contract, same as hitting max_augmentations)."""
    if max_path is None:
        max_path = max(int(ec.vertices_count), 16)
    g2, res0, rev_slot = build_residual(ec)
    total, aug = _ek_run(
        g2, res0, rev_slot,
        jnp.asarray([source, sink], jnp.int32),
        max_augmentations, max_path)
    return float(total)


def vgl_mf_bfs_levels(ec: EdgesContainer, graph: VGLGraph, flow: np.ndarray,
                      source: int):
    """Device residual-BFS levels for a given flow assignment (the reference's
    standalone mf_bfs surface)."""
    v = ec.vertices_count
    src2 = np.concatenate([ec.src_ids, ec.dst_ids]).astype(np.int32)
    dst2 = np.concatenate([ec.dst_ids, ec.src_ids]).astype(np.int32)
    host = []
    g2 = import_graph(EdgesContainer(src2, dst2, v), _host_out=host,
                      keep_edge_slots=True)
    h_out, h_in = host
    e2 = 2 * ec.edges_count
    arc_slot_in = np.full(h_in.edges_pad, int(_BIG), np.int64)
    arc_slot_in[:e2] = h_in.edge_perm[:e2]
    res = np.concatenate([(ec.weights - flow).astype(np.float32),
                          flow.astype(np.float32)])

    INF = jnp.iinfo(jnp.int32).max
    res_slot = jnp.take(jnp.asarray(res),
                        jnp.minimum(jnp.asarray(arc_slot_in), e2 - 1),
                        mode="clip")
    w_flat = jnp.where((jnp.asarray(arc_slot_in) < e2) & (res_slot > _EPS),
                       jnp.asarray(arc_slot_in, jnp.int32), _BIG)
    ev = _tile_values(jnp.concatenate([w_flat, jnp.array([_BIG])]),
                      g2.incoming)
    sid_g = int(np.asarray(g2.incoming.orig_to_sorted[source]))
    levels = jnp.full(g2.v_pad, INF, jnp.int32).at[sid_g].set(1)
    cur = 1
    while True:
        on = levels == cur
        cand = advance_pull(g2, {}, lambda sv, dv, w: w, "min",
                            edge_values=ev, src_active=on, direction=G)
        newly = (levels == INF) & (cand < _BIG)
        if int(jnp.sum(newly)) == 0:
            break
        levels = jnp.where(newly, cur + 1, levels)
        cur += 1
    out = jnp.take(levels, g2.incoming.orig_to_sorted, mode="clip")
    return np.asarray(out)[:v]


def seq_ford_fulkerson(ec: EdgesContainer, source: int, sink: int) -> float:
    """Oracle via SciPy maximum_flow (integer capacities)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_flow
    v = ec.vertices_count
    capi = np.maximum(ec.weights.astype(np.int64), 1)
    # dedupe parallel edges by summing capacities
    a = sp.csr_matrix((capi, (ec.src_ids, ec.dst_ids)), shape=(v, v))
    a = sp.csr_matrix(a)                      # sums duplicates
    return float(maximum_flow(a, source, sink).flow_value)
