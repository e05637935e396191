"""BFS: top-down, bottom-up, and direction-optimizing.

Capability match for the reference BFS (`algorithms/bfs/bfs.hpp:5-86` top-down;
`bfs/hardwired_do_bfs.hpp` direction-optimizing state machine). Level convention
matches the reference: source level = FIRST_LEVEL_VERTEX = 1, unvisited = -1
(`bfs/change_state/change_state.h:21-23`).

Design:
- top-down step = compacted-frontier sparse push (`advance_push_sparse`) with
  min-combine over candidate levels — work-efficient, power-of-two edge capacities
  bound recompilation;
- bottom-up step = dense tiled pull over incoming edges asking "is any in-neighbor
  on the current level?" — the analog of the reference's bottom-up kernels; runs in
  GATHER ordering, with levels reordered on direction switches exactly like
  `change_traversal_direction` (common/graph_abstractions.hpp:80-125);
- the direction-optimizing switch uses Beamer-style thresholds on frontier
  neighbour counts, the analog of the reference's state machine
  (`hardwired_do_bfs.hpp:925-990`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.frontier import Frontier, compact_ids, from_vertex, from_mask
from ..graph.vertices import VertexArray
from ..ops.advance import advance_pull_value, advance_push_sparse
from . import common

S, G = TraversalDirection.SCATTER, TraversalDirection.GATHER
UNVISITED = -1
FIRST_LEVEL = 1
_INF32 = jnp.iinfo(jnp.int32).max


@functools.partial(jax.jit, static_argnums=(4,))
def _td_step(graph: VGLGraph, levels_inf, ids, valid, ecap, current_level):
    """One top-down step in SCATTER ordering. levels_inf uses INF for unvisited so
    min-combine is monotone."""
    out = advance_push_sparse(
        graph, ids, valid, ecap, {"l": levels_inf},
        lambda s, d, w: jnp.zeros_like(s["l"]) + (current_level + 1),
        "min", levels_inf, direction=S)
    new_mask = out < levels_inf
    size = jnp.sum(new_mask, dtype=jnp.int32)
    nbrs = jnp.sum(jnp.where(new_mask, graph.outgoing.degrees, 0), dtype=jnp.int32)
    return out, new_mask, size, nbrs


@jax.jit
def _bu_step(graph: VGLGraph, levels_g, outdeg_g, current_level):
    """One bottom-up step in GATHER ordering: unvisited vertices look for any
    in-neighbor on the current level."""
    on_level = levels_g == current_level
    reached = advance_pull_value(graph, on_level, "or", direction=G)
    newly = (levels_g == _INF32) & reached
    levels_new = jnp.where(newly, current_level + 1, levels_g)
    size = jnp.sum(newly, dtype=jnp.int32)
    nbrs = jnp.sum(jnp.where(newly, outdeg_g, 0), dtype=jnp.int32)
    return levels_new, newly, size, nbrs


def vgl_top_down(graph: VGLGraph, source_vertex: int,
                 max_capacity: int = 1 << 20) -> VertexArray:
    """Pure top-down BFS (reference vgl_top_down)."""
    v_pad = graph.v_pad
    sid = int(np.asarray(graph.outgoing.orig_to_sorted[source_vertex]))
    levels = jnp.full(v_pad, _INF32, jnp.int32).at[sid].set(FIRST_LEVEL)
    mask = jnp.zeros(v_pad, bool).at[sid].set(True)
    size = 1
    nbrs = int(np.asarray(graph.outgoing.degrees[sid]))
    current = FIRST_LEVEL
    while size > 0:
        cap = min(common.next_pow2(max(size, 8)), v_pad)
        ecap = min(common.next_pow2(max(nbrs, 8)), max(graph.e, 8))
        fr = Frontier(mask=mask, size=jnp.int32(size),
                      neighbours_count=jnp.int32(nbrs), direction=S)
        ids, valid = compact_ids(fr, cap)
        levels, mask, dsize, dnbrs = _td_step(
            graph, levels, ids, valid, ecap, jnp.int32(current))
        size, nbrs = int(dsize), int(dnbrs)
        current += 1
    out = jnp.where(levels == _INF32, UNVISITED, levels)
    return VertexArray(values=out, direction=S)


def vgl_bfs(graph: VGLGraph, source_vertex: int, alpha: float = 15.0,
            beta: float = 18.0) -> VertexArray:
    """Direction-optimizing BFS (reference hardwired_do_bfs analog).

    Runs top-down on small frontiers, switches to bottom-up pull when the frontier's
    out-edge count exceeds |E_unexplored|/alpha, and back when the frontier shrinks
    below |V|/beta (Beamer's heuristic; the reference uses the same shape of
    thresholds in its change_state machine).
    """
    v, e, v_pad = graph.v, graph.e, graph.v_pad
    sid = int(np.asarray(graph.outgoing.orig_to_sorted[source_vertex]))
    levels = jnp.full(v_pad, _INF32, jnp.int32).at[sid].set(FIRST_LEVEL)
    mask = jnp.zeros(v_pad, bool).at[sid].set(True)
    size = 1
    nbrs = int(np.asarray(graph.outgoing.degrees[sid]))
    current = FIRST_LEVEL
    state = "td"       # levels/mask ordering: td -> SCATTER, bu -> GATHER
    unexplored_edges = e
    outdeg_g = common.outdegrees_in(graph, G)

    while size > 0:
        if state == "td" and nbrs > unexplored_edges / alpha and size > 16:
            levels = common.to_direction(graph, levels, S, G)
            state = "bu"
        elif state == "bu" and size < v / beta:
            levels = common.to_direction(graph, levels, G, S)
            mask = levels == current   # frontier mask in the new ordering
            state = "td"

        if state == "td":
            cap = min(common.next_pow2(max(size, 8)), v_pad)
            ecap = min(common.next_pow2(max(nbrs, 8)), max(e, 8))
            fr = Frontier(mask=mask, size=jnp.int32(size),
                          neighbours_count=jnp.int32(nbrs), direction=S)
            ids, valid = compact_ids(fr, cap)
            levels, mask, dsize, dnbrs = _td_step(
                graph, levels, ids, valid, ecap, jnp.int32(current))
            size, nbrs = int(dsize), int(dnbrs)
        else:
            levels, mask, dsize, dnbrs = _bu_step(graph, levels, outdeg_g,
                                                  jnp.int32(current))
            size, nbrs = int(dsize), int(dnbrs)
        unexplored_edges = max(unexplored_edges - nbrs, 0)
        current += 1

    if state == "bu":
        levels = common.to_direction(graph, levels, G, S)
    out = jnp.where(levels == _INF32, UNVISITED, levels)
    return VertexArray(values=out, direction=S)


def _do_bfs_levels(graph: VGLGraph, source_sorted_s, id_cap: int,
                   edge_cap: int, alpha: float, beta: float):
    """Fully device-resident direction-optimizing BFS: the whole level loop is
    one lax.while_loop; each level picks top-down sparse push or bottom-up
    dense pull via a traced Beamer test (lax.cond compiles both branches, runs
    one) — zero host round-trips, the analog of the reference's hardwired
    change_state machine (hardwired_do_bfs.hpp:925-990).

    State (levels) lives in SCATTER ordering: top-down pushes then need no
    reorder (frontier, push, and update all happen in S); each bottom-up
    level reorders its frontier to G (src_in_src_order) and its result back
    to S — two V-sized gathers.

    id_cap/edge_cap: static capacities for the sparse branch; levels whose
    frontier exceeds them take the dense branch (always safe)."""
    from ..graph.frontier import Frontier, compact_ids
    v, e, v_pad = graph.v, graph.e, graph.v_pad
    outdeg_s = graph.outgoing.degrees

    levels0 = jnp.full(v_pad, _INF32, jnp.int32).at[source_sorted_s].set(
        FIRST_LEVEL)
    size0 = jnp.int32(1)
    nbrs0 = jnp.take(outdeg_s, source_sorted_s)

    # graduated sparse-push capacities: a STATIC-shaped push does its full
    # capacity of work regardless of the live frontier, so tail levels must
    # use small variants. Tiers stay SMALL on purpose: a frontier too big for
    # them is served by the dense bottom-up pull, whose full-route cost
    # (~n slots at memory bandwidth) already beats big gather/scatter pushes.
    tiers = []
    ic, ec_ = id_cap, edge_cap
    while len(tiers) < 3:
        tiers.append((max(ic, 8), max(ec_, 64)))
        ic //= 8
        ec_ //= 8
    tiers = tiers[::-1]                       # ascending capacities

    def make_td(ic, ecap):
        def td_branch(args):
            levels_s, cur = args
            mask_s = levels_s == cur
            fr = Frontier(mask=mask_s, size=jnp.sum(mask_s, dtype=jnp.int32),
                          neighbours_count=jnp.int32(0),
                          direction=TraversalDirection.SCATTER)
            ids, valid = compact_ids(fr, ic)
            out_s = advance_push_sparse(
                graph, ids, valid, ecap, {"l": levels_s},
                lambda s, d, w: jnp.zeros_like(s["l"]) + (cur + 1),
                "min", levels_s, direction=TraversalDirection.SCATTER)
            newly_s = out_s < levels_s
            new_levels_s = jnp.where(newly_s, cur + 1, levels_s)
            size = jnp.sum(newly_s, dtype=jnp.int32)
            nbrs = jnp.sum(jnp.where(newly_s, outdeg_s, 0), dtype=jnp.int32)
            return new_levels_s, size, nbrs
        return td_branch

    def bu_branch(args):
        levels_s, cur = args
        on_s = levels_s == cur
        reached_g = advance_pull_value(graph, on_s, "or", direction=G,
                                       src_in_src_order=True)
        reached_s = common.to_direction(graph, reached_g, G,
                                        TraversalDirection.SCATTER)
        newly = (levels_s == _INF32) & reached_s
        size = jnp.sum(newly, dtype=jnp.int32)
        nbrs = jnp.sum(jnp.where(newly, outdeg_s, 0), dtype=jnp.int32)
        return jnp.where(newly, cur + 1, levels_s), size, nbrs

    branches = [make_td(ic, ecap) for ic, ecap in tiers] + [bu_branch]

    def cond(state):
        levels, size, nbrs, cur, unexplored = state
        return size > 0

    def body(state):
        levels, size, nbrs, cur, unexplored = state
        # Beamer's two-sided test: top-down while the frontier's out-edges are
        # small vs the unexplored edges, AND back to top-down for the tail
        # once the frontier shrinks below v/beta (without the second clause
        # converged-tail levels with few unexplored edges fail the alpha test
        # and pay full dense pulls for thousand-vertex frontiers)
        td_ok = ((nbrs.astype(jnp.float32)
                  < unexplored.astype(jnp.float32) / alpha)
                 | (size.astype(jnp.float32) * beta < v))
        idx = jnp.int32(len(tiers))            # default: dense bottom-up
        for i in range(len(tiers) - 1, -1, -1):
            ic, ecap = tiers[i]
            fits = td_ok & (size < ic) & (nbrs < ecap)
            idx = jnp.where(fits, jnp.int32(i), idx)
        levels, dsize, dnbrs = jax.lax.switch(idx, branches, (levels, cur))
        return (levels, dsize, dnbrs, cur + 1,
                jnp.maximum(unexplored - dnbrs, 0))

    levels, _, _, _, _ = jax.lax.while_loop(
        cond, body, (levels0, size0, nbrs0, jnp.int32(FIRST_LEVEL),
                     jnp.int32(e)))
    return jnp.where(levels == _INF32, UNVISITED, levels)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _do_bfs_device_run(graph: VGLGraph, source_sorted_s, id_cap: int,
                       edge_cap: int, alpha: float, beta: float):
    return _do_bfs_levels(graph, source_sorted_s, id_cap, edge_cap, alpha, beta)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _do_bfs_device_multi(graph: VGLGraph, sources_sorted_s, id_cap: int,
                         edge_cap: int, alpha: float, beta: float):
    """k full DO-BFS traversals sequentially in ONE device program — the
    graph500 multi-root protocol (64 random roots, one timed batch) — one
    dispatch for the batch instead of one per traversal."""
    return jax.lax.map(
        lambda s: _do_bfs_levels(graph, s, id_cap, edge_cap, alpha, beta),
        sources_sorted_s)


def vgl_bfs_device_multi(graph: VGLGraph, source_vertices, alpha: float = 15.0,
                         beta: float = 18.0, id_cap: int = 1 << 12,
                         edge_cap: int = 1 << 16) -> VertexArray:
    """Batched-root device DO-BFS: levels [k, v_pad] in SCATTER ordering."""
    srcs = jnp.take(graph.outgoing.orig_to_sorted,
                    jnp.asarray(source_vertices, jnp.int32))
    ec2 = min(common.next_pow2(max(graph.e, 8)), edge_cap)
    levels = _do_bfs_device_multi(graph, srcs, min(id_cap, graph.v_pad), ec2,
                                  alpha, beta)
    return VertexArray(values=levels, direction=S)


def vgl_bfs_device(graph: VGLGraph, source_vertex: int, alpha: float = 15.0,
                   beta: float = 18.0, id_cap: int = 1 << 12,
                   edge_cap: int = 1 << 16) -> VertexArray:
    """Direction-optimizing BFS as ONE device program (one dispatch per run)."""
    sid = jnp.take(graph.outgoing.orig_to_sorted, source_vertex)
    ec2 = min(common.next_pow2(max(graph.e, 8)), edge_cap)
    levels = _do_bfs_device_run(graph, sid, min(id_cap, graph.v_pad), ec2,
                                alpha, beta)
    return VertexArray(values=levels, direction=S)


def _msbfs_word(graph: VGLGraph, roots_sorted_s, max_levels: int):
    """Bit-parallel multi-source BFS over ONE int32 word: up to 32 roots'
    frontiers ride one word per vertex through a single bitwise-or pull per
    level (the or-monoid advance, ops/monoid.py OR). For the multi-root
    benchmark protocol one dense pull serves 32 traversals (MS-BFS, Then et
    al. VLDB'15 — same recurrence, here as a word-packed advance; the
    reference runs its roots strictly sequentially, bfs.hpp:5-86).

    roots_sorted_s: int32 [32] SCATTER-ordered root ids (pad slots = v_pad).
    Returns levels int16 [32, v_pad] in SCATTER ordering (UNVISITED = -1,
    root level = 1). State lives in SCATTER ordering like _do_bfs_levels."""
    v_pad = graph.v_pad
    bits = jnp.int32(1) << jnp.arange(32, dtype=jnp.int32)
    # duplicate roots carry distinct bits, so scatter-ADD == scatter-OR here
    seed = jnp.zeros(v_pad, jnp.int32).at[roots_sorted_s].add(
        bits, mode="drop")
    lev0 = jnp.where(
        ((seed[None, :] >> jnp.arange(32, dtype=jnp.int32)[:, None]) & 1) == 1,
        jnp.int16(FIRST_LEVEL), jnp.int16(UNVISITED))

    def cond(state):
        seen, frontier, levels, cur, alive = state
        return alive & (cur < max_levels)

    def body(state):
        seen, frontier, levels, cur, _ = state
        reached_g = advance_pull_value(graph, frontier, "or", direction=G,
                                       src_in_src_order=True)
        reached_s = common.to_direction(graph, reached_g, G, S)
        newly = reached_s & ~seen
        bit = (newly[None, :] >> jnp.arange(32, dtype=jnp.int32)[:, None]) & 1
        levels2 = jnp.where(bit == 1, (cur + 1).astype(jnp.int16), levels)
        return (seen | newly, newly, levels2, cur + 1,
                jnp.any(newly != 0))

    _, _, levels, _, _ = jax.lax.while_loop(
        cond, body, (seed, seed, lev0, jnp.int32(FIRST_LEVEL),
                     jnp.any(seed != 0)))
    return levels


@functools.partial(jax.jit, static_argnums=(2,))
def _msbfs_run(graph: VGLGraph, roots_words, max_levels: int):
    """roots_words int32 [w, 32] -> levels int16 [w, 32, v_pad]."""
    return jax.lax.map(lambda r: _msbfs_word(graph, r, max_levels),
                       roots_words)


def vgl_msbfs(graph: VGLGraph, source_vertices,
              max_levels: int = 32767) -> VertexArray:
    """Multi-source BFS: levels [k, v_pad] (SCATTER ordering) for k roots,
    32 roots per bit-parallel word, word groups run sequentially inside one
    device program. Semantically identical to k vgl_bfs runs."""
    srcs = np.asarray(source_vertices, np.int64)
    k = len(srcs)
    w = (k + 31) // 32
    padded = np.full(w * 32, 0, np.int64)
    padded[:k] = srcs
    sid = jnp.take(graph.outgoing.orig_to_sorted,
                   jnp.asarray(padded, jnp.int32)).reshape(w, 32)
    # pad roots (beyond k) still traverse (harmless duplicates of root 0);
    # their level rows are sliced away below
    levels = _msbfs_run(graph, sid, int(min(max_levels, 32766)))
    out = levels.reshape(w * 32, graph.v_pad)[:k].astype(jnp.int32)
    return VertexArray(values=out, direction=S)


def seq_top_down(ec, source_vertex: int) -> np.ndarray:
    """Sequential oracle: BFS levels, source=1, unvisited=-1 (reference seq_bfs)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    # int32 ones: duplicate edges are summed, and an int8 sum of 256
    # duplicates would wrap to a zero (non-)edge
    a = sp.csr_matrix((np.ones(ec.edges_count, np.int32),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    hops = csg.shortest_path(a, method="D", unweighted=True, directed=True,
                             indices=source_vertex)
    levels = np.full(v, UNVISITED, np.int32)
    reach = ~np.isinf(hops)
    levels[reach] = hops[reach].astype(np.int32) + FIRST_LEVEL
    return levels
