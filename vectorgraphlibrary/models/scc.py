"""Strongly connected components: trim + forward-backward.

Capability match for the reference SCC (`algorithms/scc/scc.h:21-60`,
`scc.hpp:55-130`): iterative in/out-degree trimming (safe-store scatter/gather
peeling) followed by forward-backward pivot decomposition; sequential oracle is
Tarjan (`seq_scc.hpp`) — here SciPy's strong connected_components.

Design: trim rounds and reachability floods are tiled pulls (masked to the
active subgraph) inside jitted steps; the FB pivot loop runs on host exactly as the
reference's recursion does.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray
from ..ops.advance import advance_pull_value
from . import common

S, G, O = (TraversalDirection.SCATTER, TraversalDirection.GATHER,
           TraversalDirection.ORIGINAL)


def _active_degree_step(graph: VGLGraph, active_o: jax.Array):
    """(in-degree, out-degree) restricted to active vertices, ORIGINAL order."""
    act_g = common.to_direction(graph, active_o, O, G)
    indeg = advance_pull_value(graph, act_g.astype(jnp.int32), "add",
                               direction=G)
    indeg_o = common.to_direction(graph, indeg, G, O)
    act_s = common.to_direction(graph, active_o, O, S)
    outdeg = advance_pull_value(graph, act_s.astype(jnp.int32), "add",
                                direction=S)
    outdeg_o = common.to_direction(graph, outdeg, S, O)
    return indeg_o, outdeg_o


@jax.jit
def _trim_step(graph: VGLGraph, labels_o: jax.Array, real: jax.Array):
    """One trim round: active vertices with zero active in- or out-degree become
    their own (singleton) SCC."""
    active = (labels_o == -1) & real
    indeg_o, outdeg_o = _active_degree_step(graph, active)
    trim = active & ((indeg_o == 0) | (outdeg_o == 0))
    ids = jnp.arange(labels_o.shape[0], dtype=jnp.int32)
    new_labels = jnp.where(trim, ids, labels_o)
    return new_labels, jnp.sum(trim, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnums=(3,))
def _reach_step(graph: VGLGraph, reach_o: jax.Array, active_o: jax.Array,
                forward: bool):
    """Expand reachability one hop along outgoing (forward) or incoming edges,
    restricted to the active subgraph; ORIGINAL ordering."""
    if forward:
        # who can I reach: new = any in-neighbor (w.r.t. reversed edges) reached
        r_s = common.to_direction(graph, reach_o, O, S)
        via = advance_pull_value(graph, r_s, "or", direction=S)
        via_o = common.to_direction(graph, via, S, O)
    else:
        r_g = common.to_direction(graph, reach_o, O, G)
        via = advance_pull_value(graph, r_g, "or", direction=G)
        via_o = common.to_direction(graph, via, G, O)
    return reach_o | (via_o & active_o)


@jax.jit
def _trim_fixpoint(graph: VGLGraph, labels_o: jax.Array, real: jax.Array):
    """Trim to fixpoint inside ONE device program (r5: the host-looped trim
    paid a ~28 ms dispatch + sync per round — scc.hpp's loop is tight)."""
    def cond(state):
        labels, ntrim = state
        return ntrim > 0

    def body(state):
        labels, _ = state
        return _trim_step(graph, labels, real)

    labels, _ = jax.lax.while_loop(cond, body, (labels_o, jnp.int32(1)))
    return labels


@jax.jit
def _fb_pivot_round(graph: VGLGraph, labels_o: jax.Array, real: jax.Array):
    """ONE pivot round as ONE device program: pick the first unlabeled
    vertex, flood forward and backward to fixpoint (while_loops), carve the
    SCC, re-trim the remainder — one dispatch per pivot instead of one per
    flood hop and trim round. Returns (labels,
    remaining_active)."""
    v = graph.v
    v_pad = graph.v_pad
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    active = (labels_o == -1) & real
    has = jnp.any(active)
    seed = jnp.argmax(active.astype(jnp.int32)).astype(jnp.int32)

    def flood(forward: bool):
        reach0 = (ids == seed) & has

        def cond(state):
            reach, grew = state
            return grew

        def body(state):
            reach, _ = state
            reach2 = _reach_step(graph, reach, active, forward)
            return reach2, jnp.any(reach2 != reach)

        reach, _ = jax.lax.while_loop(cond, body, (reach0, has))
        return reach

    fwd = flood(True)
    bwd = flood(False)
    scc = (fwd & bwd & active) | ((ids == seed) & has)
    labels = jnp.where(scc, seed, labels_o)
    labels = _trim_fixpoint(graph, labels, real)
    return labels, jnp.sum((labels == -1) & real, dtype=jnp.int32)


def vgl_forward_backward(graph: VGLGraph, max_pivots: int = 1_000_000
                         ) -> VertexArray:
    """Labels in ORIGINAL ordering; label = min original id of the component's
    pivot (relabel-invariant comparison applies, reference equal_components)."""
    v, v_pad = graph.v, graph.v_pad
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    real = ids < v
    labels = jnp.where(real, jnp.int32(-1), jnp.int32(v))

    # trim to fixpoint (reference scc.hpp trim loop) — one dispatch
    labels = _trim_fixpoint(graph, labels, real)

    pivots = 0
    while pivots < max_pivots:
        labels, remaining = _fb_pivot_round(graph, labels, real)
        pivots += 1
        if int(remaining) == 0:
            break
    return VertexArray(values=labels, direction=O)


def seq_scc(ec) -> np.ndarray:
    """Tarjan-equivalent oracle (reference seq_scc.hpp) via SciPy."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    a = sp.csr_matrix((np.ones(ec.edges_count, np.int8),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    _, labels = csg.connected_components(a, directed=True, connection="strong")
    return labels.astype(np.int32)
