"""SSWP — single-source widest paths.

Capability match for the reference SSWP (`algorithms/sswp/widest_paths.h:20-30`,
`.hpp`): Bellman-Ford where the relaxation is `cap[v] = max(cap[v], min(cap[u], w))`
(bottleneck/maximum-capacity path). Same design as SSSP: tiled pull over incoming
edges with max-combine inside a jitted fixpoint `lax.while_loop`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.edges import EdgeArray
from ..graph.vertices import VertexArray
from ..ops.advance import advance_pull_value

G = TraversalDirection.GATHER


@functools.partial(jax.jit, static_argnums=(3,))
def _sswp_run(graph: VGLGraph, weights_in, source_sorted, max_iterations: int):
    def relax(cap):
        cand = advance_pull_value(graph, cap, "max", edge_values=weights_in,
                                  weight_op="min", direction=G)
        return jnp.maximum(cap, cand)

    cap0 = jnp.zeros(graph.v_pad, jnp.float32).at[source_sorted].set(jnp.inf)

    def cond(state):
        cap, prev, it = state
        return (it < max_iterations) & jnp.any(cap != prev)

    def body(state):
        cap, _, it = state
        return relax(cap), cap, it + 1

    cap, _, iters = jax.lax.while_loop(
        cond, body, (relax(cap0), cap0, jnp.int32(1)))
    return cap, iters


def vgl_widest_paths(graph: VGLGraph, weights: EdgeArray, source_vertex: int,
                     max_iterations: int = 10_000) -> tuple[VertexArray, int]:
    sid = graph.incoming.orig_to_sorted[source_vertex]
    cap, iters = _sswp_run(graph, weights.incoming, sid, max_iterations)
    return VertexArray(values=cap, direction=G), int(iters)


def seq_widest_paths(ec, source_vertex: int) -> np.ndarray:
    """Oracle: Dijkstra-like widest path via SciPy on negated-bottleneck trick is
    unsound; use a simple label-correcting fixpoint (weights are small graphs)."""
    v = ec.vertices_count
    cap = np.zeros(v, np.float64)
    cap[source_vertex] = np.inf
    s, d, w = ec.src_ids, ec.dst_ids, ec.weights.astype(np.float64)
    for _ in range(v):
        cand = np.zeros(v, np.float64)
        np.maximum.at(cand, d, np.minimum(cap[s], w))
        new = np.maximum(cap, cand)
        if np.array_equal(new, cap):
            break
        cap = new
    return cap.astype(np.float32)
