"""HITS (hubs & authorities).

Capability match for the reference HITS (`algorithms/hits/hits.hpp:5-176`):
alternating gather phases — auth[v] = Σ hub[u] over incoming edges, hub[v] = Σ
auth[w] over outgoing edges — each followed by L2 normalization, with a direction
flip between phases (the reference's change_traversal_direction). Here both
phases are tiled pulls (the hub phase pulls over the outgoing container via the
container-swap trick), the whole iteration loop in one jitted `lax.fori_loop` in
ORIGINAL space with per-phase reorders fused as gathers.
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


@functools.partial(jax.jit, static_argnums=(1,))
def _hits_run(graph: VGLGraph, iterations: int):
    """Zero-reorder iteration: the auth phase (pull over incoming) consumes
    hub in SCATTER order and produces auth in GATHER order; the hub phase
    (pull over outgoing) consumes exactly that GATHER-ordered auth and
    produces hub in SCATTER order — each phase's output IS the next phase's
    input ordering, so the loop carries (hub_s, auth_g) and pays no vertex
    routes at all (the round-2 loop paid 4 explicit + 2 in-advance reorders
    per iteration, ~7·v_pad·4 B of route traffic each)."""
    v = graph.v
    real_s = graph.outgoing.sorted_to_orig < v
    real_g = graph.incoming.sorted_to_orig < v
    hub_s0 = jnp.where(real_s, 1.0, 0.0).astype(jnp.float32)
    auth_g0 = jnp.where(real_g, 1.0, 0.0).astype(jnp.float32)

    def normalize(x):
        n = jnp.sqrt(jnp.sum(x * x))
        return jnp.where(n > 0, x / n, x)

    def body(_, state):
        hub_s, _ = state
        auth_new = advance_pull_value(graph, hub_s, "add", direction=G,
                                      src_in_src_order=True)
        auth_g = normalize(jnp.where(real_g, auth_new, 0.0))
        hub_new = advance_pull_value(graph, auth_g, "add", direction=S,
                                     src_in_src_order=True)
        hub_s = normalize(jnp.where(real_s, hub_new, 0.0))
        return hub_s, auth_g

    hub_s, auth_g = jax.lax.fori_loop(0, iterations, body, (hub_s0, auth_g0))
    auth = common.to_direction(graph, auth_g, G, O)
    hub = common.to_direction(graph, hub_s, S, O)
    v_pad = graph.v_pad
    real_o = jnp.arange(v_pad, dtype=jnp.int32) < v
    return jnp.where(real_o, auth, 0.0), jnp.where(real_o, hub, 0.0)


def vgl_hits(graph: VGLGraph, iterations: int = 20
             ) -> tuple[VertexArray, VertexArray]:
    auth, hub = _hits_run(graph, iterations)
    return (VertexArray(values=auth, direction=O),
            VertexArray(values=hub, direction=O))


def seq_hits(ec, iterations: int = 20) -> tuple[np.ndarray, np.ndarray]:
    v = ec.vertices_count
    auth = np.ones(v)
    hub = np.ones(v)
    for _ in range(iterations):
        a = np.zeros(v)
        np.add.at(a, ec.dst_ids, hub[ec.src_ids])
        n = np.linalg.norm(a)
        auth = a / n if n > 0 else a
        h = np.zeros(v)
        np.add.at(h, ec.src_ids, auth[ec.dst_ids])
        n = np.linalg.norm(h)
        hub = h / n if n > 0 else h
    return auth.astype(np.float32), hub.astype(np.float32)
