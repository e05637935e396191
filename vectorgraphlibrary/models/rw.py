"""Random walks.

Capability match for the reference RW (`algorithms/rw/random_walk.hpp:5-118`): a set
of walkers starts on given vertices; each iteration every active walker steps to a
uniformly random out-neighbor (batched RNG, the ASL analog), for a fixed number of
steps; walkers on zero-outdegree vertices stop. Here: walker-parallel — one
jitted `lax.fori_loop`, per-step neighbor choice via row_ptr + random offset gather
(pure gathers, no scatter), `jax.random` counter-based PRNG replacing ASL.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from ..graph.device import VGLGraph

S = TraversalDirection.SCATTER


@functools.partial(jax.jit, static_argnums=(3,))
def _rw_run(graph: VGLGraph, start_sorted, key, walk_length: int):
    """lax.scan over steps: carries walker positions, stacks the visited vertex
    per step (walk-path storage, reference random_walk.h:11-30 walk_results)."""
    dg = graph.outgoing

    def step(state, _):
        pos, k = state
        k, sub = jax.random.split(k)
        deg = jnp.take(dg.degrees, pos, mode="clip")
        start = jnp.take(dg.row_ptr, pos, mode="clip")
        r = jax.random.uniform(sub, pos.shape)
        off = jnp.minimum((r * deg).astype(jnp.int32),
                          jnp.maximum(deg - 1, 0))
        nxt = jnp.take(dg.col_idx, start + off, mode="clip")
        nxt = jnp.where(deg > 0, nxt, pos)
        return (nxt, k), nxt

    (pos, _), path = jax.lax.scan(step, (start_sorted, key), None,
                                  length=walk_length)
    return pos, path        # path: [walk_length, n_walkers] sorted ids


def vgl_random_walk(graph: VGLGraph, start_vertices_original: np.ndarray,
                    walk_length: int = 10, seed: int = 0,
                    store_walk_paths: bool = False):
    """Returns final vertex (ORIGINAL ids) per walker; with store_walk_paths
    (cfg.store_walk_paths), also the full [n_walkers, walk_length+1] path."""
    starts_o = jnp.asarray(start_vertices_original, jnp.int32)
    starts = jnp.take(graph.outgoing.orig_to_sorted, starts_o, mode="clip")
    key = jax.random.PRNGKey(seed)
    pos, path = _rw_run(graph, starts, key, walk_length)
    s2o = graph.outgoing.sorted_to_orig
    final = np.asarray(jnp.take(s2o, pos, mode="clip"))
    if not store_walk_paths:
        return final
    path_o = jnp.take(s2o, path, mode="clip").T      # [walkers, steps]
    full = np.concatenate([np.asarray(starts_o)[:, None], np.asarray(path_o)],
                          axis=1)
    return final, full


def seq_random_walk_reachable(ec, start: int, walk_length: int) -> np.ndarray:
    """Oracle support: set of vertices reachable from start within walk_length hops
    (a random walk endpoint must lie in this set)."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    a = sp.csr_matrix((np.ones(ec.edges_count, np.int8),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    hops = csg.shortest_path(a, method="D", unweighted=True, directed=True,
                             indices=start)
    outdeg = np.bincount(ec.src_ids, minlength=v)
    reach = hops <= walk_length
    # walkers stop early only on zero-outdegree vertices
    ok = reach & ((hops == walk_length) | (outdeg == 0) | (hops < walk_length))
    return ok
