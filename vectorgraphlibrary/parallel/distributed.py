"""Distributed algorithm steps over the 2-D (edge × vertex) mesh via shard_map.

Each step is the multi-chip version of the corresponding single-chip primitive
composition: edge-parallel message generation, scatter into the device's owned vertex
range, psum/pmin merge over the edge axis, all_gather over the vertex axis — the
collective pattern replacing the reference's MPI exchange (SURVEY.md §2.4.5
analog). These power the multi-device dry run and the strong/weak scaling
benchmarks.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .edge_shard import ShardedEdgeGraph
from .mesh import EDGE_AXIS, VERTEX_AXIS
from . import collectives as C

E, V = EDGE_AXIS, VERTEX_AXIS


def _specs(mesh):
    return dict(
        edge=P(E),        # edge arrays: sharded over edge axis, replicated over v
        vert=P(V),        # vertex state: range-partitioned over vertex axis
        rep=P(),          # replicated
    )


def make_pr_step(graph: ShardedEdgeGraph, mesh, damping: float = 0.85):
    """One distributed PageRank power iteration. State: ranks sharded P('v')."""
    v, v_pad = graph.v, graph.v_pad
    n_v = mesh.shape[V]
    v_local = v_pad // n_v
    k = (1.0 - damping) / v

    def step(src, dst, outdeg, ranks_local):
        ranks = C.gather_private(ranks_local)                 # [v_pad] replicated
        rev = jnp.where(outdeg > 0, 1.0 / outdeg.astype(jnp.float32), 0.0)
        dangling = jnp.sum(jnp.where((outdeg == 0) &
                                     (jnp.arange(v_pad) < v), ranks, 0.0)) / v
        msg = jnp.take(ranks * rev, src, mode="fill", fill_value=0.0)
        loop = src == dst
        msg = jnp.where(loop, 0.0, msg)
        acc_local = C.scatter_to_owner(msg, dst, v_local, combine="add")
        acc_local = jax.lax.psum(acc_local, E)                # merge edge shards
        rank_idx = jax.lax.axis_index(V) * v_local + jnp.arange(v_local)
        real = rank_idx < v
        return jnp.where(real, k + damping * (acc_local + dangling), 0.0)

    sm = jax.shard_map(step, mesh=mesh,
                       in_specs=(P(E), P(E), P(), P(V)),
                       out_specs=P(V))
    return jax.jit(sm)


def make_sssp_step(graph: ShardedEdgeGraph, mesh):
    """One distributed Bellman-Ford relaxation. State: dist sharded P('v')."""
    v_pad = graph.v_pad
    n_v = mesh.shape[V]
    v_local = v_pad // n_v

    def step(src, dst, w, dist_local):
        dist = C.gather_private(dist_local)
        msg = jnp.take(dist, src, mode="fill", fill_value=jnp.inf) + w
        init = jnp.full((v_local,), jnp.inf, dist.dtype)
        cand = C.scatter_to_owner(msg, dst, v_local, combine="min", init=init)
        cand = jax.lax.pmin(cand, E)
        return jnp.minimum(dist_local, cand)

    sm = jax.shard_map(step, mesh=mesh,
                       in_specs=(P(E), P(E), P(E), P(V)),
                       out_specs=P(V))
    return jax.jit(sm)


def make_bfs_step(graph: ShardedEdgeGraph, mesh):
    """One distributed BFS expansion. State: levels sharded P('v')."""
    v_pad = graph.v_pad
    n_v = mesh.shape[V]
    v_local = v_pad // n_v
    INF = jnp.iinfo(jnp.int32).max

    def step(src, dst, levels_local, current_level):
        levels = C.gather_private(levels_local)
        on_front = jnp.take(levels, src, mode="fill", fill_value=INF) == current_level
        msg = jnp.where(on_front, current_level + 1, INF)
        init = jnp.full((v_local,), INF, jnp.int32)
        cand = C.scatter_to_owner(msg, dst, v_local, combine="min", init=init)
        cand = jax.lax.pmin(cand, E)
        return jnp.minimum(levels_local, cand)

    sm = jax.shard_map(step, mesh=mesh,
                       in_specs=(P(E), P(E), P(V), P()),
                       out_specs=P(V))
    return jax.jit(sm)
