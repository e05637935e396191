"""PageRank.

Capability match for the reference PR (`algorithms/pr/pr.hpp:6-148`): damping d=0.85,
k=(1-d)/|V|, self-loop-excluded degrees, dangling-vertex redistribution, fixed
iteration count. Design differences: the per-iteration edge traversal is a single
tiled pull over incoming edges (messages old_rank[u]/outdeg_wo_loops[u]); the whole
iteration loop runs inside one jitted `lax.fori_loop` (or `lax.while_loop` with an L1
convergence test), so there is zero host round-trip per iteration.

Convention note: the reference propagates rank along *reversed* edges (its scatter
edge_op accumulates from dst into src, pr.hpp:110-117); we use the standard
convention — rank flows src→dst along edge direction — and the bundled oracle
(`seq_page_rank`) matches. Verification uses ranking-difference comparison like the
reference's `verify_ranking_results` (verify_results.h:96-148).
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

G = TraversalDirection.GATHER


@functools.partial(jax.jit, static_argnums=(1, 2))
def _pr_run(graph: VGLGraph, max_iterations: int, use_convergence: bool,
            damping: jnp.float32, tol: jnp.float32):
    v = graph.v
    v_pad = graph.v_pad
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    real = ids < v

    # self-loop counts per vertex: one cell pass over incoming tiles
    from ..ops.advance import advance_cells
    loops = advance_cells(
        graph, lambda src_ids, dst_ids, w: (src_ids == dst_ids).astype(jnp.int32),
        "add", direction=G)
    outdeg = common.outdegrees_in(graph, G)
    outdeg_wo = jnp.where(real, outdeg - loops, 0)
    rev_deg = jnp.where(outdeg_wo > 0, 1.0 / outdeg_wo.astype(jnp.float32), 0.0)
    dangling_mask = real & (outdeg_wo == 0)

    k = (1.0 - damping) / v
    ranks0 = jnp.where(real, 1.0 / v, 0.0).astype(jnp.float32)

    from ..ops.compute import compute
    from ..ops.reduce import reduce as vgl_reduce

    def body(state):
        ranks, it, delta = state
        dangling = vgl_reduce(graph, jnp.where(dangling_mask, ranks, 0.0),
                              "add", direction=G) / v
        acc = advance_pull_value(graph, ranks * rev_deg, "add",
                                 exclude_self_loops=True, direction=G)
        new_ranks = compute(
            graph, {"r": ranks},
            lambda ids, degs, arr: {"r": k + damping * (acc + dangling)},
            direction=G)["r"]
        delta = vgl_reduce(graph, jnp.abs(new_ranks - ranks), "add",
                           direction=G)
        return new_ranks, it + 1, delta

    if use_convergence:
        def cond(state):
            _, it, delta = state
            return (it < max_iterations) & (delta > tol)
        ranks, iters, _ = jax.lax.while_loop(
            cond, body, (ranks0, jnp.int32(0), jnp.float32(jnp.inf)))
    else:
        def fbody(i, state):
            return body(state)
        ranks, iters, _ = jax.lax.fori_loop(
            0, max_iterations, fbody, (ranks0, jnp.int32(0), jnp.float32(0)))
    return ranks, iters


def vgl_page_rank(graph: VGLGraph, damping: float = 0.85,
                  convergence_factor: float = 1.0e-6,
                  max_iterations: int = 100,
                  use_convergence: bool = True) -> tuple[VertexArray, int]:
    ranks, iters = _pr_run(graph, max_iterations, use_convergence,
                           jnp.float32(damping), jnp.float32(convergence_factor))
    return VertexArray(values=ranks, direction=G), int(iters)


def seq_page_rank(ec, damping: float = 0.85, convergence_factor: float = 1.0e-6,
                  max_iterations: int = 100, use_convergence: bool = True
                  ) -> np.ndarray:
    """Sequential oracle (reference seq_page_rank analog) — NumPy, original ids."""
    v = ec.vertices_count
    src, dst = ec.src_ids, ec.dst_ids
    nonloop = src != dst
    s, d = src[nonloop], dst[nonloop]
    outdeg_wo = np.bincount(s, minlength=v).astype(np.float64)
    rev = np.where(outdeg_wo > 0, 1.0 / np.maximum(outdeg_wo, 1), 0.0)
    dangling_mask = outdeg_wo == 0
    k = (1.0 - damping) / v
    ranks = np.full(v, 1.0 / v)
    rev_s = rev[s]
    for _ in range(max_iterations):
        dangling = ranks[dangling_mask].sum() / v
        acc = np.bincount(d, weights=ranks[s] * rev_s, minlength=v)
        new_ranks = k + damping * (acc + dangling)
        delta = np.abs(new_ranks - ranks).sum()
        ranks = new_ranks
        if use_convergence and delta < convergence_factor:
            break
    return ranks.astype(np.float32)
