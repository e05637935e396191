"""Shared algorithm helpers."""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray, reorder


def select_random_source(ec_or_degrees, seed: int = 0) -> int:
    """Random non-zero-outdegree source vertex (reference apps/bfs/bfs.cpp:36-38
    picks `select_non_zero_degree_vertex`)."""
    degs = ec_or_degrees
    if hasattr(degs, "src_ids"):
        degs = np.bincount(degs.src_ids, minlength=degs.vertices_count)
    rng = np.random.default_rng(seed)
    nz = np.flatnonzero(degs)
    if len(nz) == 0:
        return 0
    return int(nz[rng.integers(0, len(nz))])


def to_direction(graph: VGLGraph, values, src_dir: TraversalDirection,
                 dst_dir: TraversalDirection):
    """Reorder a raw [v_pad] array between orderings."""
    return reorder(VertexArray(values=values, direction=src_dir),
                   graph, dst_dir).values


def outdegrees_in(graph: VGLGraph, direction: TraversalDirection) -> jnp.ndarray:
    """Out-degrees expressed in `direction`'s ordering."""
    return to_direction(graph, graph.outgoing.degrees,
                        TraversalDirection.SCATTER, direction)


def indegrees_in(graph: VGLGraph, direction: TraversalDirection) -> jnp.ndarray:
    return to_direction(graph, graph.incoming.degrees,
                        TraversalDirection.GATHER, direction)


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << int(np.ceil(np.log2(x)))


def undirected_value_pull(graph: VGLGraph, vec_orig, combine):
    """Aggregate a PRE-COMPUTED per-source value over the UNDIRECTED
    neighborhood in ORIGINAL ordering, via the restricted advance
    (`ops/advance.advance_pull_value`) — one single-array pull per direction.
    Use whenever the edge message is a function of the source alone
    (mask/shift it elementwise first): coloring's banned-color words and
    priority tests are the motivating case."""
    import jax.numpy as jnp
    from ..ops.advance import advance_pull_value
    from ..ops import monoid as M
    mon = M.get(combine)
    v_g = to_direction(graph, vec_orig, TraversalDirection.ORIGINAL,
                       TraversalDirection.GATHER)
    via_in = advance_pull_value(graph, v_g, combine,
                                direction=TraversalDirection.GATHER)
    via_in_o = to_direction(graph, via_in, TraversalDirection.GATHER,
                            TraversalDirection.ORIGINAL)
    v_s = to_direction(graph, vec_orig, TraversalDirection.ORIGINAL,
                       TraversalDirection.SCATTER)
    via_out = advance_pull_value(graph, v_s, combine,
                                 direction=TraversalDirection.SCATTER)
    via_out_o = to_direction(graph, via_out, TraversalDirection.SCATTER,
                             TraversalDirection.ORIGINAL)
    return mon.combine(via_in_o, via_out_o)
