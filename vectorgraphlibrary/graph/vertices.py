"""VertexArray: |V|-sized device data tagged with a traversal ordering.

Capability match for the reference ``VerticesArray<T>``
(`vgl_datastructures/vertices_array/vertices_array.h:16-77`): values live in one of
three orderings — ORIGINAL, SCATTER (outgoing-degree-sorted), GATHER
(incoming-degree-sorted) — and ``reorder`` permutes between them via the graph's
renumber maps (reference `graphs/vgl_graph/reorder.hpp:3-60`). A reorder is a single dense gather of
V elements.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import jax
import jax.numpy as jnp

from ..config import TraversalDirection
from .device import VGLGraph


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VertexArray:
    values: jax.Array        # [v_pad] or [v_pad, k]
    direction: TraversalDirection = dataclasses.field(
        metadata=dict(static=True), default=TraversalDirection.ORIGINAL)

    @property
    def dtype(self):
        return self.values.dtype


def vertex_array(graph: VGLGraph, fill_value, dtype=None,
                 direction: TraversalDirection = TraversalDirection.ORIGINAL,
                 extra_dims: tuple = ()) -> VertexArray:
    vals = jnp.full((graph.v_pad,) + extra_dims, fill_value, dtype=dtype)
    return VertexArray(values=vals, direction=direction)


def _gather_perm(graph: VGLGraph, src: TraversalDirection,
                 dst: TraversalDirection) -> jax.Array:
    """Permutation p with out[i] = in[p[i]] converting src-ordering to dst-ordering."""
    O, S, G = (TraversalDirection.ORIGINAL, TraversalDirection.SCATTER,
               TraversalDirection.GATHER)
    if src == O and dst == S:
        return graph.outgoing.sorted_to_orig
    if src == S and dst == O:
        # original[i] = scatter[orig_to_sorted[i]]
        return graph.outgoing.orig_to_sorted
    if src == O and dst == G:
        return graph.incoming.sorted_to_orig
    if src == G and dst == O:
        return graph.incoming.orig_to_sorted
    if src == S and dst == G:
        return graph.outgoing.orig_to_sorted[graph.incoming.sorted_to_orig]
    if src == G and dst == S:
        return graph.incoming.orig_to_sorted[graph.outgoing.sorted_to_orig]
    raise ValueError((src, dst))


def reorder(arr: VertexArray, graph: VGLGraph,
            direction: TraversalDirection) -> VertexArray:
    if arr.direction == direction:
        return arr
    perm = _gather_perm(graph, arr.direction, direction)
    # clip sentinel slots (pad rows map to index v, which is < v_pad so in-bounds)
    vals = jnp.take(arr.values, perm, axis=0, mode="clip")
    return VertexArray(values=vals, direction=direction)


def as_original_numpy(arr: VertexArray, graph: VGLGraph):
    """Host copy in ORIGINAL ordering, trimmed to the real vertex count — used by the
    verification path (reference verify_results.h:49-51 reorders before comparing)."""
    import numpy as np
    out = reorder(arr, graph, TraversalDirection.ORIGINAL)
    return np.asarray(out.values)[:graph.v]
