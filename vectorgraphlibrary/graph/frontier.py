"""Frontier: the set of active vertices, sparsity-adaptive.

Capability match for the reference ``VGL_Frontier``
(`vgl_datastructures/frontier/frontier.h:13-54`) with sparsity states
ALL_ACTIVE / DENSE / SPARSE (`framework_types.h:156-160`). Re-design:

- the canonical representation is a DENSE bool mask over the padded vertex space in
  the current traversal ordering (dense masked math — SURVEY.md §7.1);
- cached scalars (active count, active-neighbour count) are computed on device and
  synced to host only when an algorithm's direction-optimizing heuristic needs them,
  mirroring how the reference computes per-part sizes each GNF
  (`nec/generate_new_frontier.hpp:4-31`);
- a compacted-ids form with power-of-two padded capacity is materialized on demand
  for sparse push traversal (the analog of copy_if compaction,
  `helpers/parallel_primitives/copy_if/copy_if.hpp:12-90`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import Sparsity, TraversalDirection
from .device import VGLGraph


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Frontier:
    mask: jax.Array                 # bool [v_pad], current-ordering
    size: jax.Array                 # int32 scalar: active vertices
    neighbours_count: jax.Array     # int32/int64 scalar: sum of degrees of active
    direction: TraversalDirection = dataclasses.field(
        metadata=dict(static=True), default=TraversalDirection.SCATTER)
    sparsity: Sparsity = dataclasses.field(
        metadata=dict(static=True), default=Sparsity.ALL_ACTIVE)


def all_active(graph: VGLGraph,
               direction: TraversalDirection = TraversalDirection.SCATTER
               ) -> Frontier:
    """reference frontier.h set_all_active()."""
    dg = graph.direction(direction)
    mask = (jnp.arange(graph.v_pad, dtype=jnp.int32) < graph.v)
    return Frontier(mask=mask, size=jnp.int32(graph.v),
                    neighbours_count=jnp.int64(graph.e)
                    if jax.config.jax_enable_x64 else jnp.int32(
                        min(graph.e, 2**31 - 1)),
                    direction=direction, sparsity=Sparsity.ALL_ACTIVE)


def from_mask(graph: VGLGraph, mask: jax.Array,
              direction: TraversalDirection,
              sparsity: Sparsity = Sparsity.DENSE) -> Frontier:
    dg = graph.direction(direction)
    m = mask & (jnp.arange(graph.v_pad, dtype=jnp.int32) < graph.v)
    size = jnp.sum(m, dtype=jnp.int32)
    nbr = jnp.sum(jnp.where(m, dg.degrees, 0), dtype=jnp.int32)
    return Frontier(mask=m, size=size, neighbours_count=nbr,
                    direction=direction, sparsity=sparsity)


def from_vertex(graph: VGLGraph, vertex_original_id,
                direction: TraversalDirection = TraversalDirection.SCATTER
                ) -> Frontier:
    """Single-source frontier (reference frontier.h add_vertex); takes the ORIGINAL
    vertex id and places it in the direction's sorted ordering."""
    dg = graph.direction(direction)
    sid = dg.orig_to_sorted[vertex_original_id]
    mask = jnp.zeros((graph.v_pad,), dtype=bool).at[sid].set(True)
    return from_mask(graph, mask, direction, Sparsity.SPARSE)


def compact_ids(frontier: Frontier, capacity: int) -> tuple[jax.Array, jax.Array]:
    """Compacted active ids padded to `capacity` (static). Returns (ids, valid).
    Analog of vector_copy_if_indexes (copy_if.hpp:12-90).

    Implementation: one `lax.sort` of keyed ids (active first, ascending);
    the output is the same ascending-id list a masked cumsum+scatter
    compaction gives, deterministic."""
    v_pad = frontier.mask.shape[0]
    idx = jnp.arange(v_pad, dtype=jnp.int32)
    keys = jnp.where(frontier.mask, idx, jnp.int32(v_pad))
    ids = jax.lax.sort(keys)[:capacity]
    if capacity > v_pad:      # keep ids capacity-long like the scatter form
        ids = jnp.pad(ids, (0, capacity - v_pad), constant_values=v_pad)
    # overflow contract matches the scatter form: ids beyond `capacity` drop
    ids = jnp.where(ids < v_pad, ids, jnp.int32(v_pad))
    valid = jnp.arange(capacity, dtype=jnp.int32) < frontier.size
    return ids, valid


def classify_sparsity(active_ratio: float, cfg_dense_threshold: float) -> Sparsity:
    """Host-side sparsity classification (reference GNF threshold switch,
    nec/generate_new_frontier.hpp:246-306)."""
    if active_ratio >= 1.0:
        return Sparsity.ALL_ACTIVE
    if active_ratio >= cfg_dense_threshold:
        return Sparsity.DENSE
    return Sparsity.SPARSE
