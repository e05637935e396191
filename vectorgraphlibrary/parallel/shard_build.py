"""Sharded flagship container: destination-range partitioned TILE_CSR.

This is the distributed (and sequential-shard single-card) form of the
flagship format — the answer to the reference's per-rank VectorCSR slicing
(`vect_csr/vect_csr_graph.h:44-48` MPI thresholds used by
`nec/advance_worker.hpp:239-264`) and to ShardedCSRGraph's dst-range shards
(`sharded_csr_graph/sharded_csr_graph.h:16-40`). Each shard owns the
destinations with one residue of the ORIGINAL id mod S and holds its edge set
as a full TILE_CSR subgraph over the whole vertex space, so the SAME advance
kernels run per shard unchanged.

The enabling trick is the unified TileLayout (graph/build.py): every shard is
built against the elementwise-max layout, so all shards share identical static
shapes and stack into ONE pytree (leaves [S, ...]). Execution then chooses:
- shard_map over a device mesh axis (one shard per card, psum/pmin merge) —
  multi-card;
- lax.scan over the leading axis — sequential shards on one card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import VGLConfig, DEFAULT_CONFIG, GraphFormat
from ..graph.build import (HostDirectedCSR, TileLayout, build_directed_csr,
                           layout_of, unify_layouts)
from ..graph.device import VGLGraph, _to_device_directed
from ..io.edges_container import EdgesContainer


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << int(np.ceil(np.log2(x)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedTileGraph:
    """S stacked TILE_CSR shards (leaves [S, ...]) + per-shard edge counts."""

    stacked: VGLGraph                 # every array leaf has leading dim S
    edges_per_shard: jax.Array        # int32 [S]
    n_shards: int = dataclasses.field(metadata=dict(static=True), default=1)
    v: int = dataclasses.field(metadata=dict(static=True), default=0)
    v_pad: int = dataclasses.field(metadata=dict(static=True), default=0)
    e: int = dataclasses.field(metadata=dict(static=True), default=0)

    def shard(self, s: int) -> VGLGraph:
        """Host-side view of one shard (for debugging/tests)."""
        return jax.tree.map(lambda a: a[s], self.stacked)


def take_shard(stacked: VGLGraph) -> VGLGraph:
    """Inside shard_map: strip the per-device leading dim (length 1)."""
    return jax.tree.map(lambda a: a[0], stacked)


def import_sharded(ec: EdgesContainer, n_shards: int,
                   cfg: VGLConfig = DEFAULT_CONFIG,
                   _host_out: Optional[list] = None,
                   keep_edge_slots: Optional[bool] = None) -> ShardedTileGraph:
    """Partition COO by destination range, build every shard against the
    unified layouts, stack. _host_out receives [(h_out, h_in), ...] per shard
    for weight layout.

    keep_edge_slots: ship per-slot CSR edge indices (needed only to lay out
    EdgeArray weights); defaults to ec.weights is not None, like import_graph."""
    v, e = ec.vertices_count, ec.edges_count
    # hash (mod) destination partitioning: contiguous ranges concentrate
    # power-law RMAT hubs (low original ids) in shard 0, and the unified
    # layout would then size EVERY shard like shard 0 — mod-S spreads the
    # skew so per-shard work actually drops n-fold
    shard_id = ec.dst_ids % n_shards

    parts = []
    for s in range(n_shards):
        m = shard_id == s
        parts.append((ec.src_ids[m], ec.dst_ids[m]))

    # pass 1: natural layouts per shard per direction → unified layouts
    louts, lins = [], []
    for src_s, dst_s in parts:
        louts.append(layout_of(np.bincount(src_s, minlength=v), cfg))
        lins.append(layout_of(np.bincount(dst_s, minlength=v), cfg))
    L_out, L_in = unify_layouts(louts), unify_layouts(lins)
    v_pad = max(_next_pow2(max(L_out.total_rows, L_in.total_rows, v)), 1024)
    e_pad = max(8 * ((max(len(p[0]) for p in parts) + 7) // 8), 8)

    # pass 2: per-shard builds under the unified static shapes
    graphs: List[VGLGraph] = []
    with_eidx = (ec.weights is not None if keep_edge_slots is None
                 else keep_edge_slots)
    for src_s, dst_s in parts:
        h_out = build_directed_csr(src_s, dst_s, v, cfg, layout=L_out,
                                   v_pad=v_pad)
        h_in = build_directed_csr(dst_s, src_s, v, cfg, layout=L_in,
                                  v_pad=v_pad)
        _pad_edges(h_out, e_pad)
        _pad_edges(h_in, e_pad)
        if _host_out is not None:
            _host_out.append((h_out, h_in))
        graphs.append(VGLGraph(
            outgoing=_to_device_directed(h_out, e_static=e_pad,
                                         with_eidx=with_eidx),
            incoming=_to_device_directed(h_in, e_static=e_pad,
                                         with_eidx=with_eidx),
            v=v, v_pad=v_pad, e=e_pad, graph_format=GraphFormat.SHARDED_CSR))

    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *graphs)
    return ShardedTileGraph(
        stacked=stacked,
        edges_per_shard=jnp.asarray([len(p[0]) for p in parts], jnp.int32),
        n_shards=n_shards, v=v, v_pad=v_pad, e=e)


def _pad_edges(h: HostDirectedCSR, e_pad: int) -> None:
    """Grow a shard's edge arrays to the unified e_pad (static uniformity)."""
    if h.edges_pad == e_pad:
        return
    assert e_pad > h.edges_pad
    grow = e_pad - h.edges_pad
    h.col_idx = np.concatenate(
        [h.col_idx, np.full(grow, h.vertices_pad, np.int32)])
    h.edge_perm = np.concatenate(
        [h.edge_perm, np.full(grow, e_pad, np.int64)])
    h.edges_pad = e_pad


def shard_edge_values(coo_values: np.ndarray, sg: ShardedTileGraph,
                      ec: EdgesContainer, hosts: List[Tuple],
                      pad_value=0):
    """Per-shard EdgeArrays (stacked) for COO-ordered edge values."""
    from ..graph.edges import build_edge_array_from_host
    shard_id = ec.dst_ids % sg.n_shards
    arrays = []
    for s in range(sg.n_shards):
        m = shard_id == s
        g = sg.shard(s)
        h_out, h_in = hosts[s]
        arrays.append(build_edge_array_from_host(coo_values[m], g, h_out, h_in,
                                                 pad_value=pad_value))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *arrays)
