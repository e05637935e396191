"""EdgeArray: |E|-indexed per-edge data (weights, flow, ...) per traversal direction.

Capability match for the reference ``EdgesArray<T>``
(`vgl_datastructures/edges_array/edges_array.h:9-63`) and its VectorCSR container that
keeps a CSR copy *plus* a vector-extension copy of the weights
(`containers/vect_csr/vect_csr_edges_array.h:5-32`). Here: per direction we store the
flat values in CSR slot order, plus padded tile copies matching each bucket/huge tile
so the pull kernels read weights as dense rectangles with zero gather cost.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from .build import HostDirectedCSR
from .device import DeviceDirectedGraph, VGLGraph


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DirectedEdgeValues:
    flat: jax.Array                          # [e_pad] values in CSR slot order
    bucket_tiles: Tuple[jax.Array, ...]      # per bucket [rows_pad, width]
    huge_tile: Optional[jax.Array]           # [n_chunks_pad, chunk_w] or None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EdgeArray:
    outgoing: DirectedEdgeValues
    incoming: DirectedEdgeValues

    def direction(self, d: TraversalDirection) -> DirectedEdgeValues:
        return self.outgoing if d == TraversalDirection.SCATTER else self.incoming


def _tile_values(flat_ext: jax.Array, dg: DeviceDirectedGraph) -> DirectedEdgeValues:
    """Gather flat (e_pad+1, sentinel-extended) values into the tile layout."""
    bt = tuple(jnp.take(flat_ext, b.eidx, mode="clip") for b in dg.buckets)
    ht = (jnp.take(flat_ext, dg.huge.eidx, mode="clip")
          if dg.huge is not None else None)
    return DirectedEdgeValues(flat=flat_ext[:-1], bucket_tiles=bt, huge_tile=ht)


def build_edge_array_from_host(coo_values: np.ndarray, graph: VGLGraph,
                               h_out: HostDirectedCSR, h_in: HostDirectedCSR,
                               pad_value=0) -> EdgeArray:
    """Lay COO-ordered per-edge values out per direction using the host edge perms
    (the reference's edges_reorder_indexes path, import.hpp:157-165)."""
    dirs = []
    for h, dg in ((h_out, graph.outgoing), (h_in, graph.incoming)):
        flat = np.full(h.edges_pad, pad_value, dtype=coo_values.dtype)
        flat[:h.edges_count] = coo_values[h.edge_perm[:h.edges_count]]
        flat_ext = jnp.concatenate([
            jnp.asarray(flat), jnp.full((1,), pad_value, dtype=flat.dtype)])
        dirs.append(_tile_values(flat_ext, dg))
    return EdgeArray(outgoing=dirs[0], incoming=dirs[1])


def edge_array_from_flat(graph: VGLGraph, flat_out: jax.Array,
                         flat_in: jax.Array, pad_value=0) -> EdgeArray:
    """Rebuild tile copies after updating flat CSR-order values (e.g. max-flow's
    residual-capacity updates, reference mf.hpp get_flow/add/subtract path)."""
    dirs = []
    for flat, dg in ((flat_out, graph.outgoing), (flat_in, graph.incoming)):
        flat_ext = jnp.concatenate([
            flat, jnp.full((1,), pad_value, dtype=flat.dtype)])
        dirs.append(_tile_values(flat_ext, dg))
    return EdgeArray(outgoing=dirs[0], incoming=dirs[1])
