"""Device-resident graph pytrees.

Analog of the reference's graph containers: ``VGLGraph`` plays the role of
``VGL_Graph`` — a wrapper holding TWO directed containers (outgoing + incoming), built
by importing outgoing, transposing the COO, and importing incoming
(reference `vgl_datastructures/graphs/vgl_graph/vgl_graph.hpp:23-64`). Each direction
is a ``DeviceDirectedGraph``: degree-sorted CSR + padded tile buckets (build.py), all
static-shaped int32 arrays living in device memory, registered as JAX pytrees so primitives can
be jitted over them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import VGLConfig, DEFAULT_CONFIG, GraphFormat, TraversalDirection
from .build import HostDirectedCSR, build_directed_csr
from ..io.edges_container import EdgesContainer


def _static(*names):
    return {"meta_fields": tuple(names)}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TileBucket:
    """A dense ELL rectangle of adjacency for a contiguous degree-sorted vertex
    range [row_start, row_start+rows).

    Storage layout (the analog of the reference VectorExtension's
    column-major VL-segments):
    - width >= 128: arrays are (rows_pad, width), one vertex-row per array row;
    - width < 128 ("flat"): arrays are (rows_pad*width//128, 128) —
      consecutive width-slot groups packed 128 wide; per-row reductions
      happen via grouped reduction (ops/tiles.py)."""

    adj: jax.Array                  # int32, sentinel = v_pad
    eidx: jax.Array                 # int32, CSR edge slot
    width: int = dataclasses.field(metadata=dict(static=True), default=0)
    row_start: int = dataclasses.field(metadata=dict(static=True), default=0)
    rows: int = dataclasses.field(metadata=dict(static=True), default=0)
    rows_pad: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def flat(self) -> bool:
        return self.width < 128

    @property
    def slots(self) -> int:
        return self.rows_pad * self.width


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HugeTile:
    """Row-split high-degree class (the 'vector engine' analog)."""

    adj: jax.Array                  # int32 [n_chunks_pad, chunk_w]
    eidx: jax.Array                 # int32 [n_chunks_pad, chunk_w]
    seg_ids: jax.Array              # int32 [n_chunks_pad], ascending row ids
    chunk_w: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_rows: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_chunks: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_chunks_pad: int = dataclasses.field(metadata=dict(static=True), default=0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceDirectedGraph:
    """One traversal direction: degree-sorted CSR + tiles + renumber maps."""

    row_ptr: jax.Array              # int32 [v_pad+1]
    col_idx: jax.Array              # int32 [e_pad]
    degrees: jax.Array              # int32 [v_pad]
    sorted_to_orig: jax.Array       # int32 [v_pad]
    orig_to_sorted: jax.Array       # int32 [v_pad]
    buckets: Tuple[TileBucket, ...]
    huge: Optional[HugeTile]
    v: int = dataclasses.field(metadata=dict(static=True), default=0)
    v_pad: int = dataclasses.field(metadata=dict(static=True), default=0)
    e: int = dataclasses.field(metadata=dict(static=True), default=0)
    e_pad: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def nonzero_rows(self) -> int:
        """Rows with degree >= 1 (they are the first rows in sorted order)."""
        last = 0
        if self.huge is not None:
            last = self.huge.n_rows
        for b in self.buckets:
            last = max(last, b.row_start + b.rows)
        return last


def _to_device_directed(h: HostDirectedCSR, e_static: Optional[int] = None,
                        with_eidx: bool = True) -> DeviceDirectedGraph:
    """with_eidx=False skips shipping the per-slot CSR edge indices — they
    exist only to lay out EdgeArray values into tiles, so unweighted graphs
    save |slots|*4 bytes of HBM per direction."""
    def _shape(a, width, rows_pad):
        if width < 128:
            return a.reshape(rows_pad * width // 128, 128)
        return a

    def _eidx(a, width=None, rows_pad=None):
        if not with_eidx:
            return None
        a = np.minimum(a, np.int64(2**31 - 1))
        if width is not None:
            a = _shape(a, width, rows_pad)
        return jnp.asarray(a, jnp.int32)
    buckets = tuple(
        TileBucket(adj=jnp.asarray(_shape(b.adj, b.width, b.rows_pad),
                                   jnp.int32),
                   eidx=_eidx(b.eidx, b.width, b.rows_pad),
                   width=b.width, row_start=b.row_start, rows=b.rows,
                   rows_pad=b.rows_pad)
        for b in h.buckets)
    huge = None
    if h.huge is not None:
        hh = h.huge
        huge = HugeTile(adj=jnp.asarray(hh.adj, jnp.int32),
                        eidx=_eidx(hh.eidx),
                        seg_ids=jnp.asarray(hh.seg_ids, jnp.int32),
                        chunk_w=hh.chunk_w, n_rows=hh.n_rows,
                        n_chunks=hh.n_chunks, n_chunks_pad=hh.n_chunks_pad)
    return DeviceDirectedGraph(
        row_ptr=jnp.asarray(h.row_ptr, jnp.int32),
        col_idx=jnp.asarray(h.col_idx, jnp.int32),
        degrees=jnp.asarray(h.degrees, jnp.int32),
        sorted_to_orig=jnp.asarray(h.sorted_to_orig, jnp.int32),
        orig_to_sorted=jnp.asarray(h.orig_to_sorted, jnp.int32),
        buckets=buckets, huge=huge,
        v=h.vertices_count, v_pad=h.vertices_pad,
        e=h.edges_count if e_static is None else e_static, e_pad=h.edges_pad)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VGLGraph:
    """User-facing graph: outgoing + incoming directed containers
    (reference vgl_graph.h:7-80). SCATTER traverses outgoing, GATHER incoming."""

    outgoing: DeviceDirectedGraph
    incoming: DeviceDirectedGraph
    v: int = dataclasses.field(metadata=dict(static=True), default=0)
    v_pad: int = dataclasses.field(metadata=dict(static=True), default=0)
    e: int = dataclasses.field(metadata=dict(static=True), default=0)
    graph_format: GraphFormat = dataclasses.field(
        metadata=dict(static=True), default=GraphFormat.TILE_CSR)

    def direction(self, d: TraversalDirection) -> DeviceDirectedGraph:
        if d == TraversalDirection.SCATTER:
            return self.outgoing
        if d == TraversalDirection.GATHER:
            return self.incoming
        raise ValueError("ORIGINAL has no directed container")

    def select_device_graph(self, d: TraversalDirection) -> DeviceDirectedGraph:
        return self.direction(d)


def import_graph(ec: EdgesContainer, cfg: VGLConfig = DEFAULT_CONFIG,
                 graph_format: GraphFormat = GraphFormat.TILE_CSR,
                 _host_out: Optional[list] = None,
                 keep_edge_slots: Optional[bool] = None) -> VGLGraph:
    """COO → VGLGraph (both directions), reference vgl_graph.hpp:60-64.

    Format dispatch (reference create_containers, vgl_graph.hpp:23-54):
    TILE_CSR/CSR_VG build the padded tile classes; CSR and EDGES_LIST keep
    only the degree-sorted CSR arrays — their advances run the edge-parallel
    segment-reduce / scatter kernels (ops/advance.py)."""
    h_out = build_directed_csr(ec.src_ids, ec.dst_ids, ec.vertices_count, cfg)
    h_in = build_directed_csr(ec.dst_ids, ec.src_ids, ec.vertices_count, cfg)
    if graph_format in (GraphFormat.CSR, GraphFormat.EDGES_LIST):
        # no tiles: strip the tile classes the builder prepared
        for h in (h_out, h_in):
            h.buckets = []
            h.huge = None
    if _host_out is not None:
        _host_out.extend([h_out, h_in])
    # per-slot edge indices are only needed to lay out EdgeArray values;
    # unweighted graphs skip them (|slots|*4 B of device memory per direction)
    if keep_edge_slots is None:
        keep_edge_slots = ec.weights is not None
    out = _to_device_directed(h_out, with_eidx=keep_edge_slots)
    inc = _to_device_directed(h_in, with_eidx=keep_edge_slots)
    assert out.v_pad == inc.v_pad
    return VGLGraph(outgoing=out, incoming=inc,
                    v=ec.vertices_count, v_pad=out.v_pad, e=ec.edges_count,
                    graph_format=graph_format)
