"""Advance: edge traversal — the framework's hot path.

Re-design of the reference's scatter/gather advance
(`vgl_compute_api/common/advance.hpp:6-232` dispatching into the 9-kernel NEC worker
`nec/advance_worker.hpp:219-361`). The kernel-per-degree-class structure survives —
huge rows (vector-engine analog), wide ELL buckets, and flat 128-wide narrow
buckets (the VectorExtension analog; see graph/device.py TileBucket) — and push with
a conflicting combine becomes either (a) a pull over the transposed container or
(b) a compacted-frontier ragged-expand + functional scatter-combine, replacing
`vovertake/novob` vector stores and `enable_safe_stores`
(`nec/graph_abstractions_nec.h:332-333`).

Two execution strategies, both plain XLA (element gathers + reductions):
- advance_pull / advance_pull_value: gather source values per edge slot, then
  reduce per destination row (tile rows, huge-row segments, or a sorted
  segment reduction over the CSR container);
- advance_push_sparse: work-efficient compacted-frontier expansion + scatter.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp

from ..config import TraversalDirection
from ..graph.device import DeviceDirectedGraph, VGLGraph
from ..graph.edges import DirectedEdgeValues
from . import monoid as M
from . import tiles as T

# gather-path edge_op(src_vals: Dict[str, Array[rows, W]],
#                     dst_vals: Dict[str, Array[rows, 1]],
#                     w: Optional[Array[rows, W]]) -> Array[rows, W]
EdgeOp = Callable


def _gather_src(arrs: Dict[str, jax.Array], adj: jax.Array) -> Dict[str, jax.Array]:
    return {k: jnp.take(a, adj, axis=0, mode="clip") for k, a in arrs.items()}


def _ext_tail(a: jax.Array, extra: int = 128) -> jax.Array:
    """Append `extra` zero slots so tile row slices can overrun v_pad.

    dynamic_slice CLAMPS out-of-bounds starts: a tail bucket whose rows_pad
    padding extends past v_pad would silently read values shifted backwards
    (rows_pad is rounded to the flat-lane multiple, up to 127 rows past the
    last real row). The padded slots themselves are masked downstream (adj
    sentinel / valid flag), only the slice base must stay in bounds."""
    return jnp.concatenate([a, jnp.zeros((extra,), a.dtype)])


def _dst_slice(arrs: Dict[str, jax.Array], start: int, rows_pad: int
               ) -> Dict[str, jax.Array]:
    return {k: jax.lax.dynamic_slice_in_dim(
                _ext_tail(a), start, rows_pad, axis=0)[:, None]
            for k, a in arrs.items()}


def _assemble(parts, covered, v_pad, ident, dtype):
    if covered < v_pad:
        parts.append(jnp.full((v_pad - covered,), ident, dtype=dtype))
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def _slot_rows(dg: DeviceDirectedGraph) -> jax.Array:
    """Owning row (sorted vertex id) of each CSR edge slot; pad slots → v_pad."""
    slots = jnp.arange(dg.e_pad, dtype=jnp.int32)
    return jnp.searchsorted(dg.row_ptr[1:], slots, side="right").astype(
        jnp.int32)


def _advance_pull_csr(graph: VGLGraph, src_arrays, edge_op, combine,
                      dst_arrays, edge_values, src_active, direction,
                      out_dtype, scatter: bool) -> jax.Array:
    """Advance over the plain CSR / EDGES_LIST containers (reference 4-way
    container switch, common/advance.hpp:32-111): edge-parallel gather of
    source values over col_idx, then either a SORTED segment reduction over
    row_ptr-derived rows (CSR) or a functional scatter-combine (EDGES_LIST —
    the race-free stand-in for the reference's flat COO scatter stores)."""
    mon = M.get(combine)
    dg = graph.direction(direction)
    dst_arrays = dst_arrays or {}
    rows = _slot_rows(dg)
    sv = {k: jnp.take(a, dg.col_idx, mode="clip")[:, None]
          for k, a in src_arrays.items()}
    dv = {k: jnp.take(a, rows, mode="clip")[:, None]
          for k, a in dst_arrays.items()}
    w = None if edge_values is None else edge_values.flat[:, None]
    probe_w = None if w is None else w[:1]
    probe = edge_op({k: a[:1] for k, a in sv.items()},
                    {k: a[:1] for k, a in dv.items()}, probe_w)
    dtype = out_dtype or probe.dtype
    ident = mon.identity(dtype)
    msg = edge_op(sv, dv, w).astype(dtype)[:, 0]
    valid = dg.col_idx < dg.v_pad
    if src_active is not None:
        valid = valid & jnp.take(src_active, dg.col_idx, mode="clip")
    if scatter:
        out = jnp.full((graph.v_pad,), ident, dtype)
        idx = jnp.where(valid, rows, graph.v_pad)
        return mon.scatter_at(out, idx, jnp.where(valid, msg, ident),
                              mode="drop")
    msg = jnp.where(valid, msg, ident)
    seg = jnp.minimum(rows, graph.v_pad)
    return mon.segment_reduce(msg, seg, graph.v_pad + 1,
                              indices_are_sorted=True)[:graph.v_pad]


def advance_pull(graph: VGLGraph,
                 src_arrays: Dict[str, jax.Array],
                 edge_op: EdgeOp,
                 combine,
                 dst_arrays: Optional[Dict[str, jax.Array]] = None,
                 edge_values: Optional[DirectedEdgeValues] = None,
                 src_active: Optional[jax.Array] = None,
                 direction: TraversalDirection = TraversalDirection.GATHER,
                 out_dtype=None) -> jax.Array:
    """Gather-based aggregate over incoming edges of every vertex (gather-mode
    advance, reference common_gather advance.hpp:116-123). Returns [v_pad] in the
    traversal direction's sorted ordering; zero-degree/padded rows get the monoid
    identity. src_arrays: per-src-vertex inputs, [v_pad], same ordering.

    Container dispatch (the reference's advance.hpp:32-111 switch): TILE_CSR /
    CSR_VG run the tiled kernels below; CSR runs the edge-parallel sorted
    segment reduction; EDGES_LIST the edge-parallel scatter-combine."""
    from ..config import GraphFormat
    if graph.graph_format == GraphFormat.CSR:
        return _advance_pull_csr(graph, src_arrays, edge_op, combine,
                                 dst_arrays, edge_values, src_active,
                                 direction, out_dtype, scatter=False)
    if graph.graph_format == GraphFormat.EDGES_LIST:
        return _advance_pull_csr(graph, src_arrays, edge_op, combine,
                                 dst_arrays, edge_values, src_active,
                                 direction, out_dtype, scatter=True)
    mon = M.get(combine)
    dg = graph.direction(direction)
    dst_arrays = dst_arrays or {}

    probe_src = {k: v[:1, None] for k, v in src_arrays.items()}
    probe_dst = {k: v[:1, None] for k, v in dst_arrays.items()}
    probe_w = None if edge_values is None else edge_values.flat[:1][:, None]
    probe = edge_op(probe_src, probe_dst, probe_w)
    dtype = out_dtype or probe.dtype
    ident = mon.identity(dtype)

    parts = []
    covered = 0

    if dg.huge is not None:
        h = dg.huge
        sv = _gather_src(src_arrays, h.adj)
        dvals = {k: jnp.take(a, h.seg_ids, mode="clip")[:, None]
                 for k, a in dst_arrays.items()}
        w = None if edge_values is None else edge_values.huge_tile
        msg = edge_op(sv, dvals, w).astype(dtype)
        valid = h.adj < dg.v_pad
        if src_active is not None:
            valid = valid & jnp.take(src_active, h.adj, mode="clip")
        msg = jnp.where(valid, msg, ident)
        chunk_red = mon.reduce_axis(msg, 1)
        seg = mon.segment_reduce(chunk_red, h.seg_ids, h.n_rows + 1,
                                 indices_are_sorted=True)
        parts.append(seg[:h.n_rows])
        covered = h.n_rows

    for i, b in enumerate(dg.buckets):
        sv = _gather_src(src_arrays, b.adj)
        w = None if edge_values is None else edge_values.bucket_tiles[i]
        if b.flat:
            m = b.slots // 128
            rowids = T.row_ids_flat(b.row_start, b.width, m)
            dvals = {k: jnp.take(a, rowids, mode="clip")
                     for k, a in dst_arrays.items()}
        else:
            dvals = _dst_slice(dst_arrays, b.row_start, b.rows_pad)
        msg = edge_op(sv, dvals, w).astype(dtype)
        valid = b.adj < dg.v_pad
        if src_active is not None:
            valid = valid & jnp.take(src_active, b.adj, mode="clip")
        msg = jnp.where(valid, msg, ident)
        if b.flat:
            parts.append(T.group_reduce_flat(msg, b.width, mon, b.rows))
        else:
            parts.append(mon.reduce_axis(msg, 1)[:b.rows])
        covered = b.row_start + b.rows

    return _assemble(parts, covered, graph.v_pad, ident, dtype)


def advance_pull_value(graph: VGLGraph,
                       src_vec: jax.Array,
                       combine,
                       edge_values: Optional[DirectedEdgeValues] = None,
                       weight_op: Optional[str] = None,
                       exclude_self_loops: bool = False,
                       src_active: Optional[jax.Array] = None,
                       direction: TraversalDirection = TraversalDirection.GATHER,
                       out_dtype=None,
                       src_in_src_order: bool = False) -> jax.Array:
    """Restricted-form advance for the hot algorithms. Per-edge message =
    ``weight_op(src_value, edge_value)`` (or the raw src value), masked to the
    combine identity on non-edge slots and, optionally, self-loop slots.
    Covers PR (add, no self-loops), BFS bottom-up (or), CC hook (min), HITS
    (add), SSSP pull (min of value+w), SSWP (max of min(value, w)).

    Same contract as advance_pull: ``src_vec`` [v_pad] in the traversal
    direction's ordering, result [v_pad] in that ordering; inactive sources
    (``src_active`` False) contribute nothing.

    src_in_src_order=True: ``src_vec`` (and ``src_active``) are in the SOURCE
    side's sorted ordering (SCATTER when direction=GATHER and vice versa);
    they are reordered to the direction's ordering here. Lets ping-pong
    algorithms (HITS auth/hub) keep state in the ordering each phase
    produces."""
    mon = M.get(combine)
    if src_in_src_order:
        from ..models import common as _mc
        src_side = (TraversalDirection.SCATTER
                    if direction == TraversalDirection.GATHER
                    else TraversalDirection.GATHER)
        src_vec = _mc.to_direction(graph, src_vec, src_side, direction)
        if src_active is not None:
            src_active = _mc.to_direction(graph, src_active, src_side,
                                          direction)
    wops = {None: lambda x, w: x, "add": lambda x, w: x + w,
            "min": jnp.minimum, "max": jnp.maximum, "mul": jnp.multiply}
    wop = wops[weight_op]
    srcs = {"x": src_vec}
    dsts = {}
    if exclude_self_loops:
        ids = jnp.arange(graph.v_pad, dtype=jnp.int32)
        srcs["id"] = ids
        dsts["id"] = ids

    def edge_op(s, d, w):
        x = wop(s["x"], w) if weight_op is not None else s["x"]
        if exclude_self_loops:
            ident = _mask_value(mon, x.dtype)
            x = jnp.where(s["id"] == d["id"], jnp.asarray(ident, x.dtype), x)
        return x

    return advance_pull(graph, srcs, edge_op, combine, dst_arrays=dsts,
                        edge_values=edge_values, src_active=src_active,
                        direction=direction, out_dtype=out_dtype)


def advance_cells(graph: VGLGraph,
                  cell_op,
                  combine,
                  edge_values: Optional[DirectedEdgeValues] = None,
                  direction: TraversalDirection = TraversalDirection.GATHER,
                  out_dtype=None) -> jax.Array:
    """Per-destination reduction over adjacency cells WITHOUT source values:
    msg = cell_op(src_ids, dst_ids, w). One pass over the tiles — for structural
    quantities (self-loop counts, filtered degrees)."""
    from ..config import GraphFormat
    mon = M.get(combine)
    dg = graph.direction(direction)
    if graph.graph_format in (GraphFormat.CSR, GraphFormat.EDGES_LIST):
        rows = _slot_rows(dg)
        w = None if edge_values is None else edge_values.flat[:, None]
        probe = cell_op(dg.col_idx[:1][:, None], rows[:1][:, None],
                        None if w is None else w[:1])
        dtype = out_dtype or probe.dtype
        ident = mon.identity(dtype)
        msg = cell_op(dg.col_idx[:, None], rows[:, None], w).astype(dtype)[:, 0]
        msg = jnp.where(dg.col_idx < dg.v_pad, msg, ident)
        seg = jnp.minimum(rows, graph.v_pad)
        return mon.segment_reduce(msg, seg, graph.v_pad + 1,
                                  indices_are_sorted=True)[:graph.v_pad]
    probe = cell_op(dg.col_idx[:1][:, None], dg.col_idx[:1][:, None],
                    None if edge_values is None
                    else edge_values.flat[:1][:, None])
    dtype = out_dtype or probe.dtype
    ident = mon.identity(dtype)
    parts = []
    covered = 0
    if dg.huge is not None:
        h = dg.huge
        dst_ids = jnp.broadcast_to(h.seg_ids[:, None],
                                   (h.n_chunks_pad, h.chunk_w))
        w = None if edge_values is None else edge_values.huge_tile
        msg = cell_op(h.adj, dst_ids, w).astype(dtype)
        msg = jnp.where(h.adj < dg.v_pad, msg, ident)
        chunk_red = mon.reduce_axis(msg, 1)
        seg = mon.segment_reduce(chunk_red, h.seg_ids, h.n_rows + 1,
                                 indices_are_sorted=True)
        parts.append(seg[:h.n_rows])
        covered = h.n_rows
    for i, b in enumerate(dg.buckets):
        w = None if edge_values is None else edge_values.bucket_tiles[i]
        if b.flat:
            dst_ids = T.row_ids_flat(b.row_start, b.width, b.slots // 128)
        else:
            dst_ids = b.row_start + jnp.broadcast_to(
                jax.lax.broadcasted_iota(jnp.int32, (b.rows_pad, 1), 0),
                (b.rows_pad, b.width))
        msg = cell_op(b.adj, dst_ids, w).astype(dtype)
        msg = jnp.where(b.adj < dg.v_pad, msg, ident)
        if b.flat:
            parts.append(T.group_reduce_flat(msg, b.width, mon, b.rows))
        else:
            parts.append(mon.reduce_axis(msg, 1)[:b.rows])
        covered = b.row_start + b.rows
    return _assemble(parts, covered, graph.v_pad, ident, dtype)


def _mask_value(mon, dtype):
    """Value that makes a source's messages act as the combine identity."""
    d = jnp.dtype(dtype)
    if mon.name in ("add", "or"):
        return 0
    if mon.name == "min":
        return jnp.inf if jnp.issubdtype(d, jnp.floating) else jnp.iinfo(d).max
    if mon.name == "max":
        return -jnp.inf if jnp.issubdtype(d, jnp.floating) else jnp.iinfo(d).min
    raise ValueError(mon.name)


def advance_push_sparse(graph: VGLGraph,
                        frontier_ids: jax.Array,       # int32 [cap], pad = v_pad
                        frontier_valid: jax.Array,     # bool [cap]
                        edge_capacity: int,
                        src_arrays: Dict[str, jax.Array],
                        edge_op: EdgeOp,
                        combine,
                        out: jax.Array,
                        edge_values: Optional[DirectedEdgeValues] = None,
                        direction: TraversalDirection = TraversalDirection.SCATTER,
                        ) -> jax.Array:
    """Work-efficient push from a compacted frontier (sparse advance, the analog of
    the reference's sparse collective kernel `nec/advance_sparse.hpp:190-250`).

    Expands the frontier's ragged adjacency into a flat padded edge list of static
    size ``edge_capacity`` (cumsum + searchsorted), gathers messages edge-parallel,
    and scatter-combines into ``out`` ([v_pad], same ordering)."""
    mon = M.get(combine)
    dg = graph.direction(direction)
    cap = frontier_ids.shape[0]

    # ALL per-frontier lookups happen at CAP size (cheap when the tiered
    # capacities are small), and the edge_capacity-sized stages are exactly
    # four passes: mark-scatter+cummax (owner), one fused owner-indexed
    # gather group (delta + per-source values), one fused e_slot-indexed
    # gather group (adjacency + edge values), and the final scatter-combine.
    # Gathers sharing an index array fuse into one pass in XLA; the work is
    # edge_capacity-sized whatever the live frontier, which is why the
    # caller's tier ladder — not this function — is the real
    # work-efficiency mechanism.
    degs = jnp.where(frontier_valid,
                     jnp.take(dg.degrees, frontier_ids, mode="clip"), 0)
    row_start_c = jnp.take(dg.row_ptr, frontier_ids, mode="clip")
    ends = jnp.cumsum(degs)                                     # inclusive
    starts_local = ends - degs
    # per-frontier-row constant: e_slot = pos + delta[owner]
    delta_c = row_start_c - starts_local
    sv_cap = {k: jnp.take(a, frontier_ids, mode="clip")
              for k, a in src_arrays.items()}
    total = ends[-1] if cap > 0 else jnp.int32(0)

    pos = jnp.arange(edge_capacity, dtype=jnp.int32)
    # owner row of each flat edge slot WITHOUT searchsorted (which lowers to
    # log(cap) rounds of element gathers):
    # scatter each nonempty row's index at its start offset, then a cummax
    # fills the run. Zero-degree rows share start offsets and must not
    # scatter (their run length is 0).
    frontier_idx = jnp.arange(cap, dtype=jnp.int32)
    # rows whose start offset overflows edge_capacity (contract violation:
    # frontier degree sum > capacity) must DROP, not clamp — a clamp would
    # scatter onto slot capacity-1 and steal the last slot's ownership
    mark_slot = jnp.where(frontier_valid & (degs > 0)
                          & (starts_local < edge_capacity),
                          starts_local, edge_capacity)
    owner_c = jnp.full(edge_capacity, -1, jnp.int32).at[mark_slot].max(
        frontier_idx, mode="drop")
    owner_c = jax.lax.cummax(owner_c)
    evalid = (pos < total) & (owner_c >= 0)
    owner_c = jnp.clip(owner_c, 0, cap - 1)

    e_slot = jnp.where(evalid,
                       pos + jnp.take(delta_c, owner_c, mode="clip"),
                       dg.e_pad)
    dsts = jnp.take(dg.col_idx, e_slot, mode="clip")
    sv = {k: jnp.take(a, owner_c, mode="clip")[:, None]
          for k, a in sv_cap.items()}
    w = (None if edge_values is None
         else jnp.take(edge_values.flat, e_slot, mode="clip")[:, None])
    msg = edge_op(sv, {}, w)[:, 0]
    msg = msg.astype(out.dtype)

    scatter_idx = jnp.where(evalid, dsts, out.shape[0])   # OOB → dropped
    return mon.scatter_at(out, scatter_idx, msg, mode="drop")
