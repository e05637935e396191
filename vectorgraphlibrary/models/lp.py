"""Label propagation (community detection).

Capability match for the reference LP (`algorithms/lp/lp.h:15-27`): iterative
mode-of-neighbor-labels until stable. The reference ships GPU + sequential variants
only (no NEC implementation, SURVEY.md §2.5); here: a device variant computing the
neighborhood mode per degree bucket by sorting each padded ELL row (jnp.sort along
the width axis) and taking the longest run — a fully vectorized mode with no
scatter. Huge-class rows (deg > cfg.huge_degree_threshold) are EXACT too: one
multi-key lax.sort of the whole huge tile by (row, label), per-element run
lengths, then two segment reductions (max run length per row, then min label
among max-length runs — ties break to the smaller label like the buckets).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray
from . import common

G, O = TraversalDirection.GATHER, TraversalDirection.ORIGINAL
_BIG = jnp.int32(2**31 - 1)


def _row_mode(sorted_rows: jax.Array, fallback: jax.Array) -> jax.Array:
    """Mode of each row of an ascending-sorted [rows, W] array; padding = _BIG.
    Ties break toward the smaller label (first-longest run wins argmax)."""
    rows, w = sorted_rows.shape
    idx = jax.lax.broadcasted_iota(jnp.int32, (rows, w), 1)
    newrun = jnp.concatenate([
        jnp.ones((rows, 1), bool),
        sorted_rows[:, 1:] != sorted_rows[:, :-1]], axis=1)
    start = jax.lax.cummax(jnp.where(newrun, idx, -1), axis=1)
    runlen = idx - start + 1
    valid = sorted_rows < _BIG
    runlen = jnp.where(valid, runlen, 0)
    best = jnp.argmax(runlen, axis=1)
    mode = jnp.take_along_axis(sorted_rows, best[:, None], axis=1)[:, 0]
    any_valid = valid[:, 0]
    return jnp.where(any_valid, mode, fallback)


@jax.jit
def _lp_step(graph: VGLGraph, labels_g: jax.Array):
    """One LP round in GATHER ordering: labels <- mode of in-neighbor labels."""
    dg = graph.incoming
    v_pad = graph.v_pad
    parts = []
    covered = 0
    if dg.huge is not None:
        h = dg.huge
        vals = jnp.take(labels_g, h.adj, mode="clip")
        vals = jnp.where(h.adj < v_pad, vals, _BIG)
        # EXACT mode across all chunks of each huge row: flatten the tile,
        # sort by (row, label), run-length per element, then per-row
        # max-run-length and min-label-among-max-runs segment reductions
        rows_flat = jnp.broadcast_to(h.seg_ids[:, None],
                                     vals.shape).reshape(-1)
        vals_flat = vals.reshape(-1)
        rows_s, vals_s = jax.lax.sort((rows_flat, vals_flat), num_keys=2)
        n = vals_s.shape[0]
        idx = jnp.arange(n, dtype=jnp.int32)
        newrun = jnp.concatenate([
            jnp.ones((1,), bool),
            (vals_s[1:] != vals_s[:-1]) | (rows_s[1:] != rows_s[:-1])])
        start = jax.lax.cummax(jnp.where(newrun, idx, -1))
        runlen = jnp.where(vals_s < _BIG, idx - start + 1, 0)
        nseg = h.n_rows + 1
        seg = jnp.minimum(rows_s, nseg - 1)
        maxlen = jax.ops.segment_max(runlen, seg, nseg,
                                     indices_are_sorted=True)
        is_best = (runlen > 0) & (runlen == jnp.take(maxlen, seg))
        best_label = jax.ops.segment_min(
            jnp.where(is_best, vals_s, _BIG), seg, nseg,
            indices_are_sorted=True)
        fallback = jax.lax.dynamic_slice_in_dim(labels_g, 0, h.n_rows)
        got = best_label[:h.n_rows]
        parts.append(jnp.where(got < _BIG, got, fallback))
        covered = h.n_rows
    for b in dg.buckets:
        adj = b.adj.reshape(b.rows_pad, b.width) if b.flat else b.adj
        vals = jnp.take(labels_g, adj, mode="clip")
        vals = jnp.where(adj < v_pad, vals, _BIG)
        srt = jnp.sort(vals, axis=1)
        fallback = jax.lax.dynamic_slice_in_dim(labels_g, b.row_start, b.rows_pad)
        parts.append(_row_mode(srt, fallback)[:b.rows])
        covered = b.row_start + b.rows
    if covered < v_pad:
        parts.append(jax.lax.dynamic_slice_in_dim(
            labels_g, covered, v_pad - covered))
    new = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    changes = jnp.sum(new != labels_g, dtype=jnp.int32)
    return new, changes


def vgl_label_propagation(graph: VGLGraph, max_iterations: int = 20
                          ) -> tuple[VertexArray, int]:
    """Labels start as ORIGINAL vertex ids (converted to GATHER ordering)."""
    ids = jnp.arange(graph.v_pad, dtype=jnp.int32)
    labels_o = jnp.where(ids < graph.v, ids, _BIG)
    labels = jnp.take(labels_o, graph.incoming.sorted_to_orig, mode="clip")
    it = 0
    for it in range(1, max_iterations + 1):
        labels, changes = _lp_step(graph, labels)
        if int(changes) == 0:
            break
    out = jnp.take(labels, graph.incoming.orig_to_sorted, mode="clip")
    return VertexArray(values=out, direction=O), it


def seq_label_propagation(ec, max_iterations: int = 20) -> np.ndarray:
    """Sequential oracle with the same synchronous mode semantics (mode over
    in-neighbors, ties to smaller label, keep own label if no in-neighbors)."""
    v = ec.vertices_count
    labels = np.arange(v, dtype=np.int64)
    # adjacency with multiplicity preserved (parallel edges weight the mode,
    # matching the device semantics); csr_matrix would collapse duplicates
    order = np.argsort(ec.dst_ids, kind="stable")
    indices = ec.src_ids[order]
    counts = np.bincount(ec.dst_ids, minlength=v)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    for _ in range(max_iterations):
        new = labels.copy()
        for u in range(v):
            nb = labels[indices[indptr[u]:indptr[u + 1]]]
            if len(nb) == 0:
                continue
            vals, counts = np.unique(nb, return_counts=True)
            new[u] = vals[np.argmax(counts)]
        if np.array_equal(new, labels):
            break
        labels = new
    return labels.astype(np.int32)
