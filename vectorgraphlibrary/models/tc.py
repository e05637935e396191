"""TC: transitive closure (the reference's TC) + triangle counting.

Transitive closure matches `algorithms/tc/tc.h:15-21`: `vgl_purdoms` — SCC
condensation → cross-component edge filtering → reachability on the condensed DAG
(Purdom's method, tc.hpp:5-60) — and `vgl_bfs_based` per-source BFS. The query
surface is reachability between vertex pairs.

Triangle counting is the BASELINE.json north-star addition (SDDMM-style
intersection): count = trace(A·A·A)/6 on the undirected graph; computed here by
per-edge neighbor-set intersection over sorted ELL rows — each edge (u,v) counts
|N(u) ∩ N(v)| via a merge of two sorted rows, vectorized across a bucket.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray
from ..io.edges_container import EdgesContainer
from . import cc as cc_mod
from . import scc as scc_mod
from . import bfs as bfs_mod

S, G, O = (TraversalDirection.SCATTER, TraversalDirection.GATHER,
           TraversalDirection.ORIGINAL)


# ---------------------------------------------------------------- transitive closure
def vgl_purdoms(ec: EdgesContainer, graph: VGLGraph):
    """Purdom: condense SCCs, dedupe cross-component edges, return the condensed
    DAG as (labels, condensed EdgesContainer). Reachability queries then run BFS
    on the (much smaller) condensation."""
    labels = scc_mod.vgl_forward_backward(graph)
    lab = np.asarray(labels.values)[:graph.v]
    # relabel to dense component ids
    uniq, dense = np.unique(lab, return_inverse=True)
    csrc = dense[ec.src_ids]
    cdst = dense[ec.dst_ids]
    keep = csrc != cdst
    key = csrc[keep].astype(np.int64) * len(uniq) + cdst[keep]
    ukey = np.unique(key)
    cec = EdgesContainer((ukey // len(uniq)).astype(np.int32),
                         (ukey % len(uniq)).astype(np.int32), len(uniq))
    return dense.astype(np.int32), cec


def reachability(ec: EdgesContainer, graph: VGLGraph, sources: np.ndarray
                 ) -> np.ndarray:
    """bool [len(sources), v]: vgl_purdoms-based multi-source reachability."""
    from ..graph.device import import_graph
    dense, cec = vgl_purdoms(ec, graph)
    if cec.edges_count == 0:
        out = np.zeros((len(sources), graph.v), bool)
        for i, s in enumerate(sources):
            out[i] = dense == dense[s]
        return out
    cg = import_graph(cec)
    out = np.zeros((len(sources), graph.v), bool)
    for i, s in enumerate(sources):
        levels = bfs_mod.vgl_top_down(cg, int(dense[s]))
        from ..graph.vertices import as_original_numpy
        lv = as_original_numpy(levels, cg)
        out[i] = lv[dense] != bfs_mod.UNVISITED
    return out


def vgl_bfs_based_reachability(graph: VGLGraph, sources) -> np.ndarray:
    """Per-source BFS reachability (reference tc `vgl_bfs_based`)."""
    from ..graph.vertices import as_original_numpy
    rows = []
    for s in sources:
        lv = as_original_numpy(bfs_mod.vgl_top_down(graph, int(s)), graph)
        rows.append(lv != bfs_mod.UNVISITED)
    return np.stack(rows)


def seq_reachability(ec: EdgesContainer, sources) -> np.ndarray:
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    a = sp.csr_matrix((np.ones(ec.edges_count, np.int8),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    hops = csg.shortest_path(a, method="D", unweighted=True, directed=True,
                             indices=np.asarray(sources))
    return ~np.isinf(hops)


# ---------------------------------------------------------------- triangle counting
def _oriented_simple_edges(ec: EdgesContainer):
    """Degree-oriented deduped edge list of the undirected simple graph:
    (u, v) kept iff (deg, id) of u < (deg, id) of v — every triangle appears
    exactly once as a directed wedge closure."""
    v = ec.vertices_count
    s = np.concatenate([ec.src_ids, ec.dst_ids]).astype(np.int64)
    d = np.concatenate([ec.dst_ids, ec.src_ids]).astype(np.int64)
    keep = s != d
    s, d = s[keep], d[keep]
    key = np.unique(s * v + d)              # dedupe parallel edges
    s, d = key // v, key % v
    deg = np.bincount(s, minlength=v)       # undirected simple degree
    rank = deg.astype(np.int64) * v + np.arange(v)   # total order (deg, id)
    fwd = rank[s] < rank[d]
    return s[fwd].astype(np.int32), d[fwd].astype(np.int32)


@functools.partial(jax.jit, static_argnums=(3,))
def _tc_block_count(bits: jax.Array, u_e: jax.Array, v_e: jax.Array,
                    chunk: int) -> jax.Array:
    """Per-chunk sums of popcount(bits[u] & bits[v]) over edges, int32
    [n_chunks]; the caller sums them as Python ints (jax_enable_x64 is off, so
    an int64 device accumulator would silently truncate to int32). A chunk's
    own total stays well under 2^31: it needs chunk·avg-common-neighbors ≥
    2^31, i.e. ~262k shared neighbors per edge at chunk=8192."""
    n_chunks = u_e.shape[0] // chunk

    def body(i, acc):
        us = jax.lax.dynamic_slice_in_dim(u_e, i * chunk, chunk)
        vs = jax.lax.dynamic_slice_in_dim(v_e, i * chunk, chunk)
        ru = jnp.take(bits, us, axis=0)
        rv = jnp.take(bits, vs, axis=0)
        cnt = jax.lax.population_count(ru & rv)
        return acc.at[i].set(jnp.sum(cnt, dtype=jnp.int32))

    return jax.lax.fori_loop(0, n_chunks, body,
                             jnp.zeros(n_chunks, jnp.int32))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _tc_build_bits(u_blk: jax.Array, v_local: jax.Array, v_rows: int,
                   words: int, dummy_row: int) -> jax.Array:
    """Scatter one column-block's oriented edges into a [v_rows+1, words]
    bitmap (last row stays zero — the edge-padding target)."""
    bits = jnp.zeros((v_rows + 1, words), jnp.int32)
    word = v_local >> 5
    bit = jnp.int32(1) << (v_local & 31)
    # deduped edges → each (row, word, bitpos) unique → add == or
    return bits.at[u_blk, word].add(bit, mode="drop")


def vgl_triangle_count(ec: EdgesContainer, block_bits: Optional[int] = None,
                       edge_chunk: int = 1 << 15, _oriented=None) -> int:
    """DEVICE triangle count (BASELINE.json SDDMM-style config): for each
    degree-oriented edge (u,v), |N+(u) ∩ N+(v)| via column-blocked dense
    bitmaps — per block, N+ rows become [v, W/32] int32 bitmaps (built by one
    device scatter of the block's edges) and every edge contributes one
    128-lane AND + popcount row pass. No sorting, no merge loops: total work
    is e·v/32 word-ops, blocked so device memory stays ≤ ~0.5 GB.
    (The VPU analog of the reference-era bitmap set intersection.)"""
    v = ec.vertices_count
    # _oriented: pre-computed host orientation (lets benchmarks time the host
    # dedupe/orientation pass separately from device intersection)
    u_e, v_e = (_oriented if _oriented is not None
                else _oriented_simple_edges(ec))
    e_plus = len(u_e)
    if e_plus == 0:
        return 0
    if block_bits is None:
        # v rows × (block_bits/32) int32 words ≤ ~0.5 GB
        block_bits = int(min(max(1 << 10, (1 << 32) // max(v, 1)), 1 << 20))
    block_bits = max(32, block_bits)
    words = block_bits // 32

    def ladder_pad(a, fill, unit):
        """Pad to the next power-of-two multiple of `unit` — bounds the
        number of distinct jit shapes to ~log2(e) across all blocks."""
        n = max(len(a), unit)
        tgt = unit
        while tgt < n:
            tgt *= 2
        out = np.full(tgt, fill, a.dtype)
        out[:len(a)] = a
        return out

    # presence filter: popcount(bits[u] & bits[v]) is zero unless BOTH rows
    # have a neighbor inside the block, so per block only edges whose
    # endpoints both touch the block pay a row gather. On degree-oriented RMAT
    # each N+ row spans few blocks, so this drops the gathered-row count
    # ~|blocks|-fold versus gathering every edge for every block.
    total = 0
    for c0 in range(0, v, block_bits):
        m = (v_e >= c0) & (v_e < c0 + block_bits)
        if not m.any():
            continue
        pres = np.zeros(v + 1, bool)
        pres[u_e[m]] = True
        em = pres[u_e] & pres[v_e]
        if not em.any():
            continue
        ub = jnp.asarray(ladder_pad(u_e[m], v, 1024))
        vb = jnp.asarray(ladder_pad(v_e[m] - c0, block_bits, 1024))
        bits = _tc_build_bits(ub, vb, v, words, v)
        u_f = jnp.asarray(ladder_pad(u_e[em], v, edge_chunk))
        v_f = jnp.asarray(ladder_pad(v_e[em], v, edge_chunk))
        chunk_sums = np.asarray(_tc_block_count(bits, u_f, v_f, edge_chunk))
        total += sum(int(x) for x in chunk_sums)   # host int: no 2^31 wrap
    return total


def seq_triangle_count(ec: EdgesContainer) -> int:
    """Independent oracle: SciPy masked sparse product trace(A·A·A)/6."""
    import scipy.sparse as sp
    v = ec.vertices_count
    s = np.concatenate([ec.src_ids, ec.dst_ids])
    d = np.concatenate([ec.dst_ids, ec.src_ids])
    keep = s != d
    # int64 data: int8 path counts overflow on hub-heavy graphs
    a = sp.csr_matrix((np.ones(keep.sum(), np.int64), (s[keep], d[keep])),
                      shape=(v, v))
    a.data[:] = 1                      # dedupe parallel edges
    a2 = a @ a
    return int((a2.multiply(a)).sum()) // 6
