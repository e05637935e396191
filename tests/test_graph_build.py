"""Graph import/preprocessing correctness: degree sort, renumber maps, CSR, tiles."""
import numpy as np
import pytest

from vectorgraphlibrary.config import DEFAULT_CONFIG
from vectorgraphlibrary.graph.build import build_directed_csr
from vectorgraphlibrary.graph.device import import_graph
from vectorgraphlibrary.io import generation


@pytest.fixture(scope="module")
def ec():
    return generation.rmat(scale=8, avg_degree=6, seed=1)


def test_degree_sort_and_renumber(ec):
    h = build_directed_csr(ec.src_ids, ec.dst_ids, ec.vertices_count)
    v = ec.vertices_count
    degs_orig = np.bincount(ec.src_ids, minlength=v)
    # sorted descending
    ds = h.degrees[:v]
    assert np.all(ds[:-1] >= ds[1:])
    # maps are inverse bijections
    assert np.array_equal(h.orig_to_sorted[h.sorted_to_orig[:v]], np.arange(v))
    # degree preserved under renumber
    assert np.array_equal(ds, degs_orig[h.sorted_to_orig[:v]])


def test_csr_matches_coo(ec):
    h = build_directed_csr(ec.src_ids, ec.dst_ids, ec.vertices_count)
    v = ec.vertices_count
    # reconstruct edge set in original ids from CSR
    rows = np.repeat(np.arange(v), np.diff(h.row_ptr[:v + 1]))
    src_orig = h.sorted_to_orig[rows]
    dst_orig = h.sorted_to_orig[h.col_idx[:h.edges_count]]
    got = sorted(zip(src_orig.tolist(), dst_orig.tolist()))
    want = sorted(zip(ec.src_ids.tolist(), ec.dst_ids.tolist()))
    assert got == want


def test_edge_perm_roundtrip(ec):
    h = build_directed_csr(ec.src_ids, ec.dst_ids, ec.vertices_count)
    e = ec.edges_count
    perm = h.edge_perm[:e]
    assert np.array_equal(np.sort(perm), np.arange(e))
    # CSR slot i corresponds to original COO edge perm[i]: endpoints must agree
    v = ec.vertices_count
    rows = np.repeat(np.arange(v), np.diff(h.row_ptr[:v + 1]))
    assert np.array_equal(h.sorted_to_orig[rows], ec.src_ids[perm])
    assert np.array_equal(h.sorted_to_orig[h.col_idx[:e]], ec.dst_ids[perm])


def test_tiles_cover_all_edges(ec):
    h = build_directed_csr(ec.src_ids, ec.dst_ids, ec.vertices_count)
    slots = []
    if h.huge is not None:
        m = h.huge.eidx < h.edges_pad
        slots.append(h.huge.eidx[m])
        assert h.huge.eidx.shape[1] == DEFAULT_CONFIG.huge_row_chunk
    for b in h.buckets:
        m = b.eidx < h.edges_pad
        slots.append(b.eidx[m])
        # every real row's degree fits its bucket width
        degs = h.degrees[b.row_start:b.row_start + b.rows]
        assert np.all(degs <= b.width)
        assert np.all(degs >= 1)
    allslots = np.concatenate(slots)
    assert np.array_equal(np.sort(allslots), np.arange(ec.edges_count))


def test_tiles_adjacency_consistent(ec):
    h = build_directed_csr(ec.src_ids, ec.dst_ids, ec.vertices_count)
    for b in h.buckets:
        m = b.eidx < h.edges_pad
        assert np.array_equal(b.adj[m], h.col_idx[b.eidx[m]])
        assert np.all(b.adj[~m] == h.vertices_pad)


def test_import_graph_device(ec):
    g = import_graph(ec)
    assert g.v == ec.vertices_count
    assert g.e == ec.edges_count
    assert g.outgoing.v_pad == g.incoming.v_pad == g.v_pad
    # incoming degrees = in-degree histogram
    indeg = np.bincount(ec.dst_ids, minlength=ec.vertices_count)
    got = np.asarray(g.incoming.degrees)[:g.v]
    assert got.sum() == ec.edges_count
    assert np.array_equal(np.sort(got), np.sort(indeg))
