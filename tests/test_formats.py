"""Selectable graph formats (-format el/csr/csr_vg/vect_csr) run the same
algorithms through genuinely different advance kernels (reference 4-way
container dispatch, common/advance.hpp:32-111)."""
import numpy as np
import pytest

import vectorgraphlibrary as vgl
from vectorgraphlibrary.config import GraphFormat
from vectorgraphlibrary.graph.device import import_graph
from vectorgraphlibrary.graph.edges import build_edge_array_from_host
from vectorgraphlibrary.io import generation
from vectorgraphlibrary.models import bfs, common, pr, sssp
from vectorgraphlibrary.utils import verify

FORMATS = [GraphFormat.EDGES_LIST, GraphFormat.CSR, GraphFormat.CSR_VG,
           GraphFormat.TILE_CSR]


@pytest.fixture(scope="module")
def ec():
    return generation.rmat(scale=9, avg_degree=8, seed=5, weighted=True)


@pytest.mark.parametrize("fmt", FORMATS)
def test_format_structure(ec, fmt):
    g = import_graph(ec, graph_format=fmt)
    assert g.graph_format == fmt
    tiled = fmt in (GraphFormat.TILE_CSR, GraphFormat.CSR_VG)
    assert (len(g.incoming.buckets) > 0) == tiled
    # every format keeps the degree-sorted CSR arrays of both directions
    for dg in (g.outgoing, g.incoming):
        assert dg.col_idx.shape == (dg.e_pad,)
        assert int(dg.row_ptr[-1]) == ec.edges_count


@pytest.mark.parametrize("fmt", FORMATS)
def test_pagerank_all_formats(ec, fmt):
    g = import_graph(ec, graph_format=fmt)
    ranks, _ = pr.vgl_page_rank(g, max_iterations=25, use_convergence=False)
    got = vgl.as_original_numpy(ranks, g)
    want = pr.seq_page_rank(ec, max_iterations=25, use_convergence=False)
    assert verify.verify_ranking_results(got, want) == 0


@pytest.mark.parametrize("fmt", FORMATS)
def test_bfs_all_formats(ec, fmt):
    g = import_graph(ec, graph_format=fmt)
    src = common.select_random_source(ec, seed=3)
    levels = bfs.vgl_bfs(g, src)
    got = vgl.as_original_numpy(levels, g)
    want = bfs.seq_top_down(ec, src)
    assert verify.verify_results(got, want) == 0


@pytest.mark.parametrize("fmt", [GraphFormat.EDGES_LIST, GraphFormat.CSR])
def test_sssp_all_formats(ec, fmt):
    host = []
    g = import_graph(ec, graph_format=fmt, _host_out=host)
    ea = build_edge_array_from_host(ec.weights, g, host[0], host[1])
    src = common.select_random_source(ec, seed=7)
    dist, _ = sssp.vgl_dijkstra_all_active(g, ea, src)
    got = vgl.as_original_numpy(dist, g)
    want = sssp.seq_dijkstra(ec, src)
    assert verify.verify_results(got, want) == 0
