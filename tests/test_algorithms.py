"""Algorithms vs sequential oracles (the reference's -check contract, SURVEY.md §4)."""
import numpy as np
import pytest

import vectorgraphlibrary as vgl
from vectorgraphlibrary.graph.device import import_graph
from vectorgraphlibrary.graph.edges import build_edge_array_from_host
from vectorgraphlibrary.models import bfs, pr, sssp, common
from vectorgraphlibrary.utils import verify


@pytest.fixture(scope="module")
def setup(small_rmat):
    ec = small_rmat.with_random_weights(seed=11)
    host = []
    g = import_graph(ec, _host_out=host)
    ea = build_edge_array_from_host(ec.weights, g, host[0], host[1])
    return ec, g, ea


@pytest.fixture(scope="module")
def setup_ru(small_ru):
    ec = small_ru.with_random_weights(seed=13)
    host = []
    g = import_graph(ec, _host_out=host)
    ea = build_edge_array_from_host(ec.weights, g, host[0], host[1])
    return ec, g, ea


def test_pagerank_vs_oracle(setup):
    ec, g, ea = setup
    ranks, iters = pr.vgl_page_rank(g, max_iterations=100)
    got = vgl.as_original_numpy(ranks, g)
    want = pr.seq_page_rank(ec, max_iterations=100)
    assert verify.verify_ranking_results(got, want) == 0
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-3)
    assert iters > 2


def test_bfs_top_down_vs_oracle(setup):
    ec, g, ea = setup
    src = common.select_random_source(ec, seed=1)
    levels = bfs.vgl_top_down(g, src)
    got = vgl.as_original_numpy(levels, g)
    want = bfs.seq_top_down(ec, src)
    assert verify.verify_results(got, want) == 0


def test_bfs_direction_optimizing_vs_oracle(setup):
    ec, g, ea = setup
    for seed in (2, 3):
        src = common.select_random_source(ec, seed=seed)
        levels = bfs.vgl_bfs(g, src)
        got = vgl.as_original_numpy(levels, g)
        want = bfs.seq_top_down(ec, src)
        assert verify.verify_results(got, want) == 0


def test_bfs_device_do_vs_oracle(setup):
    """Fully device-resident DO-BFS (one jitted while_loop, lax.cond branch
    selection) vs the oracle — both td-capable and bu-forcing capacities."""
    ec, g, ea = setup
    for seed, id_cap, edge_cap in ((2, 1 << 10, 1 << 13), (4, 64, 256)):
        src = common.select_random_source(ec, seed=seed)
        levels = bfs.vgl_bfs_device(g, src, id_cap=id_cap, edge_cap=edge_cap)
        got = vgl.as_original_numpy(levels, g)
        want = bfs.seq_top_down(ec, src)
        assert verify.verify_results(got, want) == 0


def test_bfs_on_uniform(setup_ru):
    ec, g, ea = setup_ru
    src = common.select_random_source(ec, seed=5)
    got = vgl.as_original_numpy(bfs.vgl_bfs(g, src), g)
    want = bfs.seq_top_down(ec, src)
    assert verify.verify_results(got, want) == 0


def test_sssp_all_active_vs_oracle(setup):
    ec, g, ea = setup
    src = common.select_random_source(ec, seed=4)
    dist, iters = sssp.vgl_dijkstra_all_active(g, ea, src)
    got = vgl.as_original_numpy(dist, g)
    want = sssp.seq_dijkstra(ec, src)
    assert verify.verify_results(got, want) == 0
    assert iters >= 2


def test_sssp_partial_active_vs_oracle(setup):
    ec, g, ea = setup
    src = common.select_random_source(ec, seed=6)
    dist, iters = sssp.vgl_dijkstra_partial_device(g, ea, src)
    got = vgl.as_original_numpy(dist, g)
    want = sssp.seq_dijkstra(ec, src)
    assert verify.verify_results(got, want) == 0


def test_sssp_partial_device_vs_oracle(setup):
    """Device-resident partial-active SSSP (one jitted while_loop, sparse-push
    / dense-pull lax.switch) vs the oracle — both push-capable and
    dense-forcing capacities."""
    ec, g, ea = setup
    for seed, id_cap, edge_cap in ((8, 1 << 10, 1 << 13), (9, 64, 256)):
        src = common.select_random_source(ec, seed=seed)
        dist, iters = sssp.vgl_dijkstra_partial_device(
            g, ea, src, id_cap=id_cap, edge_cap=edge_cap)
        got = vgl.as_original_numpy(dist, g)
        want = sssp.seq_dijkstra(ec, src)
        assert verify.verify_results(got, want) == 0
        assert iters >= 2


def test_bfs_device_multi_matches_single(setup):
    """Batched-root device DO-BFS returns the same levels as per-root runs."""
    ec, g, ea = setup
    roots = [common.select_random_source(ec, seed=s) for s in (2, 4)]
    multi = np.asarray(bfs.vgl_bfs_device_multi(
        g, roots, id_cap=1 << 10, edge_cap=1 << 13).values)
    for i, src in enumerate(roots):
        single = np.asarray(bfs.vgl_bfs_device(
            g, src, id_cap=1 << 10, edge_cap=1 << 13).values)
        np.testing.assert_array_equal(multi[i], single)


def test_msbfs_matches_oracle_per_root(setup):
    """Bit-parallel multi-source BFS: every root's level array must equal the
    sequential oracle's — including duplicate roots sharing a word and a k
    that is not a multiple of the 32-bit word width."""
    ec, g, ea = setup
    roots = [common.select_random_source(ec, seed=s) for s in (1, 2, 3, 5, 8)]
    roots.append(roots[0])                       # duplicate root, same word
    got = np.asarray(bfs.vgl_msbfs(g, roots).values)
    assert got.shape[0] == len(roots)
    for i, src in enumerate(roots):
        want = bfs.seq_top_down(ec, src)
        row = vgl.as_original_numpy(
            bfs.VertexArray(values=got[i], direction=bfs.S), g)
        assert verify.verify_results(row, want) == 0, f"root {src}"


def test_msbfs_many_roots_two_words(setup):
    """k=33 forces two word groups through the lax.map path."""
    ec, g, ea = setup
    rng = np.random.default_rng(0)
    roots = [common.select_random_source(ec, seed=int(s))
             for s in rng.integers(0, 1000, 33)]
    got = np.asarray(bfs.vgl_msbfs(g, roots).values)
    assert got.shape[0] == 33
    for i in (0, 16, 31, 32):                    # spot-check across both words
        want = bfs.seq_top_down(ec, roots[i])
        row = vgl.as_original_numpy(
            bfs.VertexArray(values=got[i], direction=bfs.S), g)
        assert verify.verify_results(row, want) == 0


def test_sssp_multi_matches_single(setup_ru):
    """Batched multi-source partial SSSP (one dispatch) == per-source runs."""
    from vectorgraphlibrary.models import sssp as ssspm
    ec, g, ea = setup_ru
    srcs = [common.select_random_source(ec, seed=s) for s in (1, 4, 9)]
    multi = np.asarray(ssspm.vgl_dijkstra_multi(g, ea, srcs).values)
    for i, s in enumerate(srcs):
        single, _ = ssspm.vgl_dijkstra_partial_device(g, ea, s)
        np.testing.assert_allclose(multi[i], np.asarray(single.values),
                                   rtol=1e-6)


def test_cc_hybrid_matches_oracle(setup):
    """Single-chip flood-hybrid CC: oracle partition for the default hub, a
    bad hub, and the multi-hub batch."""
    from vectorgraphlibrary.models import cc as ccm
    ec, g, ea = setup
    want = ccm.seq_cc(ec)
    got, iters = ccm.vgl_cc_hybrid(g)
    assert verify.equal_components(
        vgl.as_original_numpy(got, g), want) == 0
    got_bad, _ = ccm.vgl_cc_hybrid(g, hub=3)
    assert verify.equal_components(
        vgl.as_original_numpy(got_bad, g), want) == 0
    multi = ccm.vgl_cc_hybrid_multi(g, [0, 5, 11])
    for i in range(3):
        row = np.asarray(multi.values[i])[:g.v]
        assert verify.equal_components(row, want) == 0, i


def test_cc_hybrid_flood_nonclosure_is_correct():
    """Regression (ADVICE r4): a component deeper than max_flood must NOT be
    split — an uncapped flood would freeze a strict subset of the hub's
    component at hub_label while the rest hook-mins to a smaller id. Path
    graph of 60 vertices + a separate triangle, max_flood=5."""
    from vectorgraphlibrary.graph.device import import_graph
    from vectorgraphlibrary.io.edges_container import EdgesContainer
    from vectorgraphlibrary.models import cc as ccm
    n = 60
    src = np.concatenate([np.arange(n - 1), [n, n + 1, n + 2]]).astype(np.int32)
    dst = np.concatenate([np.arange(1, n), [n + 1, n + 2, n]]).astype(np.int32)
    ec = EdgesContainer(src, dst, n + 3)
    g = import_graph(ec)
    want = ccm.seq_cc(ec)
    got, _ = ccm.vgl_cc_hybrid(g, hub=n // 2, max_flood=5)
    assert verify.equal_components(
        vgl.as_original_numpy(got, g)[:ec.vertices_count], want) == 0


def test_sssp_partial_equals_all_active(setup_ru):
    ec, g, ea = setup_ru
    src = common.select_random_source(ec, seed=7)
    d1, _ = sssp.vgl_dijkstra_all_active(g, ea, src)
    d2, _ = sssp.vgl_dijkstra_partial_device(g, ea, src)
    np.testing.assert_allclose(vgl.as_original_numpy(d1, g),
                               vgl.as_original_numpy(d2, g), rtol=1e-5)
