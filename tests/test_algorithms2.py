"""CC / HITS / coloring / SSWP / RW vs oracles."""
import numpy as np
import pytest

import vectorgraphlibrary as vgl
from vectorgraphlibrary.graph.device import import_graph
from vectorgraphlibrary.graph.edges import build_edge_array_from_host
from vectorgraphlibrary.models import cc, hits, coloring, sswp, rw, common
from vectorgraphlibrary.utils import verify


@pytest.fixture(scope="module")
def setup(small_rmat):
    ec = small_rmat.with_random_weights(seed=21)
    host = []
    g = import_graph(ec, _host_out=host)
    ea = build_edge_array_from_host(ec.weights, g, host[0], host[1])
    return ec, g, ea


def test_cc_shiloach_vishkin(setup):
    ec, g, ea = setup
    labels, iters = cc.vgl_shiloach_vishkin(g)
    got = np.asarray(labels.values)[:g.v]
    want = cc.seq_cc(ec)
    assert verify.equal_components(got, want) == 0
    assert iters >= 1


def test_cc_bfs_based():
    # small graph: the BFS-based variant floods one component per host-loop round
    from vectorgraphlibrary.io import generation
    from vectorgraphlibrary.graph.device import import_graph
    ec = generation.rmat(scale=7, avg_degree=4, seed=9)
    g = import_graph(ec)
    labels = cc.vgl_bfs_based(g)
    got = np.asarray(labels.values)[:g.v]
    want = cc.seq_cc(ec)
    assert verify.equal_components(got, want) == 0


def test_hits(setup):
    ec, g, ea = setup
    auth, hub = hits.vgl_hits(g, iterations=15)
    wa, wh = hits.seq_hits(ec, iterations=15)
    assert verify.verify_ranking_results(
        np.asarray(auth.values)[:g.v], wa) == 0
    assert verify.verify_ranking_results(
        np.asarray(hub.values)[:g.v], wh) == 0


def test_coloring(setup):
    ec, g, ea = setup
    colors, rounds = coloring.vgl_coloring(g)
    got = np.asarray(colors.values)[:g.v]
    assert verify.verify_colors(ec, got) == 0
    assert got.min() >= 0
    # sane color count: close to greedy oracle's
    want = coloring.seq_coloring(ec)
    assert got.max() <= max(int(want.max()) * 3, 8)


def test_coloring_high_chromatic_clique():
    """A K-96 clique needs 96 colors > the 64-color window (words=2): the
    saturated-winner escape (max neighbor color + 1) must produce a VALID
    coloring without window retries (the r3 scale-18 fault was the doubled
    retry program's compile blowup)."""
    from vectorgraphlibrary.io.edges_container import EdgesContainer
    from vectorgraphlibrary.graph.device import import_graph
    n = 96
    s, d = np.meshgrid(np.arange(n), np.arange(n))
    keep = s != d
    ec = EdgesContainer(s[keep].astype(np.int32), d[keep].astype(np.int32), n)
    g = import_graph(ec)
    colors, rounds = coloring.vgl_coloring(g)
    got = np.asarray(colors.values)[:n]
    assert verify.verify_colors(ec, got) == 0
    assert got.min() >= 0
    assert len(np.unique(got)) == n          # clique: all colors distinct
    assert got.max() >= 64                   # the escape actually fired


def test_sswp(setup):
    ec, g, ea = setup
    src = common.select_random_source(ec, seed=31)
    caps, _ = sswp.vgl_widest_paths(g, ea, src)
    got = vgl.as_original_numpy(caps, g)
    want = sswp.seq_widest_paths(ec, src)
    assert verify.verify_results(got, want) == 0


def test_random_walk(setup):
    ec, g, ea = setup
    src = common.select_random_source(ec, seed=41)
    walkers = np.full(64, src, np.int64)
    finals = rw.vgl_random_walk(g, walkers, walk_length=4, seed=7)
    ok = rw.seq_random_walk_reachable(ec, src, walk_length=4)
    assert ok[finals].all()


def test_random_walk_paths(setup):
    """store_walk_paths: every consecutive path pair must be a real edge (or a
    stopped walker on a zero-outdegree vertex)."""
    ec, g, ea = setup
    src = common.select_random_source(ec, seed=43)
    walkers = np.full(16, src, np.int64)
    finals, paths = rw.vgl_random_walk(g, walkers, walk_length=4, seed=9,
                                       store_walk_paths=True)
    assert paths.shape == (16, 5)
    np.testing.assert_array_equal(paths[:, 0], walkers)
    np.testing.assert_array_equal(paths[:, -1], finals)
    edges = set(zip(ec.src_ids.tolist(), ec.dst_ids.tolist()))
    outdeg = np.bincount(ec.src_ids, minlength=ec.vertices_count)
    for p in paths:
        for a, b in zip(p[:-1], p[1:]):
            assert (int(a), int(b)) in edges or (outdeg[a] == 0 and a == b)


def test_coloring_core_extraction(setup):
    """r5 core path: host-colored dense core + device periphery rounds must
    stay valid and use FEWER rounds than the pure-JP path."""
    ec, g, ea = setup
    c_plain, r_plain = coloring.vgl_coloring(g)
    c_core, r_core = coloring.vgl_coloring(g, ec=ec, core_threshold=16)
    got = np.asarray(c_core.values)[:g.v]
    assert verify.verify_colors(ec, got) == 0
    assert got.min() >= 0
    assert r_core <= r_plain
    init = coloring.host_core_colors(ec, 16)
    core = init >= 0
    assert core.any()                      # threshold actually bites
    np.testing.assert_array_equal(got[core], init[core])   # core kept fixed
