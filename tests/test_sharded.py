"""Sharded flagship container (ShardedTileGraph): correctness on the 8-device
virtual CPU mesh (shard_map path) and the single-chip sequential path (scan).

The sharded graph runs the SAME tiled advance per shard; these tests pin
per-algorithm equality with the sequential oracles, matching the reference's
MPI -check story (SURVEY.md §4.5)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vectorgraphlibrary.io import generation
from vectorgraphlibrary.models import common, pr as prm, bfs as bfsm, \
    sssp as ssspm, cc as ccm, hits as hitsm
from vectorgraphlibrary.parallel.shard_build import (import_sharded,
                                                         shard_edge_values)
from vectorgraphlibrary.parallel import sharded
from vectorgraphlibrary.parallel.mesh import make_mesh
from vectorgraphlibrary.utils import verify


@pytest.fixture(scope="module")
def setup():
    ec = generation.rmat(scale=10, avg_degree=8, seed=3, weighted=True)
    hosts = []
    sg = import_sharded(ec, 8, _host_out=hosts)
    mesh = make_mesh(8, 1)
    return ec, sg, hosts, mesh


def test_stacked_static_shapes(setup):
    ec, sg, hosts, mesh = setup
    # every array leaf carries the shard dim; static metadata unified
    leaves = jax.tree.leaves(sg.stacked)
    assert all(l.shape[0] == 8 for l in leaves)
    assert int(sg.edges_per_shard.sum()) == ec.edges_count
    # per-shard view reconstructs a usable graph
    g0 = sg.shard(0)
    assert g0.v == ec.vertices_count


def test_sharded_pagerank_matches_oracle(setup):
    ec, sg, hosts, mesh = setup
    run = sharded.make_pr_sharded(sg, mesh, ec, max_iterations=30)
    got = np.asarray(run())[:sg.v]
    want = prm.seq_page_rank(ec, max_iterations=30, use_convergence=False)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_pagerank_scan_matches_oracle(setup):
    ec, sg, hosts, mesh = setup
    got = np.asarray(sharded.pagerank_sharded_scan(
        sg, ec, max_iterations=30))[:sg.v]
    want = prm.seq_page_rank(ec, max_iterations=30, use_convergence=False)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_bfs_matches_oracle(setup):
    ec, sg, hosts, mesh = setup
    src = common.select_random_source(ec, seed=1)
    fn = sharded.make_bfs_sharded(sg, mesh)
    got = np.asarray(fn(sg.stacked, jnp.int32(src)))[:sg.v]
    want = bfsm.seq_top_down(ec, src)
    assert verify.verify_results(got, want) == 0


def test_sharded_sssp_matches_oracle(setup):
    ec, sg, hosts, mesh = setup
    src = common.select_random_source(ec, seed=5)
    wst = shard_edge_values(ec.weights, sg, ec, hosts)
    fn = sharded.make_sssp_sharded(sg, mesh, wst)
    got = np.asarray(fn(sg.stacked, wst, jnp.int32(src)))[:sg.v]
    want = ssspm.seq_dijkstra(ec, src)
    assert verify.verify_results(got, want) == 0


def test_sharded_cc_matches_oracle(setup):
    ec, sg, hosts, mesh = setup
    fn = sharded.make_cc_sharded(sg, mesh)
    got = np.asarray(fn(sg.stacked))[:sg.v]
    want = ccm.seq_cc(ec)
    assert verify.equal_components(got, want) == 0


def test_sharded_hits_matches_oracle(setup):
    ec, sg, hosts, mesh = setup
    fn = sharded.make_hits_sharded(sg, mesh, iterations=15)
    auth, hub = fn(sg.stacked)
    wa, wh = hitsm.seq_hits(ec, iterations=15)
    np.testing.assert_allclose(np.asarray(auth)[:sg.v], wa, atol=1e-4)
    np.testing.assert_allclose(np.asarray(hub)[:sg.v], wh, atol=1e-4)


def test_sharded_coloring_valid(setup):
    """Distributed Jones-Plassmann: no vertex shares a color with an
    undirected neighbor, everything colored (verify_colors contract)."""
    ec, sg, hosts, mesh = setup
    fn = sharded.make_coloring_sharded(sg, mesh, words=4)
    colors = np.asarray(fn(sg.stacked))[:sg.v]
    assert (colors >= 0).all()
    s, d = ec.src_ids, ec.dst_ids
    nonloop = s != d
    assert (colors[s[nonloop]] != colors[d[nonloop]]).all()


def test_sharded_nonuniform_shard_count():
    """Shard count that doesn't divide v, graph with hubs in one shard only."""
    ec = generation.rmat(scale=9, avg_degree=6, seed=11)
    sg = import_sharded(ec, 3)
    mesh = make_mesh(3, 1, jax.devices()[:3])
    run = sharded.make_pr_sharded(sg, mesh, ec, max_iterations=20)
    got = np.asarray(run())[:sg.v]
    want = prm.seq_page_rank(ec, max_iterations=20, use_convergence=False)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.fixture(scope="module")
def two_shard_setup():
    ec = generation.rmat(scale=10, avg_degree=8, seed=5, weighted=False)
    sg = import_sharded(ec, 2)
    return ec, sg


def test_scan_pagerank_matches_oracle(two_shard_setup):
    # sequential-shard (lax.scan) PageRank on one device
    ec, sg = two_shard_setup
    got = np.asarray(sharded.pagerank_sharded_scan(
        sg, ec, max_iterations=25))[:sg.v]
    want = prm.seq_page_rank(ec, max_iterations=25, use_convergence=False)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_scan_hits_matches_oracle(two_shard_setup):
    ec, sg = two_shard_setup
    auth, hub = sharded.hits_sharded_scan(sg, 10)
    wa, wh = hitsm.seq_hits(ec, iterations=10)
    np.testing.assert_allclose(np.asarray(auth)[:sg.v], wa, atol=1e-5)
    np.testing.assert_allclose(np.asarray(hub)[:sg.v], wh, atol=1e-5)


def test_scan_bfs_matches_oracle(two_shard_setup):
    ec, sg = two_shard_setup
    src = common.select_random_source(ec, seed=2)
    got = np.asarray(sharded.bfs_sharded_scan(sg, jnp.int32(src)))[:sg.v]
    want = bfsm.seq_top_down(ec, src)
    np.testing.assert_array_equal(got, want)


def test_scan_cc_matches_oracle(two_shard_setup):
    ec, sg = two_shard_setup
    labels, iters = sharded.cc_sharded_scan(sg)
    got = np.asarray(labels)[:sg.v]
    want = ccm.seq_cc(ec)
    assert verify.equal_components(got, want) == 0
    assert int(iters) >= 2


def test_scan_msbfs_matches_oracle(two_shard_setup):
    """Bit-parallel MS-BFS over sequential shards: every packed root's
    levels equal the sequential oracle."""
    ec, sg = two_shard_setup
    rng = np.random.default_rng(9)
    roots_np = np.array([common.select_random_source(ec, seed=int(s))
                         for s in rng.integers(0, 1000, 32)], np.int32)
    lv = np.asarray(sharded.msbfs_sharded_scan(sg, jnp.asarray(roots_np)))
    assert lv.shape == (32, sg.v_pad)
    for r in (0, 7, 31):
        want = bfsm.seq_top_down(ec, int(roots_np[r]))
        np.testing.assert_array_equal(lv[r, :sg.v].astype(np.int32), want)


def test_scan_cc_hybrid_matches_oracle(two_shard_setup):
    """Flood-hybrid CC equals the oracle partition for a good hub AND for a
    deliberately bad hub (an arbitrary vertex — correctness must not depend
    on the hub landing in the largest component)."""
    ec, sg = two_shard_setup
    want = ccm.seq_cc(ec)
    outdeg = np.bincount(ec.src_ids, minlength=sg.v)
    for hub in (int(np.argmax(outdeg)), 17):
        labels, fl, hi = sharded.cc_hybrid_sharded_scan(sg, jnp.int32(hub))
        got = np.asarray(labels)[:sg.v]
        assert verify.equal_components(got, want) == 0, hub
        assert int(fl) >= 1


def test_sharded_persistence_roundtrip(tmp_path, two_shard_setup):
    from vectorgraphlibrary.graph import persistence
    ec, sg = two_shard_setup
    prefix = str(tmp_path / "sgraph")
    persistence.save_sharded_graph(sg, prefix)
    sg2 = persistence.load_sharded_graph(prefix)
    assert sg2.n_shards == sg.n_shards and sg2.e == sg.e
    got = np.asarray(sharded.pagerank_sharded_scan(
        sg2, ec, max_iterations=25))[:sg2.v]
    want = prm.seq_page_rank(ec, max_iterations=25, use_convergence=False)
    np.testing.assert_allclose(got, want, atol=1e-6)
