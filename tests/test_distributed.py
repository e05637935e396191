"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4 implication:
the 'fake cluster' the reference lacks)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from vectorgraphlibrary.io import generation
from vectorgraphlibrary.parallel import distributed as D
from vectorgraphlibrary.parallel.edge_shard import build_sharded_edge_graph
from vectorgraphlibrary.parallel.mesh import make_mesh, EDGE_AXIS, VERTEX_AXIS
from vectorgraphlibrary.models import pr, sssp, bfs


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    return make_mesh(4, 2, jax.devices()[:8])


@pytest.fixture(scope="module")
def ec():
    return generation.rmat(scale=9, avg_degree=8, seed=23)


def test_distributed_pagerank_matches_oracle(mesh, ec):
    g = build_sharded_edge_graph(ec, mesh)
    step = D.make_pr_step(g, mesh)
    v_sh = NamedSharding(mesh, P(VERTEX_AXIS))
    ranks = jax.device_put(
        jnp.where(jnp.arange(g.v_pad) < g.v, 1.0 / g.v, 0.0).astype(jnp.float32),
        v_sh)
    for _ in range(50):
        # sync each step: the multi-device CPU runtime intermittently aborts when
        # many shard_map collectives are enqueued asynchronously
        ranks = jax.block_until_ready(
            step(g.src, g.dst, g.out_degrees, ranks))
    got = np.asarray(ranks)[:g.v]
    # NOTE: the distributed step excludes self-loop edges but divides by the FULL
    # out-degree; compare against an oracle with the same convention
    v = ec.vertices_count
    outdeg = np.bincount(ec.src_ids, minlength=v).astype(np.float64)
    rev = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    dangling_mask = outdeg == 0
    ranks_o = np.full(v, 1.0 / v)
    nl = ec.src_ids != ec.dst_ids
    for _ in range(50):
        dang = ranks_o[dangling_mask].sum() / v
        acc = np.zeros(v)
        np.add.at(acc, ec.dst_ids[nl], ranks_o[ec.src_ids[nl]] * rev[ec.src_ids[nl]])
        ranks_o = 0.15 / v + 0.85 * (acc + dang)
    np.testing.assert_allclose(got, ranks_o, rtol=1e-3)


def test_distributed_sssp_fixpoint_matches_scipy(mesh, ec):
    ecw = ec.with_random_weights(seed=3)
    g = build_sharded_edge_graph(ecw, mesh)
    step = D.make_sssp_step(g, mesh)
    v_sh = NamedSharding(mesh, P(VERTEX_AXIS))
    from vectorgraphlibrary.models.common import select_random_source
    src = select_random_source(ecw, seed=1)
    dist = jnp.full((g.v_pad,), jnp.inf, jnp.float32).at[src].set(0.0)
    dist = jax.device_put(dist, v_sh)
    prev = None
    for _ in range(200):
        new = step(g.src, g.dst, g.weights, dist)
        if prev is not None and bool(jnp.all(new == dist)):
            break
        prev, dist = dist, new
    got = np.asarray(dist)[:g.v]
    want = sssp.seq_dijkstra(ecw, src)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_distributed_bfs_levels(mesh, ec):
    g = build_sharded_edge_graph(ec, mesh)
    step = D.make_bfs_step(g, mesh)
    v_sh = NamedSharding(mesh, P(VERTEX_AXIS))
    from vectorgraphlibrary.models.common import select_random_source
    src = select_random_source(ec, seed=2)
    INF = jnp.iinfo(jnp.int32).max
    levels = jnp.full((g.v_pad,), INF, jnp.int32).at[src].set(1)
    levels = jax.device_put(levels, v_sh)
    for it in range(1, 64):
        new = step(g.src, g.dst, levels, jnp.int32(it))
        if bool(jnp.all(new == levels)):
            break
        levels = new
    got = np.asarray(levels)[:g.v]
    got = np.where(got == np.iinfo(np.int32).max, -1, got)
    want = bfs.seq_top_down(ec, src)
    np.testing.assert_array_equal(got, want)


def test_collectives_merge_policies(mesh):
    from vectorgraphlibrary.parallel import collectives as C
    n = 64
    xs = np.stack([np.random.default_rng(i).random(n).astype(np.float32)
                   for i in range(4)])
    prev = xs[0].copy()
    f = jax.shard_map(lambda x, p: (C.merge_all(x[0], "min"),
                                    C.merge_changed(x[0], p, "min")),
                      mesh=mesh, in_specs=(P(EDGE_AXIS, None), P(None)),
                      out_specs=(P(None), P(None)))
    a, c = f(jnp.asarray(xs), jnp.asarray(prev))
    np.testing.assert_allclose(np.asarray(a), xs.min(axis=0), rtol=1e-6)
    want_changed = np.minimum(prev, np.where(xs != prev, xs, np.inf).min(axis=0))
    np.testing.assert_allclose(np.asarray(c), want_changed, rtol=1e-6)


def test_collectives_merge_changed_add_and_max(mesh):
    """merge_changed 'add' accumulates per-device DELTAS onto prev; 'max'
    merges only entries that changed (reference mpi_exchange.hpp:146-150)."""
    from vectorgraphlibrary.parallel import collectives as C
    n = 64
    rng = np.random.default_rng(0)
    prev = rng.random(n).astype(np.float32)
    xs = np.stack([prev.copy() for _ in range(4)])
    # each device changes a disjoint slice
    for i in range(4):
        xs[i, i * 16:(i + 1) * 16] += rng.random(16).astype(np.float32)
    f = jax.shard_map(lambda x, p: (C.merge_changed(x[0], p, "add"),
                                    C.merge_changed(x[0], p, "max")),
                      mesh=mesh, in_specs=(P(EDGE_AXIS, None), P(None)),
                      out_specs=(P(None), P(None)))
    got_add, got_max = f(jnp.asarray(xs), jnp.asarray(prev))
    want_add = prev + (xs - prev).sum(axis=0)
    want_max = np.maximum(prev,
                          np.where(xs != prev, xs, -np.inf).max(axis=0))
    np.testing.assert_allclose(np.asarray(got_add), want_add, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got_max), want_max, rtol=1e-6)
