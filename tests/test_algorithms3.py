"""SCC / TC / LP / MF / GNN vs oracles."""
import numpy as np
import jax.numpy as jnp
import pytest

import vectorgraphlibrary as vgl
from vectorgraphlibrary.io import generation
from vectorgraphlibrary.graph.device import import_graph
from vectorgraphlibrary.models import scc, tc, lp, mf, gnn, common
from vectorgraphlibrary.utils import verify


@pytest.fixture(scope="module")
def tiny():
    ec = generation.rmat(scale=7, avg_degree=4, seed=17)
    g = import_graph(ec)
    return ec, g


@pytest.fixture(scope="module")
def small(small_rmat):
    ec = small_rmat
    g = import_graph(ec)
    return ec, g


def test_scc_forward_backward(tiny):
    ec, g = tiny
    labels = scc.vgl_forward_backward(g)
    got = np.asarray(labels.values)[:g.v]
    want = scc.seq_scc(ec)
    assert verify.equal_components(got, want) == 0


def test_transitive_closure_purdoms(tiny):
    ec, g = tiny
    sources = np.asarray([1, 5, 9])
    got = tc.reachability(ec, g, sources)
    want = tc.seq_reachability(ec, sources)
    assert np.array_equal(got, want)


def test_transitive_closure_bfs_based(tiny):
    ec, g = tiny
    sources = np.asarray([2, 7])
    got = tc.vgl_bfs_based_reachability(g, sources)
    want = tc.seq_reachability(ec, sources)
    assert np.array_equal(got, want)


def test_triangle_count(tiny):
    ec, g = tiny
    n = tc.vgl_triangle_count(ec)
    assert n == tc.seq_triangle_count(ec)
    assert n > 0


@pytest.mark.parametrize("scale,deg", [(10, 8), (12, 6)])
def test_triangle_count_scales(scale, deg):
    ec = generation.rmat(scale=scale, avg_degree=deg, seed=scale)
    assert tc.vgl_triangle_count(ec) == tc.seq_triangle_count(ec)


def test_triangle_count_multiblock(small_rmat):
    """Column-blocked bitmap path: force several blocks."""
    ec = small_rmat
    want = tc.seq_triangle_count(ec)
    assert tc.vgl_triangle_count(ec, block_bits=256) == want
    assert tc.vgl_triangle_count(ec) == want


def test_label_propagation(tiny):
    ec, g = tiny
    labels, iters = lp.vgl_label_propagation(g, max_iterations=4)
    got = np.asarray(labels.values)[:g.v]
    want = lp.seq_label_propagation(ec, max_iterations=4)
    mismatches = int((got != want).sum())
    assert mismatches == 0, mismatches


def test_label_propagation_hub_graph(small):
    """Exact mode on HUGE rows: the scale-10 fixture has hub vertices past the
    huge-degree threshold, exercising the multi-chunk sorted-run path."""
    ec, g = small
    assert g.incoming.huge is not None and g.incoming.huge.n_rows > 0
    labels, iters = lp.vgl_label_propagation(g, max_iterations=3)
    got = np.asarray(labels.values)[:g.v]
    want = lp.seq_label_propagation(ec, max_iterations=3)
    mismatches = int((got != want).sum())
    assert mismatches == 0, mismatches


def test_max_flow(tiny):
    ec0, _ = tiny
    dedup = ec0.remove_self_loops_and_duplicates()
    rng = np.random.default_rng(3)
    ec = vgl.EdgesContainer(dedup.src_ids, dedup.dst_ids, dedup.vertices_count,
                            rng.integers(1, 20, dedup.edges_count).astype(
                                np.float32))
    g = import_graph(ec)
    deg = np.bincount(ec.src_ids, minlength=ec.vertices_count)
    src = int(np.argmax(deg))
    indeg = np.bincount(ec.dst_ids, minlength=ec.vertices_count)
    sink = int(np.argsort(-indeg)[1])
    if sink == src:
        sink = int(np.argsort(-indeg)[2])
    got = mf.vgl_ford_fulkerson(ec, g, src, sink)
    want = mf.seq_ford_fulkerson(ec, src, sink)
    assert abs(got - want) < 1e-6, (got, want)


def test_max_flow_scale12():
    """Device Edmonds-Karp at scale 12 (VERDICT #8 'finishes in seconds'):
    whole algorithm is one jit — BFS, path walk, residual updates on device."""
    ec = generation.rmat(scale=12, avg_degree=8, seed=5)
    rng = np.random.default_rng(9)
    ec = ec.__class__(ec.src_ids, ec.dst_ids, ec.vertices_count,
                      weights=rng.integers(1, 16, ec.edges_count)
                      .astype(np.float32))
    src = common.select_random_source(ec, seed=2)
    sinks = np.flatnonzero(np.bincount(ec.dst_ids,
                                       minlength=ec.vertices_count))
    sink = int(sinks[-1]) if sinks[-1] != src else int(sinks[-2])
    got = mf.vgl_ford_fulkerson(ec, None, src, sink)
    want = mf.seq_ford_fulkerson(ec, src, sink)
    assert got == want, (got, want)


def test_gnn_aggregate_mean(small):
    ec, g = small
    rng = np.random.default_rng(5)
    f = 16
    feats_o = rng.random((g.v, f)).astype(np.float32)
    feats_g = np.zeros((g.v_pad, f), np.float32)
    s2o = np.asarray(g.incoming.sorted_to_orig)[:g.v]
    feats_g[:g.v] = feats_o[s2o]
    out = gnn.aggregate_mean(g, jnp.asarray(feats_g))
    got = np.asarray(out)[:g.v]
    # back to original ordering
    o2s = np.asarray(g.incoming.orig_to_sorted)[:g.v]
    got_o = got[o2s]
    want = gnn.seq_aggregate_mean(ec, feats_o)
    np.testing.assert_allclose(got_o, want, rtol=2e-4, atol=1e-5)


def test_gnn_train_step_decreases_loss(tiny):
    ec, g = tiny
    import jax
    import optax
    rng = jax.random.PRNGKey(0)
    f, h, c = 8, 16, 3
    feats = jax.random.normal(rng, (g.v_pad, f))
    labels = jax.random.randint(jax.random.PRNGKey(1), (g.v_pad,), 0, c)
    mask = jnp.arange(g.v_pad) < g.v
    params = gnn.init_sage(jax.random.PRNGKey(2), f, h, c)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    step = gnn.make_train_step(g, opt)
    s1 = gnn.sample_neighbors(g, 4, jax.random.PRNGKey(3))
    s2 = gnn.sample_neighbors(g, 4, jax.random.PRNGKey(4))
    losses = []
    for i in range(8):
        params, opt_state, loss = step(params, opt_state, feats, labels, mask,
                                       s1, s2)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_gnn_sampled_shapes(tiny):
    ec, g = tiny
    import jax
    s = gnn.sample_neighbors(g, 5, jax.random.PRNGKey(0))
    assert s.shape == (g.v_pad, 5)
    # sampled ids are real neighbors (spot check on host CSR)
    sn = np.asarray(s)
    dg = g.outgoing
    row_ptr = np.asarray(dg.row_ptr)
    col = np.asarray(dg.col_idx)
    deg = np.asarray(dg.degrees)
    for vtx in range(0, g.v, max(g.v // 17, 1)):
        if deg[vtx] == 0:
            assert (sn[vtx] == vtx).all()
        else:
            nbrs = set(col[row_ptr[vtx]:row_ptr[vtx] + deg[vtx]].tolist())
            assert set(sn[vtx].tolist()) <= nbrs
