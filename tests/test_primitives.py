"""The five abstractions vs. NumPy oracles (differential testing, SURVEY.md §4)."""
import numpy as np
import jax.numpy as jnp
import pytest

import vectorgraphlibrary as vgl
from vectorgraphlibrary.config import TraversalDirection
from vectorgraphlibrary.graph import frontier as F
from vectorgraphlibrary.graph.device import import_graph
from vectorgraphlibrary.graph.edges import build_edge_array_from_host


@pytest.fixture(scope="module")
def setup(small_rmat):
    ec = small_rmat.with_random_weights(seed=5)
    host = []
    g = import_graph(ec, _host_out=host)
    ea = build_edge_array_from_host(ec.weights, g, host[0], host[1])
    return ec, g, ea, host


def orig_order(g, vals_sorted, direction):
    """sorted-ordering [v_pad] array -> original-ordering [v] numpy array."""
    arr = vgl.VertexArray(values=vals_sorted, direction=direction)
    return vgl.as_original_numpy(arr, g)


def test_pull_sum_unweighted(setup):
    """sum over incoming neighbors of x[src] == A @ x (SpMV oracle)."""
    ec, g, ea, host = setup
    v = ec.vertices_count
    rng = np.random.default_rng(0)
    x = rng.random(v).astype(np.float32)

    # device input in GATHER ordering
    x_sorted = np.zeros(g.v_pad, np.float32)
    x_sorted[:v] = x[host[1].sorted_to_orig[:v]]
    out = vgl.advance_pull(
        g, {"x": jnp.asarray(x_sorted)},
        lambda s, d, w: s["x"], "add",
        direction=TraversalDirection.GATHER)
    got = orig_order(g, out, TraversalDirection.GATHER)

    want = np.zeros(v, np.float64)
    np.add.at(want, ec.dst_ids, x[ec.src_ids].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_pull_min_weighted(setup):
    """min over incoming of x[src]+w == SSSP relax oracle."""
    ec, g, ea, host = setup
    v = ec.vertices_count
    rng = np.random.default_rng(1)
    x = rng.random(v).astype(np.float32) * 10

    x_sorted = np.full(g.v_pad, np.inf, np.float32)
    x_sorted[:v] = x[host[1].sorted_to_orig[:v]]
    out = vgl.advance_pull(
        g, {"x": jnp.asarray(x_sorted)},
        lambda s, d, w: s["x"] + w, "min",
        edge_values=ea.incoming,
        direction=TraversalDirection.GATHER)
    got = orig_order(g, out, TraversalDirection.GATHER)

    want = np.full(v, np.inf, np.float32)
    np.minimum.at(want, ec.dst_ids, x[ec.src_ids] + ec.weights)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pull_src_active_mask(setup):
    """BFS-style pull: OR of frontier membership over in-neighbors."""
    ec, g, ea, host = setup
    v = ec.vertices_count
    rng = np.random.default_rng(2)
    active_orig = rng.random(v) < 0.1

    act_sorted = np.zeros(g.v_pad, bool)
    act_sorted[:v] = active_orig[host[1].sorted_to_orig[:v]]
    ones = jnp.ones(g.v_pad, bool)
    out = vgl.advance_pull(
        g, {"one": ones}, lambda s, d, w: s["one"], "or",
        src_active=jnp.asarray(act_sorted),
        direction=TraversalDirection.GATHER)
    got = orig_order(g, out, TraversalDirection.GATHER)

    want = np.zeros(v, bool)
    np.logical_or.at(want, ec.dst_ids, active_orig[ec.src_ids])
    assert np.array_equal(got, want)


def test_push_sparse_min(setup):
    """Sparse push relax == oracle restricted to frontier-out edges."""
    ec, g, ea, host = setup
    v = ec.vertices_count
    rng = np.random.default_rng(3)
    active_orig = rng.random(v) < 0.05
    x = rng.random(v).astype(np.float32) * 10

    x_sorted = np.full(g.v_pad, np.inf, np.float32)
    x_sorted[:v] = x[host[0].sorted_to_orig[:v]]
    m_sorted = np.zeros(g.v_pad, bool)
    m_sorted[:v] = active_orig[host[0].sorted_to_orig[:v]]

    fr = F.from_mask(g, jnp.asarray(m_sorted), TraversalDirection.SCATTER)
    cap = 1 << int(np.ceil(np.log2(max(int(fr.size), 2))))
    ids, valid = F.compact_ids(fr, cap)
    ecap = int(np.sum(np.bincount(ec.src_ids, minlength=v)[active_orig]))
    ecap = max(8, 1 << int(np.ceil(np.log2(max(ecap, 2)))))

    out0 = jnp.full(g.v_pad, jnp.inf, jnp.float32)
    out = vgl.advance_push_sparse(
        g, ids, valid, ecap, {"x": jnp.asarray(x_sorted)},
        lambda s, d, w: s["x"] + w, "min", out0,
        edge_values=ea.outgoing, direction=TraversalDirection.SCATTER)
    got = orig_order(g, out, TraversalDirection.SCATTER)

    want = np.full(v, np.inf, np.float32)
    m = active_orig[ec.src_ids]
    np.minimum.at(want, ec.dst_ids[m], x[ec.src_ids[m]] + ec.weights[m])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_compute_reduce_gnf(setup):
    ec, g, ea, host = setup
    v = ec.vertices_count
    arrays = {"x": jnp.zeros(g.v_pad, jnp.float32)}
    arrays = vgl.compute(
        g, arrays,
        lambda ids, degs, arr: {"x": degs.astype(jnp.float32)})
    # reduce sum of out-degrees over all-active == |E|
    total = vgl.reduce(g, arrays["x"], "add")
    assert int(total) == ec.edges_count

    fr = vgl.generate_new_frontier(
        g, lambda ids, degs, arr: arr["x"] >= 4, arrays,
        direction=TraversalDirection.SCATTER)
    deg = np.bincount(ec.src_ids, minlength=v)
    assert int(fr.size) == int(np.sum(deg >= 4))
    assert int(fr.neighbours_count) == int(deg[deg >= 4].sum())


def test_flat_tiles_int_exact_beyond_2p24():
    """group_reduce_flat must be EXACT for int32 values above 2^24 (CC labels
    on big shards) — an f32 matmul alone would round."""
    import jax.numpy as jnp
    from vectorgraphlibrary.ops import tiles as T
    from vectorgraphlibrary.ops import monoid as M
    rng = np.random.default_rng(0)
    width, m = 8, 16                       # 16*128/8 = 256 vertex rows
    rows = m * 128 // width
    labels = rng.integers(2**24, 2**31 - 1, (m, 128)).astype(np.int32)
    red_min = np.asarray(T.group_reduce_flat(jnp.asarray(labels), width,
                                             M.get("min"), rows))
    np.testing.assert_array_equal(red_min,
                                  labels.reshape(-1, width).min(axis=1))
    # add-reduce exactness: values up to 2^24 per slot, 8 slots per row
    slot_vals = rng.integers(0, 2**24, (m, 128)).astype(np.int32)
    red = np.asarray(T.group_reduce_flat(jnp.asarray(slot_vals), width,
                                         M.get("add"), rows))
    want_red = slot_vals.reshape(-1, width).sum(axis=1, dtype=np.int64)
    np.testing.assert_array_equal(red, want_red.astype(np.int32)[:rows])


def test_frontier_compact_roundtrip(setup):
    ec, g, ea, host = setup
    rng = np.random.default_rng(4)
    m = np.zeros(g.v_pad, bool)
    m[:g.v] = rng.random(g.v) < 0.2
    fr = F.from_mask(g, jnp.asarray(m), TraversalDirection.SCATTER)
    ids, valid = F.compact_ids(fr, 1024)
    n = int(fr.size)
    assert np.array_equal(np.asarray(valid)[:n], np.ones(n, bool))
    got = np.sort(np.asarray(ids)[:n])
    want = np.where(m)[0]
    assert np.array_equal(got, want)


def test_vertex_array_reorder_roundtrip(setup):
    ec, g, ea, host = setup
    rng = np.random.default_rng(5)
    x = rng.random(g.v_pad).astype(np.float32)
    arr = vgl.VertexArray(values=jnp.asarray(x),
                          direction=TraversalDirection.ORIGINAL)
    s = vgl.reorder(arr, g, TraversalDirection.SCATTER)
    gt = vgl.reorder(s, g, TraversalDirection.GATHER)
    back = vgl.reorder(gt, g, TraversalDirection.ORIGINAL)
    np.testing.assert_array_equal(np.asarray(back.values)[:g.v], x[:g.v])
