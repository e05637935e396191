"""advance_pull_value — the pull every hot algorithm runs — against a NumPy
oracle over the COO edge list, for every combine, direction, weight op and
self-loop mode; the same pull through every storage format; and the general
advance_pull (several source arrays, destination arrays, edge values, an
active mask) against the oracle in every format."""
import numpy as np
import pytest
import jax.numpy as jnp

from vectorgraphlibrary.config import GraphFormat, TraversalDirection
from vectorgraphlibrary.graph.device import import_graph
from vectorgraphlibrary.graph.edges import build_edge_array_from_host
from vectorgraphlibrary.io.edges_container import EdgesContainer
from vectorgraphlibrary.models import common
from vectorgraphlibrary.ops.advance import advance_pull, advance_pull_value

S, G, O = (TraversalDirection.SCATTER, TraversalDirection.GATHER,
           TraversalDirection.ORIGINAL)
V = 300


def _coo(weights_int: bool):
    """Random multigraph with self-loops and one hub above the huge-row
    threshold (both directions), so every tile class is exercised."""
    rng = np.random.default_rng(11)
    e = 3000
    src = rng.integers(0, V, e)
    dst = rng.integers(0, V, e)
    hub_in = rng.integers(0, V, 400)
    hub_out = rng.integers(0, V, 400)
    loops = rng.integers(0, V, 40)
    src = np.concatenate([src, hub_in, np.zeros(400, np.int64), loops])
    dst = np.concatenate([dst, np.zeros(400, np.int64), hub_out, loops])
    n = len(src)
    w = (rng.integers(1, 50, n).astype(np.int32) if weights_int
         else rng.uniform(0.5, 2.0, n).astype(np.float32))
    return EdgesContainer(src.astype(np.int32), dst.astype(np.int32), V, w)


def _prepared(fmt, weights_int):
    ec = _coo(weights_int)
    host = []
    g = import_graph(ec, graph_format=fmt, _host_out=host)
    # the container stores float weights; int bitmask pulls get int values
    vals = ec.weights.astype(np.int32 if weights_int else np.float32)
    ea = build_edge_array_from_host(vals, g, host[0], host[1])
    return ec, g, ea


_CACHE = {}


def prepared(fmt=GraphFormat.TILE_CSR, weights_int=False):
    key = (fmt, weights_int)
    if key not in _CACHE:
        _CACHE[key] = _prepared(fmt, weights_int)
    return _CACHE[key]


_WOPS = {None: lambda x, w: x, "add": lambda x, w: x + w,
         "min": np.minimum}
_COMBINE = {"add": np.add, "min": np.minimum, "max": np.maximum,
            "or": np.bitwise_or}


def _identity(combine, dtype):
    if combine in ("add", "or"):
        return np.zeros((), dtype)
    big = (np.inf if np.issubdtype(dtype, np.floating)
           else np.iinfo(dtype).max)
    return np.array(big if combine == "min" else -big, dtype)


def oracle(ec, x_o, combine, direction, weight_op, exclude_self_loops):
    """Per-vertex combine of per-edge messages, in ORIGINAL ids. GATHER
    pulls over in-edges (message from the source), SCATTER over out-edges
    (message from the destination)."""
    src, dst = ec.src_ids, ec.dst_ids
    w = ec.weights.astype(x_o.dtype)
    tail, head = (src, dst) if direction == G else (dst, src)
    keep = (src != dst) if exclude_self_loops else np.ones(len(src), bool)
    msg = _WOPS[weight_op](x_o[tail], w).astype(x_o.dtype)
    out = np.full(V, _identity(combine, x_o.dtype))
    _COMBINE[combine].at(out, head[keep], msg[keep])
    return out


def _values(combine, rng):
    if combine == "or":
        return rng.integers(0, 2**20, V).astype(np.int32)
    return rng.uniform(-3.0, 3.0, V).astype(np.float32)


def _run(g, ea, x_o, combine, direction, weight_op, exclude_self_loops):
    x_pad = np.zeros(g.v_pad, x_o.dtype)
    x_pad[:V] = x_o
    x_d = common.to_direction(g, jnp.asarray(x_pad), O, direction)
    out = advance_pull_value(
        g, x_d, combine,
        edge_values=None if weight_op is None else ea.direction(direction),
        weight_op=weight_op, exclude_self_loops=exclude_self_loops,
        direction=direction)
    return np.asarray(common.to_direction(g, out, direction, O))[:V]


def _check(got, want, combine):
    if combine == "add":
        # f32 sums in another order than NumPy's
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exclude_self_loops", [False, True])
@pytest.mark.parametrize("weight_op", [None, "add", "min"])
@pytest.mark.parametrize("direction", [G, S], ids=["gather", "scatter"])
@pytest.mark.parametrize("combine", ["add", "min", "max", "or"])
def test_pull_value_matches_oracle(combine, direction, weight_op,
                                   exclude_self_loops):
    ec, g, ea = prepared(weights_int=combine == "or")
    x_o = _values(combine, np.random.default_rng(5))
    got = _run(g, ea, x_o, combine, direction, weight_op, exclude_self_loops)
    want = oracle(ec, x_o, combine, direction, weight_op, exclude_self_loops)
    _check(got, want, combine)


@pytest.mark.parametrize("combine", ["add", "min", "max", "or"])
@pytest.mark.parametrize("fmt", [GraphFormat.CSR, GraphFormat.EDGES_LIST,
                                 GraphFormat.CSR_VG],
                         ids=lambda f: f.value)
def test_formats_agree_with_tile_csr(fmt, combine):
    """TILE_CSR (tiles + huge rows), CSR (sorted segment reduce), EL
    (scatter-combine) and CSR_VG give the same pull: weighted for the value
    combines, bool reachability for "or" (BFS bottom-up; EL's scatter has no
    int bitwise-or)."""
    _, g_t, ea_t = prepared(GraphFormat.TILE_CSR)
    _, g_f, ea_f = prepared(fmt)
    rng = np.random.default_rng(6)
    if combine == "or":
        x_o, wop = rng.random(V) < 0.2, None
    else:
        x_o, wop = _values(combine, rng), "add"
    want = _run(g_t, ea_t, x_o, combine, G, wop, True)
    got = _run(g_f, ea_f, x_o, combine, G, wop, True)
    _check(got, want, combine)


def test_pull_value_src_active_and_source_order():
    """src_active drops inactive sources exactly; src_in_src_order takes
    the source side's ordering (SCATTER for a GATHER pull)."""
    ec, g, ea = prepared()
    rng = np.random.default_rng(7)
    x_o = _values("min", rng)
    act_o = rng.random(V) < 0.3
    x_pad = np.zeros(g.v_pad, np.float32)
    x_pad[:V] = x_o
    a_pad = np.zeros(g.v_pad, bool)
    a_pad[:V] = act_o
    x_s = common.to_direction(g, jnp.asarray(x_pad), O, S)
    a_s = common.to_direction(g, jnp.asarray(a_pad), O, S)
    out = advance_pull_value(g, x_s, "min", edge_values=ea.incoming,
                             weight_op="add", src_active=a_s, direction=G,
                             src_in_src_order=True)
    got = np.asarray(common.to_direction(g, out, G, O))[:V]
    masked = np.where(act_o, x_o, np.inf).astype(np.float32)
    want = oracle(ec, masked, "min", G, "add", False)
    np.testing.assert_array_equal(got, want)


_FORMATS = [GraphFormat.TILE_CSR, GraphFormat.CSR, GraphFormat.EDGES_LIST,
            GraphFormat.CSR_VG]


@pytest.mark.parametrize("direction", [G, S], ids=["gather", "scatter"])
@pytest.mark.parametrize("case", ["weights_src_active", "dst_arrays"])
@pytest.mark.parametrize("fmt", _FORMATS, ids=lambda f: f.value)
def test_advance_pull_matches_oracle(fmt, case, direction):
    """The general edge-op form: a min of source value + edge weight over
    active sources only, and a sum of a * b over sources plus a destination
    value c per edge."""
    ec, g, ea = prepared(fmt)
    rng = np.random.default_rng(8)
    tail, head = ((ec.src_ids, ec.dst_ids) if direction == G
                  else (ec.dst_ids, ec.src_ids))

    def dev(a_o):
        pad = np.zeros(g.v_pad, a_o.dtype)
        pad[:V] = a_o
        return common.to_direction(g, jnp.asarray(pad), O, direction)

    if case == "weights_src_active":
        d_o = rng.uniform(0.0, 10.0, V).astype(np.float32)
        act_o = rng.random(V) < 0.4
        out = advance_pull(g, {"d": dev(d_o)}, lambda s, d, w: s["d"] + w,
                           "min", edge_values=ea.direction(direction),
                           src_active=dev(act_o), direction=direction)
        keep = act_o[tail]
        msg = (d_o[tail] + ec.weights).astype(np.float32)
        want = np.full(V, np.inf, np.float32)
        np.minimum.at(want, head[keep], msg[keep])
        exact = True
    else:
        a_o = rng.standard_normal(V).astype(np.float32)
        b_o = rng.uniform(1.0, 2.0, V).astype(np.float32)
        c_o = rng.standard_normal(V).astype(np.float32)
        out = advance_pull(g, {"a": dev(a_o), "b": dev(b_o)},
                           lambda s, d, w: s["a"] * s["b"] + d["c"], "add",
                           dst_arrays={"c": dev(c_o)}, direction=direction)
        msg = a_o[tail] * b_o[tail] + c_o[head]
        want = np.zeros(V, np.float32)
        np.add.at(want, head, msg)
        exact = False
    got = np.asarray(common.to_direction(g, out, direction, O))[:V]
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        # f32 sums in another order than NumPy's
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
