"""Checks that need an NVIDIA GPU. They skip elsewhere; chip_smoke.py runs them
in its own process on the card (`python chip_smoke.py`)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vectorgraphlibrary.config import GraphFormat, TraversalDirection
from vectorgraphlibrary.graph.device import import_graph
from vectorgraphlibrary.io import generation
from vectorgraphlibrary.models import bfs, cc, common, gnn
from vectorgraphlibrary.ops.advance import advance_pull_value
from vectorgraphlibrary.runtime.perf_stats import hbm_peak_gbps
from vectorgraphlibrary.utils import verify

G, O = TraversalDirection.GATHER, TraversalDirection.ORIGINAL


@pytest.mark.gpu
def test_card_has_a_roofline_peak(gpu):
    assert hbm_peak_gbps(jax.devices()[0].device_kind) is not None


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [GraphFormat.TILE_CSR, GraphFormat.CSR],
                         ids=lambda f: f.value)
def test_pulls_on_card_match_numpy(gpu, fmt):
    """add within f32 tolerance (GPU sums have no fixed order); min and or
    exact and identical run to run."""
    ec = generation.rmat(scale=12, avg_degree=16, seed=9, weighted=False)
    g = import_graph(ec, graph_format=fmt)
    rng = np.random.default_rng(0)
    v = g.v
    x = np.zeros(g.v_pad, np.float32)
    x[:v] = rng.random(v)
    x_g = common.to_direction(g, jnp.asarray(x), O, G)
    s, d = ec.src_ids, ec.dst_ids

    def pull(combine, vec):
        out = advance_pull_value(g, vec, combine, direction=G)
        return np.asarray(common.to_direction(g, out, G, O))[:v]

    want = np.bincount(d, weights=x[s], minlength=v)
    np.testing.assert_allclose(pull("add", x_g), want, rtol=1e-5, atol=1e-4)
    want_min = np.full(v, np.inf, np.float32)
    np.minimum.at(want_min, d, x[s])
    got_min = pull("min", x_g)
    np.testing.assert_array_equal(got_min, want_min)
    np.testing.assert_array_equal(got_min, pull("min", x_g))
    front = jnp.asarray(x > 0.9)
    front_g = common.to_direction(g, front, O, G)
    want_or = np.bincount(d, weights=(x > 0.9)[s], minlength=v) > 0
    np.testing.assert_array_equal(pull("or", front_g), want_or)


@pytest.mark.gpu
def test_bfs_cc_exact_on_card(gpu):
    ec = generation.rmat(scale=12, avg_degree=16, seed=4, weighted=False)
    g = import_graph(ec)
    src = common.select_random_source(ec, seed=1)
    levels = bfs.vgl_bfs_device(g, src)
    from vectorgraphlibrary.graph.vertices import as_original_numpy
    assert verify.verify_results(as_original_numpy(levels, g),
                                 bfs.seq_top_down(ec, src)) == 0
    labels, _ = cc.vgl_shiloach_vishkin(g)
    assert verify.equal_components(as_original_numpy(labels, g),
                                   cc.seq_cc(ec)) == 0


@pytest.mark.gpu
def test_sage_aggregate_on_card(gpu):
    """The aggregation sums ask for HIGHEST precision: no TF32 rounding."""
    ec = generation.rmat(scale=10, avg_degree=8, seed=2, weighted=False)
    g = import_graph(ec)
    rng = np.random.default_rng(1)
    feats_o = rng.standard_normal((ec.vertices_count, 32)).astype(np.float32)
    feats = np.zeros((g.v_pad, 32), np.float32)
    feats[:g.v] = feats_o
    feats_g = jnp.take(jnp.asarray(feats), g.incoming.sorted_to_orig, axis=0,
                       mode="clip")
    out = gnn.aggregate_mean(g, feats_g)
    got = np.asarray(jnp.take(out, g.incoming.orig_to_sorted, axis=0,
                              mode="clip"))[:g.v]
    np.testing.assert_allclose(got, gnn.seq_aggregate_mean(ec, feats_o),
                               rtol=1e-5, atol=1e-5)
