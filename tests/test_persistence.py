"""Binary graph persistence: the whole imported graph — CSR arrays, tiles,
renumber maps — round-trips one .npz and produces identical advance results
(reference save/load_main_content, vect_csr_graph.h:90-92)."""
import numpy as np
import pytest
import jax.numpy as jnp

from vectorgraphlibrary.config import TraversalDirection
from vectorgraphlibrary.graph.device import import_graph
from vectorgraphlibrary.graph.persistence import (
    load_graph_from_binary_file, save_graph_to_binary_file)
from vectorgraphlibrary.io import generation
from vectorgraphlibrary.io.edges_container import EdgesContainer
from vectorgraphlibrary.ops.advance import advance_pull_value

G = TraversalDirection.GATHER


def test_graph_roundtrip_preserves_fused_advance(tmp_path):
    ec = generation.rmat(scale=9, avg_degree=8, seed=21)
    g = import_graph(ec)
    path = str(tmp_path / "g.npz")
    save_graph_to_binary_file(g, path)
    g2 = load_graph_from_binary_file(path)

    assert g2.v == g.v and g2.e == g.e and g2.v_pad == g.v_pad
    assert g2.graph_format == g.graph_format
    import jax
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(g) == jax.tree.structure(g2)

    x = jnp.asarray(np.random.default_rng(0).random(g.v_pad), jnp.float32)
    a = advance_pull_value(g, x, "add", exclude_self_loops=True, direction=G)
    b = advance_pull_value(g2, x, "add", exclude_self_loops=True, direction=G)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_edges_container_roundtrip(tmp_path):
    ec = generation.rmat(scale=8, avg_degree=6, seed=4, weighted=True)
    path = str(tmp_path / "e.el_container")
    ec.save_to_binary_file(path)
    ec2 = EdgesContainer.load_from_binary_file(path)
    np.testing.assert_array_equal(ec2.src_ids, ec.src_ids)
    np.testing.assert_array_equal(ec2.dst_ids, ec.dst_ids)
    np.testing.assert_array_equal(ec2.weights, ec.weights)
    assert ec2.vertices_count == ec.vertices_count
