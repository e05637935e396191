"""Real-graph corpus: the bundled zero-egress fallback graph loads, has the
documented shape, and runs an algorithm against its oracle (the reference's
real-graph verification tier, apps/scripts/settings.py:52-86 analog)."""
import numpy as np

from vectorgraphlibrary.io import corpus


def test_bundled_graph_loads():
    name, ec = corpus.bundled_graph("pydeps")
    assert name == "pydeps"
    assert ec is not None
    assert ec.vertices_count == 30107
    assert ec.edges_count == 221730
    # real-world shape: power-law in-degrees with big hubs
    deg = np.bincount(ec.dst_ids, minlength=ec.vertices_count)
    assert deg.max() > 1000
    assert (deg == 0).sum() > 1000


def test_bundled_call_graph_loads():
    """Second, larger bundled real graph: the static function-call network
    (apps/make_call_graph.py)."""
    name, ec = corpus.bundled_graph("pycalls")
    assert name == "pycalls"
    assert ec is not None
    assert ec.vertices_count > 400_000
    assert ec.edges_count > 1_000_000
    deg = np.bincount(ec.dst_ids, minlength=ec.vertices_count)
    assert deg.max() > 10_000            # hub callees (e.g. logging helpers)
    # the default bundled pick is the largest graph
    dname, _ = corpus.bundled_graph()
    assert dname == "pycalls"


def test_bundled_graph_runs_cc():
    _, ec = corpus.bundled_graph()
    from vectorgraphlibrary.graph.device import import_graph
    from vectorgraphlibrary.models import cc
    import vectorgraphlibrary as vgl
    from vectorgraphlibrary.utils import verify
    g = import_graph(ec)
    labels, _ = cc.vgl_shiloach_vishkin(g)
    got = vgl.as_original_numpy(labels, g)
    want = cc.seq_cc(ec)
    assert verify.equal_components(got, want) == 0
