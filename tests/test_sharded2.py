"""Round-3 distributed additions: compacted changed-only exchange, sharded
partial-active SSSP, sharded direction-optimizing BFS, distributed GraphSAGE.

All on the 8-device virtual CPU mesh (conftest), pinned against the sequential
oracles — the reference's MPI -check story (SURVEY.md §4.5); the sparse
exchange is additionally pinned exactly equal to the dense policy
(`vgl_compute_api/common/mpi_exchange.hpp:14-53` copy_if deltas vs :78-145
full-array ring must merge to the same array)."""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from vectorgraphlibrary.io import generation
from vectorgraphlibrary.models import common, bfs as bfsm, sssp as ssspm
from vectorgraphlibrary.models import gnn
from vectorgraphlibrary.parallel.shard_build import (import_sharded,
                                                         shard_edge_values)
from vectorgraphlibrary.parallel import sharded, collectives as C
from vectorgraphlibrary.parallel.mesh import make_mesh, EDGE_AXIS
from vectorgraphlibrary.utils import verify


@pytest.fixture(scope="module")
def setup():
    ec = generation.rmat(scale=10, avg_degree=8, seed=7, weighted=True)
    hosts = []
    sg = import_sharded(ec, 8, _host_out=hosts)
    mesh = make_mesh(8, 1)
    return ec, sg, hosts, mesh


# ---------------------------------------------------------------------------
# merge_changed_sparse == merge_changed (dense), all policies + overflow
# ---------------------------------------------------------------------------

def _run_exchange(mesh, fn, xs, prev):
    body = jax.shard_map(fn, mesh=mesh, in_specs=(P(EDGE_AXIS), P()),
                         out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(body)(xs, prev))


@pytest.mark.parametrize("op", ["min", "max", "add", "or"])
def test_sparse_exchange_matches_dense(op):
    mesh = make_mesh(8, 1)
    rng = np.random.default_rng(3)
    n = 1024
    if op == "or":
        prev = jnp.asarray(rng.random(n) < 0.1)
        xs_np = np.broadcast_to(np.asarray(prev), (8, n)).copy()
        for d in range(8):
            flips = rng.integers(0, n, 5)
            xs_np[d, flips] = True
        xs = jnp.asarray(xs_np)
    else:
        prev = jnp.asarray(rng.normal(size=n).astype(np.float32))
        xs_np = np.broadcast_to(np.asarray(prev), (8, n)).copy()
        for d in range(8):                       # ~20 changed entries/device
            idx = rng.integers(0, n, 20)
            xs_np[d, idx] = rng.normal(size=20).astype(np.float32)
        xs = jnp.asarray(xs_np)

    def sparse_fn(x, p):
        return C.merge_changed_sparse(x[0], p, op, capacity=64)

    def dense_fn(x, p):
        return C.merge_changed(x[0], p, op)

    got = _run_exchange(mesh, sparse_fn, xs, prev)
    want = _run_exchange(mesh, dense_fn, xs, prev)
    if op == "add":      # summation order differs (scatter vs psum): fp-tol
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_sparse_exchange_overflow_falls_back_dense():
    """Deltas larger than capacity must still merge correctly (lax.cond picks
    the dense branch)."""
    mesh = make_mesh(8, 1)
    rng = np.random.default_rng(5)
    n = 512
    prev = jnp.asarray(rng.normal(size=n).astype(np.float32))
    xs_np = np.stack([np.minimum(np.asarray(prev),
                                 rng.normal(size=n).astype(np.float32))
                      for _ in range(8)])        # nearly everything changed
    xs = jnp.asarray(xs_np)

    def sparse_fn(x, p):
        return C.merge_changed_sparse(x[0], p, "min", capacity=16)

    got = _run_exchange(mesh, sparse_fn, xs, prev)
    want = np.minimum(np.asarray(prev), xs_np.min(axis=0))
    np.testing.assert_array_equal(got, want)


def test_delta_capacity_policy():
    """The policy clamps capacities past the byte-crossover at realistic D
    (VERDICT r3 weak #8: all_gather moves D*cap, so sparse must stay well
    under the dense allreduce's n)."""
    n = 1 << 20
    # D=8: default request n/64 is already under the n/32 clamp and is kept
    assert C.delta_capacity_policy(n, 8) == n // 64
    # an explicit oversized request is clamped, a small one honored
    assert C.delta_capacity_policy(n, 8, requested=n) == n // 32
    assert C.delta_capacity_policy(n, 8, requested=128) == 128
    # more devices -> tighter cap; floor stands
    assert C.delta_capacity_policy(n, 64) == n // 256
    assert C.delta_capacity_policy(256, 64) == 64


def test_sparse_exchange_tail_delta_d8():
    """D=8, tail-sized per-device deltas (few entries — the SSSP convergence
    tail the sparse branch exists for): policy-capped capacity stays on the
    sparse branch and merges exactly like dense."""
    mesh = make_mesh(8, 1)
    rng = np.random.default_rng(17)
    n = 1 << 14
    cap = C.delta_capacity_policy(n, 8, requested=None)
    assert cap <= n // 32
    prev = jnp.asarray(rng.normal(size=n).astype(np.float32))
    xs_np = np.broadcast_to(np.asarray(prev), (8, n)).copy()
    for d in range(8):                          # 3 changed entries per device
        idx = rng.integers(0, n, 3)
        xs_np[d, idx] = np.asarray(prev)[idx] - 1.0
    xs = jnp.asarray(xs_np)

    def sparse_fn(x, p):
        return C.merge_changed_sparse(x[0], p, "min", capacity=cap)

    got = _run_exchange(mesh, sparse_fn, xs, prev)
    want = np.minimum(np.asarray(prev), xs_np.min(axis=0))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# sharded partial-active SSSP / DO-BFS
# ---------------------------------------------------------------------------

def test_sharded_partial_sssp_matches_oracle(setup):
    ec, sg, hosts, mesh = setup
    src = common.select_random_source(ec, seed=11)
    wst = shard_edge_values(ec.weights, sg, ec, hosts)
    fn = sharded.make_sssp_sharded_partial(sg, mesh, wst, delta_capacity=256)
    got = np.asarray(fn(sg.stacked, wst, jnp.int32(src)))[:sg.v]
    want = ssspm.seq_dijkstra(ec, src)
    assert verify.verify_results(got, want) == 0


def test_sharded_do_bfs_matches_oracle(setup):
    ec, sg, hosts, mesh = setup
    src = common.select_random_source(ec, seed=13)
    fn = sharded.make_bfs_do_sharded(sg, mesh, id_cap=1 << 8,
                                     edge_cap=1 << 12)
    got = np.asarray(fn(sg.stacked, jnp.int32(src)))[:sg.v]
    want = bfsm.seq_top_down(ec, src)
    assert verify.verify_results(got, want) == 0


# ---------------------------------------------------------------------------
# distributed GraphSAGE
# ---------------------------------------------------------------------------

def test_sharded_sage_loss_matches_single_graph(setup):
    ec, sg, hosts, mesh = setup
    from vectorgraphlibrary.graph.device import import_graph
    rng = np.random.default_rng(0)
    v, v_pad, fdim, classes = sg.v, sg.v_pad, 8, 4
    feats = jnp.asarray(rng.normal(size=(v_pad, fdim)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, classes, v_pad).astype(np.int32))
    mask = jnp.asarray(rng.random(v_pad) < 0.3)
    params = gnn.init_sage(jax.random.key(0), fdim, 16, classes)

    loss_fn = sharded.make_sage_loss_sharded(sg, mesh)
    got = float(loss_fn(params, feats, labels, mask))

    # single-graph reference: full-mean aggregation on ORIGINAL ids via oracle
    feats_np = np.asarray(feats)[:v]
    agg1 = gnn.seq_aggregate_mean(ec, feats_np)
    p = params
    h = np.maximum(feats_np @ np.asarray(p.w_self1)
                   + agg1 @ np.asarray(p.w_nbr1) + np.asarray(p.b1), 0.0)
    agg2 = gnn.seq_aggregate_mean(ec, h)
    logits = (h @ np.asarray(p.w_self2) + agg2 @ np.asarray(p.w_nbr2)
              + np.asarray(p.b2))
    logits = logits - logits.max(axis=1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    nll = -logp[np.arange(v), np.asarray(labels)[:v]]
    m = np.asarray(mask)[:v]
    want = float(nll[m].sum() / max(m.sum(), 1))
    assert abs(got - want) < 1e-4, (got, want)


def test_sharded_sage_train_step_learns(setup):
    ec, sg, hosts, mesh = setup
    import optax
    rng = np.random.default_rng(1)
    v_pad, fdim, classes = sg.v_pad, 8, 4
    feats = jnp.asarray(rng.normal(size=(v_pad, fdim)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, classes, v_pad).astype(np.int32))
    mask = jnp.asarray(rng.random(v_pad) < 0.3)
    params = gnn.init_sage(jax.random.key(1), fdim, 16, classes)
    opt = optax.adam(1e-2)
    step = sharded.make_sage_train_step_sharded(sg, mesh, opt)
    state = opt.init(params)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, feats, labels, mask)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]                # it learns


# ---------------------------------------------------------------------------
# r5: distributed MS-BFS + flood-hybrid CC == their single-chip scan twins
# (VERDICT r4 #5 — the kernels carrying the headline numbers get multi-chip
# paths, asserted equal on the 8-device mesh)
# ---------------------------------------------------------------------------

def test_msbfs_sharded_matches_scan(setup):
    ec, sg, hosts, mesh = setup
    rng = np.random.default_rng(11)
    roots = jnp.asarray(np.array(
        [common.select_random_source(ec, seed=int(s))
         for s in rng.integers(0, 1000, 32)], np.int32))
    fn = sharded.make_msbfs_sharded(sg, mesh)
    lv_dist = np.asarray(fn(sg.stacked, roots))
    lv_scan = np.asarray(sharded.msbfs_sharded_scan(sg, roots))
    np.testing.assert_array_equal(lv_dist, lv_scan)
    # and against the sequential oracle for a few packed roots
    for r in (0, 15, 31):
        want = bfsm.seq_top_down(ec, int(roots[r]))
        np.testing.assert_array_equal(
            lv_dist[r, :sg.v].astype(np.int32), want)


def test_cc_hybrid_sharded_matches_scan(setup):
    from vectorgraphlibrary.models import cc as ccm
    ec, sg, hosts, mesh = setup
    outdeg = np.bincount(ec.src_ids, minlength=sg.v)
    fn = sharded.make_cc_hybrid_sharded(sg, mesh)
    want = ccm.seq_cc(ec)
    for hub in (int(np.argmax(outdeg)), 23):
        labels, fl, hk = fn(sg.stacked, jnp.int32(hub))
        got = np.asarray(labels)[:sg.v]
        assert verify.equal_components(got, want) == 0, hub
        l_scan, fl_s, hk_s = sharded.cc_hybrid_sharded_scan(
            sg, jnp.int32(hub))
        np.testing.assert_array_equal(got, np.asarray(l_scan)[:sg.v])
        assert int(fl) == int(fl_s)
