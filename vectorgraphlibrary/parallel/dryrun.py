"""Multi-device dry run: compile + execute one full distributed step on tiny shapes.

Invoked via __graft_entry__.dryrun_multichip(n) with n virtual CPU devices to
validate the multi-card sharding path without real cards."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..io import generation
from .edge_shard import build_sharded_edge_graph
from .mesh import make_mesh, EDGE_AXIS, VERTEX_AXIS
from . import distributed as D


def run_dryrun(n_devices: int) -> None:
    devices = jax.devices()[:n_devices]

    # ---- the flagship path: sharded TILE_CSR (tiled advance per shard,
    # psum/pmin merges), full training-step analog: PR + BFS + SSSP ----
    from .shard_build import import_sharded, shard_edge_values
    from . import sharded
    ec1 = generation.rmat(scale=9, avg_degree=8, seed=1, weighted=True)
    flat_mesh = make_mesh(n_devices, 1, devices)
    hosts = []
    sg = import_sharded(ec1, n_devices, _host_out=hosts)
    run_pr = sharded.make_pr_sharded(sg, flat_mesh, ec1, max_iterations=5)
    ranks = run_pr()
    assert ranks.shape == (sg.v_pad,)
    s = float(jnp.sum(ranks))
    assert 0.5 < s < 1.5, s
    bfs_fn = sharded.make_bfs_sharded(sg, flat_mesh)
    levels = bfs_fn(sg.stacked, jnp.int32(0))
    assert int(jnp.sum(levels > 0)) >= 1
    wst = shard_edge_values(ec1.weights, sg, ec1, hosts)
    sssp_fn = sharded.make_sssp_sharded(sg, flat_mesh, wst)
    dist = sssp_fn(sg.stacked, wst, jnp.int32(0))
    assert bool(jnp.isfinite(dist).any())
    # work-efficient variants: partial-active SSSP (compacted-delta exchange)
    # + direction-optimizing BFS (sparse push / dense pull switch)
    sssp_p = sharded.make_sssp_sharded_partial(sg, flat_mesh, wst,
                                               delta_capacity=128)
    dist_p = sssp_p(sg.stacked, wst, jnp.int32(0))
    assert bool(jnp.isfinite(dist_p).any())
    do_bfs = sharded.make_bfs_do_sharded(sg, flat_mesh, id_cap=1 << 8,
                                         edge_cap=1 << 12)
    lv = do_bfs(sg.stacked, jnp.int32(0))
    assert int(jnp.sum(lv > 0)) >= 1
    # the r4 headline kernels, distributed (VERDICT r4 #5): bit-parallel
    # MS-BFS (or-pull + pmax-word merge) and flood-hybrid CC
    msbfs_fn = sharded.make_msbfs_sharded(sg, flat_mesh)
    roots32 = jnp.arange(32, dtype=jnp.int32)
    lv32 = msbfs_fn(sg.stacked, roots32)
    assert lv32.shape == (32, sg.v_pad)
    assert int(jnp.sum(lv32 > 0)) >= 32
    cc_h = sharded.make_cc_hybrid_sharded(sg, flat_mesh)
    cl, cfl, chk = cc_h(sg.stacked, jnp.int32(0))
    assert cl.shape == (sg.v_pad,) and int(cfl) >= 1
    # distributed GraphSAGE train step (BASELINE config 5); optional — the
    # traversal dryrun must not fail on installations without optax
    try:
        import optax
        _HAVE_OPTAX = True
    except ImportError:
        print("dryrun: optax not installed — skipping GraphSAGE step")
        _HAVE_OPTAX = False
    loss = jnp.float32(0.0)
    if _HAVE_OPTAX:
        from ..models import gnn
        rng = np.random.default_rng(0)
        fdim, classes = 4, 3
        feats = jnp.asarray(rng.normal(size=(sg.v_pad, fdim)).astype(
            np.float32))
        labels = jnp.asarray(rng.integers(0, classes, sg.v_pad).astype(
            np.int32))
        tmask = jnp.asarray(rng.random(sg.v_pad) < 0.5)
        params = gnn.init_sage(jax.random.key(0), fdim, 8, classes)
        opt = optax.adam(1e-2)
        gstep = sharded.make_sage_train_step_sharded(sg, flat_mesh, opt)
        params, _, loss = gstep(params, opt.init(params), feats, labels,
                                tmask)
        assert bool(jnp.isfinite(loss))
    jax.block_until_ready((ranks, levels, dist, dist_p, lv, lv32, cl, loss))

    # ---- the 2-D (edge x vertex) COO fallback path ----
    n_v = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices // n_v, n_v, devices)

    ec = generation.rmat(scale=8, avg_degree=8, seed=0)
    g = build_sharded_edge_graph(ec, mesh)
    v_sh = NamedSharding(mesh, P(VERTEX_AXIS))

    # PageRank step
    pr_step = D.make_pr_step(g, mesh)
    ranks = jax.device_put(
        jnp.where(jnp.arange(g.v_pad) < g.v, 1.0 / g.v, 0.0).astype(jnp.float32),
        v_sh)
    ranks = pr_step(g.src, g.dst, g.out_degrees, ranks)
    assert ranks.shape == (g.v_pad,)
    s = float(jnp.sum(ranks))
    assert 0.5 < s < 1.5, s

    # SSSP relax step
    sssp_step = D.make_sssp_step(g, mesh)
    dist = jnp.full((g.v_pad,), jnp.inf, jnp.float32).at[0].set(0.0)
    dist = jax.device_put(dist, v_sh)
    dist = sssp_step(g.src, g.dst, g.weights, dist)
    assert bool(jnp.isfinite(dist).any())

    # BFS expansion step
    bfs_step = D.make_bfs_step(g, mesh)
    INF = jnp.iinfo(jnp.int32).max
    levels = jnp.full((g.v_pad,), INF, jnp.int32).at[0].set(1)
    levels = jax.device_put(levels, v_sh)
    levels = bfs_step(g.src, g.dst, levels, jnp.int32(1))
    assert int(jnp.sum(levels != INF)) >= 1

    jax.block_until_ready((ranks, dist, levels))
