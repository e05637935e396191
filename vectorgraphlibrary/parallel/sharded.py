"""Distributed algorithms over the sharded flagship container (ShardedTileGraph).

Execution model (the reference's MPI story, re-built on XLA collectives):
state lives REPLICATED in ORIGINAL vertex order; each device owns one
destination shard and runs the SAME tiled advance the single-card path runs
(`ops/advance.advance_pull_value`); per-dst partials merge with one psum/pmin
over the shard axis (each destination's in-edges live wholly in its owner
shard, so the "merge" is really a disjoint combine), matching the reference's
advance-slice + exchange (`nec/advance_worker.hpp:239-264`,
`common/mpi_exchange.hpp:193-271`).

Two drivers over the same per-shard kernel:
- `make_*` factories: shard_map over a 1-D device mesh axis "e" — multi-card;
- `*_scan`: lax.scan over the stacked shard axis — one card processes shards
  sequentially, bounding the per-step working set to one shard.

The full iteration loop runs INSIDE the shard_map body (lax.while/fori with
collective-synchronized convergence tests), so multi-card runs have zero host
round-trips per iteration, exactly like the single-card models.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..config import TraversalDirection
from ..models import common
from ..ops.advance import advance_pull_value
from ..ops import monoid as M
from .mesh import EDGE_AXIS
from .shard_build import ShardedTileGraph, take_shard

O, S, G = (TraversalDirection.ORIGINAL, TraversalDirection.SCATTER,
           TraversalDirection.GATHER)
E = EDGE_AXIS


def _shard_pull_original(g, x_o, combine, direction=G, edge_values=None,
                         weight_op=None, exclude_self_loops=False,
                         src_active_o=None):
    """One shard's pull with input/output in ORIGINAL ordering.
    src_active_o: optional bool [v_pad] (ORIGINAL) masking message sources —
    the partial-active restriction (reference partial variants relax only from
    recently-changed vertices, sssp/shortest_paths.hpp:135-141)."""
    d = direction
    x_d = common.to_direction(g, x_o, O, d)
    act_d = (None if src_active_o is None
             else common.to_direction(g, src_active_o, O, d))
    out = advance_pull_value(g, x_d, combine, edge_values=edge_values,
                             weight_op=weight_op,
                             exclude_self_loops=exclude_self_loops,
                             src_active=act_d, direction=d)
    return common.to_direction(g, out, d, O)


def _merge(x, combine):
    if combine == "add":
        return jax.lax.psum(x, E)
    if combine == "min":
        return jax.lax.pmin(x, E)
    if combine == "max":
        return jax.lax.pmax(x, E)
    if combine == "or":
        # UNSIGNED max: signed pmax mis-orders int words with bit 31 set
        # (see ops/monoid._or_segment)
        return jax.lax.pmax(x.astype(jnp.uint32), E).astype(x.dtype)
    raise ValueError(combine)


def _smap(mesh, fn, n_state_args: int, n_outs: int = 1):
    """shard_map wrapper: first arg = stacked graph pytree (sharded on the
    leading axis), remaining args replicated state; outputs replicated."""
    in_specs = (P(E),) + (P(),) * n_state_args
    out_specs = P() if n_outs == 1 else (P(),) * n_outs
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def pr_consts(ec):
    """Host precompute for PR in ORIGINAL space: (rev_deg, dangling_mask) over
    GLOBAL self-loop-excluded out-degrees (pr.hpp:6-148 semantics)."""
    v = ec.vertices_count
    nonloop = ec.src_ids != ec.dst_ids
    outdeg = np.bincount(ec.src_ids[nonloop], minlength=v).astype(np.float64)
    rev = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    return rev.astype(np.float32), (outdeg == 0)


def _pad_v(arr, v_pad, fill=0):
    out = np.full(v_pad, fill, arr.dtype)
    out[:len(arr)] = arr
    return out


def make_pr_sharded(sg: ShardedTileGraph, mesh, ec, damping: float = 0.85,
                    max_iterations: int = 100):
    """jitted (stacked, ranks0, rev_deg, dangling_mask) -> ranks [v_pad, O]."""
    v, v_pad = sg.v, sg.v_pad
    k = (1.0 - damping) / v
    real = jnp.arange(v_pad) < v

    def body_fn(gstack, ranks0, rev, dmask):
        g = take_shard(gstack)

        def it(_, ranks):
            dangling = jnp.sum(jnp.where(dmask, ranks, 0.0)) / v
            acc = _shard_pull_original(g, ranks * rev, "add", direction=G,
                                       exclude_self_loops=True)
            acc = jax.lax.psum(jnp.where(real, acc, 0.0), E)
            return jnp.where(real, k + damping * (acc + dangling), 0.0)

        return jax.lax.fori_loop(0, max_iterations, it, ranks0)

    step = _smap(mesh, body_fn, 3)
    rev, dmask = pr_consts(ec)

    def run():
        ranks0 = jnp.where(real, 1.0 / v, 0.0).astype(jnp.float32)
        return step(sg.stacked, ranks0, jnp.asarray(_pad_v(rev, v_pad)),
                    jnp.asarray(_pad_v(dmask, v_pad, fill=False)))
    return run


def make_bfs_sharded(sg: ShardedTileGraph, mesh, max_levels: int = 10_000):
    """Level-synchronous pull BFS. jitted (stacked, source) -> levels [v_pad, O]
    (source level 1, unvisited -1 — reference convention)."""
    v, v_pad = sg.v, sg.v_pad
    INF = jnp.iinfo(jnp.int32).max
    real = jnp.arange(v_pad) < v

    def body_fn(gstack, source):
        g = take_shard(gstack)
        levels0 = jnp.where(jnp.arange(v_pad) == source, 1, INF)
        levels0 = jnp.where(real, levels0, INF)

        def cond(state):
            levels, size, cur = state
            return (size > 0) & (cur < max_levels)

        def it(state):
            levels, _, cur = state
            on = levels == cur
            reached = _shard_pull_original(g, on, "or", direction=G)
            reached = _merge(reached & real, "or")
            newly = reached & (levels == INF)
            return (jnp.where(newly, cur + 1, levels),
                    jnp.sum(newly, dtype=jnp.int32), cur + 1)

        levels, _, _ = jax.lax.while_loop(
            cond, it, (levels0, jnp.int32(1), jnp.int32(1)))
        return jnp.where(levels == INF, -1, levels)

    return _smap(mesh, body_fn, 1)


def make_sssp_sharded(sg: ShardedTileGraph, mesh, weights_stacked,
                      max_iterations: int = 10_000):
    """All-active Bellman-Ford. jitted (stacked, weights, source) -> dist."""
    v, v_pad = sg.v, sg.v_pad
    real = jnp.arange(v_pad) < v

    def body_fn(gstack, wstack, source):
        g = take_shard(gstack)
        ev = take_shard(wstack).incoming
        dist0 = jnp.where(jnp.arange(v_pad) == source, 0.0, jnp.inf)
        dist0 = jnp.where(real, dist0, jnp.inf).astype(jnp.float32)

        def relax(dist):
            cand = _shard_pull_original(g, dist, "min", direction=G,
                                        edge_values=ev, weight_op="add")
            cand = jax.lax.pmin(jnp.where(real, cand, jnp.inf), E)
            return jnp.minimum(dist, cand)

        def cond(state):
            dist, prev, it = state
            return (it < max_iterations) & jnp.any(dist != prev)

        def it_fn(state):
            dist, _, it = state
            return relax(dist), dist, it + 1

        dist, _, _ = jax.lax.while_loop(
            cond, it_fn, (relax(dist0), dist0, jnp.int32(1)))
        return dist

    in_specs = (P(E), P(E), P())
    return jax.jit(jax.shard_map(body_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=P(), check_vma=False))


def make_cc_sharded(sg: ShardedTileGraph, mesh, max_iterations: int = 1000):
    """Shiloach-Vishkin over the undirected neighborhood (hook = per-shard
    min-pulls over BOTH containers + pmin; jump = pointer halving)."""
    v, v_pad = sg.v, sg.v_pad
    real = jnp.arange(v_pad) < v
    ids = jnp.arange(v_pad, dtype=jnp.int32)

    def body_fn(gstack):
        g = take_shard(gstack)
        labels0 = jnp.where(real, ids, jnp.int32(v))
        BIGI = jnp.int32(jnp.iinfo(jnp.int32).max)

        def hook(labels):
            m_in = _shard_pull_original(g, labels, "min", direction=G)
            m_out = _shard_pull_original(g, labels, "min", direction=S)
            m = jnp.minimum(jnp.where(real, m_in, BIGI),
                            jnp.where(real, m_out, BIGI))
            m = jax.lax.pmin(m, E)
            return jnp.minimum(labels, m)

        def jump(labels):
            return jnp.take(labels, jnp.minimum(labels, v_pad - 1), mode="clip")

        def cond(state):
            labels, prev, it = state
            return (it < max_iterations) & jnp.any(labels != prev)

        def it_fn(state):
            labels, _, it = state
            # jumps every 4th iteration only; the hook-only fixpoint is
            # already correct CC (models/cc.py note)
            new = hook(labels)
            new = jax.lax.cond(it % 4 == 3, lambda l: jump(jump(l)),
                               lambda l: l, new)
            new = jnp.where(real, new, jnp.int32(v))
            return new, labels, it + 1

        labels, _, _ = jax.lax.while_loop(
            cond, it_fn, (labels0, jnp.full_like(labels0, -1), jnp.int32(0)))
        return labels

    return _smap(mesh, body_fn, 0)


def make_hits_sharded(sg: ShardedTileGraph, mesh, iterations: int = 20):
    """Alternating auth/hub pulls with L2 normalization (hits.hpp:5-176)."""
    v, v_pad = sg.v, sg.v_pad
    real = (jnp.arange(v_pad) < v).astype(jnp.float32)

    def body_fn(gstack):
        g = take_shard(gstack)
        auth0 = real
        hub0 = real

        def normalize(x):
            n = jnp.sqrt(jnp.sum(x * x))
            return jnp.where(n > 0, x / n, x)

        def it(_, state):
            auth, hub = state
            a = _shard_pull_original(g, hub, "add", direction=G)
            a = jax.lax.psum(a * real, E)
            auth = normalize(a)
            h = _shard_pull_original(g, auth, "add", direction=S)
            h = jax.lax.psum(h * real, E)
            return auth, normalize(h)

        return jax.lax.fori_loop(0, iterations, it, (auth0, hub0))

    return _smap(mesh, body_fn, 0, n_outs=2)


def make_coloring_sharded(sg: ShardedTileGraph, mesh, seed: int = 0,
                          words: int = 4, max_rounds: int = 10_000):
    """Distributed Jones-Plassmann greedy coloring (reference
    coloring.hpp:66-158): per round, shard-local undirected pulls compute the
    best uncolored-neighbor priority (pmin merge) and the banned-color
    bitmasks (all_gather + bitwise-or), winners take their smallest free
    window color, saturated winners take max(neighbor)+1. Returns jitted
    (stacked,) -> colors [v_pad, O]."""
    v, v_pad = sg.v, sg.v_pad
    UNCOLORED = jnp.int32(-1)
    real = jnp.arange(v_pad) < v
    rng = np.random.default_rng(seed)
    prio_np = np.full(v_pad, 2**31 - 1, np.int32)
    prio_np[:v] = rng.permutation(v).astype(np.int32)
    prio = jnp.asarray(prio_np)

    def body_fn(gstack):
        g = take_shard(gstack)
        colors0 = jnp.where(real, UNCOLORED, jnp.int32(0))

        # both pulls are functions of the SOURCE alone: premask elementwise
        # and pull VALUES through the restricted advance, one pull per
        # direction (models/coloring.py banned_word note)
        def und_min(vec_o):
            m_in = _shard_pull_original(g, vec_o, "min", direction=G)
            m_out = _shard_pull_original(g, vec_o, "min", direction=S)
            return jax.lax.pmin(jnp.minimum(m_in, m_out), E)

        def und_or(vec_o):
            m_in = _shard_pull_original(g, vec_o, "or", direction=G)
            m_out = _shard_pull_original(g, vec_o, "or", direction=S)
            both = m_in | m_out
            # bitwise-or across devices (per-shard masks DIFFER, so no max
            # collective applies): gather and OR-reduce locally
            allm = jax.lax.all_gather(both, E)
            return jax.lax.reduce(allm, jnp.zeros((), both.dtype),
                                  jax.lax.bitwise_or, (0,))

        def round_body(state):
            colors, rnd, _ = state
            uncolored = (colors == UNCOLORED) & real
            nb_best = und_min(jnp.where(colors == UNCOLORED, prio,
                                        jnp.int32(2**31 - 1)))
            winner = uncolored & (prio <= nb_best)
            cand = jnp.full(v_pad, jnp.int32(words * 32), jnp.int32)
            for w in range(words):
                bw = und_or(jnp.where(
                    (colors >= 0) & (colors // 32 == w),
                    jnp.left_shift(jnp.int32(1), colors % 32),
                    jnp.int32(0)))
                free = jnp.bitwise_not(bw)
                lsb = free & (-free)
                pos = (31 - jnp.clip(jax.lax.clz(lsb.astype(jnp.uint32))
                                     .astype(jnp.int32), 0, 31))
                word_cand = jnp.where(free != 0, 32 * w + pos,
                                      jnp.int32(words * 32))
                cand = jnp.minimum(cand, word_cand)
            # saturated-window winners take max(neighbor color)+1 — valid
            # for any chromatic number at constant program size
            # (models/coloring.py round_body note)
            mx_in = _shard_pull_original(
                g, jnp.where(colors >= 0, colors, jnp.int32(-1)), "max",
                direction=G)
            mx_out = _shard_pull_original(
                g, jnp.where(colors >= 0, colors, jnp.int32(-1)), "max",
                direction=S)
            max_nb = jax.lax.pmax(jnp.maximum(mx_in, mx_out), E)
            new_colors = jnp.where(
                winner,
                jnp.where(cand < words * 32, cand,
                          jnp.maximum(max_nb, jnp.int32(words * 32 - 1)) + 1),
                colors)
            return (new_colors, rnd + 1,
                    jnp.sum(winner, dtype=jnp.int32))

        def cond(state):
            colors, rnd, assigned = state
            return (assigned > 0) & (rnd < max_rounds)

        colors, _, _ = jax.lax.while_loop(
            cond, round_body, (colors0, jnp.int32(0), jnp.int32(1)))
        return colors

    return _smap(mesh, body_fn, 0)


def make_sssp_sharded_partial(sg: ShardedTileGraph, mesh, weights_stacked,
                              delta_capacity: Optional[int] = None,
                              max_iterations: int = 10_000):
    """Distributed PARTIAL-ACTIVE Bellman-Ford — the reference's work-frontier
    MPI SSSP (`algorithms/sssp/shortest_paths.hpp:135-141`: relax only from
    recently-changed vertices, then EXCHANGE_RECENTLY_CHANGED min-merge).
    Per iteration each shard pulls candidates restricted to changed sources
    (src_active masking) and the distance merge rides the compacted-delta
    exchange (collectives.merge_changed_sparse) with the dense allreduce as
    the big-delta fallback. jitted (stacked, weights, source) -> dist."""
    from . import collectives as C
    v, v_pad = sg.v, sg.v_pad
    real = jnp.arange(v_pad) < v
    delta_capacity = C.delta_capacity_policy(v_pad, mesh.size,
                                             requested=delta_capacity)

    def body_fn(gstack, wstack, source):
        g = take_shard(gstack)
        ev = take_shard(wstack).incoming
        dist0 = jnp.where(jnp.arange(v_pad) == source, 0.0, jnp.inf)
        dist0 = jnp.where(real, dist0, jnp.inf).astype(jnp.float32)
        changed0 = jnp.arange(v_pad) == source

        def cond(state):
            dist, changed, it = state
            return (it < max_iterations) & jnp.any(changed)

        def it_fn(state):
            dist, changed, it = state
            cand = _shard_pull_original(g, dist, "min", direction=G,
                                        edge_values=ev, weight_op="add",
                                        src_active_o=changed)
            local = jnp.minimum(dist, jnp.where(real, cand, jnp.inf))
            new = C.merge_changed_sparse(local, dist, "min", delta_capacity,
                                         axis=E)
            return new, new < dist, it + 1

        dist, _, _ = jax.lax.while_loop(cond, it_fn,
                                        (dist0, changed0, jnp.int32(0)))
        return dist

    in_specs = (P(E), P(E), P())
    return jax.jit(jax.shard_map(body_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=P(), check_vma=False))


def make_bfs_do_sharded(sg: ShardedTileGraph, mesh, alpha: float = 15.0,
                        beta: float = 18.0, id_cap: int = 1 << 12,
                        edge_cap: int = 1 << 16, max_levels: int = 10_000):
    """Distributed DIRECTION-OPTIMIZING BFS over the sharded flagship: per
    level a traced Beamer test picks top-down (per-shard compacted sparse push
    over the shard's outgoing container + pmin merge) or bottom-up (per-shard
    dense or-pull + or merge) — the sharded analog of the device-resident
    state machine in models/bfs.py (reference hardwired_do_bfs.hpp:925-990).
    State (levels) stays replicated in ORIGINAL order; frontier scalars
    (size, out-neighbour count) are collective-synchronized inside the loop.
    jitted (stacked, source) -> levels [v_pad, O] (source=1, unvisited=-1)."""
    from ..ops.advance import advance_push_sparse
    from ..graph.frontier import Frontier, compact_ids
    from ..config import Sparsity
    v, v_pad = sg.v, sg.v_pad
    INF = jnp.iinfo(jnp.int32).max
    real = jnp.arange(v_pad) < v
    id_cap = min(id_cap, v_pad)

    def body_fn(gstack, source):
        g = take_shard(gstack)
        # global out-degrees in ORIGINAL order: sum of per-shard out-degrees
        outdeg_o = jax.lax.psum(
            common.to_direction(g, g.outgoing.degrees, S, O), E)
        ecap = edge_cap
        levels0 = jnp.where(jnp.arange(v_pad) == source, 1, INF)
        levels0 = jnp.where(real, levels0, INF)

        def td_branch(args):
            levels, cur = args
            mask_o = levels == cur
            fr = Frontier(mask=mask_o, size=jnp.sum(mask_o, dtype=jnp.int32),
                          neighbours_count=jnp.int32(0), direction=O,
                          sparsity=Sparsity.SPARSE)
            ids_o, valid = compact_ids(fr, id_cap)
            sid = jnp.take(g.outgoing.orig_to_sorted,
                           jnp.minimum(ids_o, v_pad - 1), mode="clip")
            levels_s = common.to_direction(g, levels, O, S)
            out_s = advance_push_sparse(
                g, sid, valid, ecap, {"l": levels_s},
                lambda s, d, w: jnp.zeros_like(s["l"]) + (cur + 1),
                "min", levels_s, direction=S)
            out_o = common.to_direction(g, out_s, S, O)
            return jnp.minimum(levels, jax.lax.pmin(
                jnp.where(real, out_o, INF), E))

        def bu_branch(args):
            levels, cur = args
            on = levels == cur
            reached = _shard_pull_original(g, on, "or", direction=G)
            reached = _merge(reached & real, "or")
            return jnp.where((levels == INF) & reached, cur + 1, levels)

        def cond(state):
            levels, size, nbrs, cur, unexplored = state
            return (size > 0) & (cur < max_levels)

        def body(state):
            levels, size, nbrs, cur, unexplored = state
            td_ok = (((nbrs.astype(jnp.float32)
                       < unexplored.astype(jnp.float32) / alpha)
                      | (size.astype(jnp.float32) * beta < v))
                     & (size < id_cap) & (nbrs < ecap))
            new_levels = jax.lax.cond(td_ok, td_branch, bu_branch,
                                      (levels, cur))
            newly = new_levels < levels
            dsize = jnp.sum(newly, dtype=jnp.int32)
            dnbrs = jnp.sum(jnp.where(newly, outdeg_o, 0), dtype=jnp.int32)
            return (new_levels, dsize, dnbrs, cur + 1,
                    jnp.maximum(unexplored - dnbrs, 0))

        size0 = jnp.int32(1)
        nbrs0 = jnp.take(outdeg_o, source)
        levels, _, _, _, _ = jax.lax.while_loop(
            cond, body, (levels0, size0, nbrs0, jnp.int32(1),
                         jnp.int32(min(sg.e, 2**31 - 1))))
        return jnp.where(levels == INF, -1, levels)

    return _smap(mesh, body_fn, 1)


def make_msbfs_sharded(sg: ShardedTileGraph, mesh, max_levels: int = 126):
    """Distributed bit-parallel multi-source BFS (VERDICT r4 #5: the
    shard_map twin of msbfs_sharded_scan — the kernel that carries the
    headline BFS numbers gets a multi-chip path like the reference's MPI
    exchanges cover its flagships, mpi_exchange.hpp:300-363). One or-pull
    per shard per level + a pmax-word merge over the edge axis.
    jitted (stacked, roots int32 [32]) -> levels int8 [32, v_pad] ORIGINAL."""
    v, v_pad = sg.v, sg.v_pad
    lv_cap = min(max_levels, 126)
    real = jnp.arange(v_pad) < v

    def body_fn(gstack, roots):
        g = take_shard(gstack)
        bits = jnp.int32(1) << jnp.arange(32, dtype=jnp.int32)
        seed = jnp.zeros(v_pad, jnp.int32).at[roots].add(bits, mode="drop")
        seed = jnp.where(real, seed, 0)
        lev0 = jnp.where(
            ((seed[None, :] >> jnp.arange(32, dtype=jnp.int32)[:, None]) & 1)
            == 1, jnp.int8(1), jnp.int8(-1))

        def cond(state):
            seen, frontier, levels, cur, alive = state
            return alive & (cur < lv_cap)

        def body(state):
            seen, frontier, levels, cur, _ = state
            reached = _shard_pull_original(g, frontier, "or", direction=G)
            reached = _merge(jnp.where(real, reached, 0), "or")
            newly = reached & ~seen
            bit = (newly[None, :]
                   >> jnp.arange(32, dtype=jnp.int32)[:, None]) & 1
            levels2 = jnp.where(bit == 1, (cur + 1).astype(jnp.int8), levels)
            return (seen | newly, newly, levels2, cur + 1,
                    jnp.any(newly != 0))

        _, _, levels, _, _ = jax.lax.while_loop(
            cond, body, (seed, seed, lev0, jnp.int32(1), jnp.any(seed != 0)))
        return levels

    return _smap(mesh, body_fn, 1)


def make_cc_hybrid_sharded(sg: ShardedTileGraph, mesh,
                           max_flood_levels: int = 1000,
                           max_iterations: int = 1000):
    """Distributed flood-hybrid CC (VERDICT r4 #5: shard_map twin of
    cc_hybrid_sharded_scan, including the r5 flood non-closure guard).
    Phase A or-floods the hub's weak component over both containers (or-pull
    per shard + pmax-word merge), phase B hook-mins the remainder with pmin
    merges. jitted (stacked, hub) -> (labels [v_pad] O, flood_lv, hooks)."""
    v, v_pad = sg.v, sg.v_pad
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    real = ids < v
    BIGI = jnp.int32(jnp.iinfo(jnp.int32).max)

    def body_fn(gstack, hub):
        g = take_shard(gstack)
        reach0 = ids == hub

        def und_or(frontier):
            via_in = _shard_pull_original(g, frontier, "or", direction=G)
            via_out = _shard_pull_original(g, frontier, "or", direction=S)
            return _merge((via_in | via_out) & real, "or")

        def fcond(state):
            reach, frontier, lv = state
            return jnp.any(frontier) & (lv < max_flood_levels)

        def fbody(state):
            reach, frontier, lv = state
            newly = und_or(frontier) & ~reach & real
            return reach | newly, newly, lv + 1

        reach, front_end, flood_lv = jax.lax.while_loop(
            fcond, fbody, (reach0, reach0, jnp.int32(0)))
        freeze = reach & ~jnp.any(front_end)

        hub_label = hub.astype(jnp.int32)
        labels0 = jnp.where(freeze, hub_label, ids)
        labels0 = jnp.where(real, labels0, jnp.int32(v))

        def hcond(state):
            labels, prev, it = state
            return (it < max_iterations) & jnp.any(labels != prev)

        def hbody(state):
            labels, _, it = state
            m_in = _shard_pull_original(g, labels, "min", direction=G)
            m_out = _shard_pull_original(g, labels, "min", direction=S)
            m = _merge(jnp.minimum(jnp.where(real, m_in, BIGI),
                                   jnp.where(real, m_out, BIGI)), "min")
            new = jnp.minimum(labels, m)
            new = jnp.where(freeze, hub_label, new)
            new = jnp.where(real, new, jnp.int32(v))
            return new, labels, it + 1

        labels, _, hooks = jax.lax.while_loop(
            hcond, hbody, (labels0, jnp.full_like(labels0, -1),
                           jnp.int32(0)))
        return labels, flood_lv, hooks

    return _smap(mesh, body_fn, 1, n_outs=3)


def _shard_aggregate_sum_count(g, feats_o):
    """Per-shard neighbor-feature sums + counts over the shard's in-edges,
    ORIGINAL ordering."""
    from ..models.gnn import aggregate_sum_count
    feats_g = jnp.take(feats_o, g.incoming.sorted_to_orig, axis=0,
                       mode="clip")
    ssum_g, cnt_g = aggregate_sum_count(g, feats_g, direction=G)
    ssum_o = jnp.take(ssum_g, g.incoming.orig_to_sorted, axis=0, mode="clip")
    cnt_o = jnp.take(cnt_g, g.incoming.orig_to_sorted, mode="clip")
    return ssum_o, cnt_o


def make_sage_loss_sharded(sg: ShardedTileGraph, mesh):
    """Distributed GraphSAGE-style 2-layer mean-aggregate forward + masked
    cross-entropy loss (BASELINE config 5): features/params replicated,
    aggregation edge-partitioned over the shard axis (per-shard sum+count
    pulls, psum merge). Differentiable through shard_map — psum transposes to
    the replicated-gradient exchange, so `jax.grad` of this loss IS the
    distributed training step's gradient. Returns loss_fn(params, feats,
    labels, mask)."""
    v, v_pad = sg.v, sg.v_pad
    real = jnp.arange(v_pad) < v

    def body_fn(gstack, wself1, wnbr1, b1, wself2, wnbr2, b2,
                feats, labels, mask):
        g = take_shard(gstack)

        def agg_mean(h):
            ssum, cnt = _shard_aggregate_sum_count(g, h)
            ssum = jax.lax.psum(ssum, E)
            cnt = jax.lax.psum(cnt, E)
            return ssum / jnp.maximum(cnt, 1)[:, None]

        h = jax.nn.relu(feats @ wself1 + agg_mean(feats) @ wnbr1 + b1)
        logits = h @ wself2 + agg_mean(h) @ wnbr2 + b2
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        m = mask & real
        return jnp.sum(jnp.where(m, nll, 0.0)) / jnp.maximum(jnp.sum(m), 1)

    smapped = jax.shard_map(body_fn, mesh=mesh,
                            in_specs=(P(E),) + (P(),) * 9,
                            out_specs=P(), check_vma=False)

    def loss_fn(params, feats, labels, mask):
        return smapped(sg.stacked, params.w_self1, params.w_nbr1, params.b1,
                       params.w_self2, params.w_nbr2, params.b2,
                       feats, labels, mask)
    return loss_fn


def make_sage_train_step_sharded(sg: ShardedTileGraph, mesh, optimizer):
    """jitted distributed GraphSAGE train step: (params, opt_state, feats,
    labels, mask) -> (params, opt_state, loss)."""
    loss_fn = make_sage_loss_sharded(sg, mesh)

    @jax.jit
    def step(params, opt_state, feats, labels, mask):
        loss, grads = jax.value_and_grad(loss_fn)(params, feats, labels, mask)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        new_params = jax.tree_util.tree_map(lambda p, u: p + u, params,
                                            updates)
        return new_params, opt_state, loss
    return step


# ---------------------------------------------------------------------------
# single-card sequential-shard execution (scan over the stacked axis)
# ---------------------------------------------------------------------------

def sharded_pull_scan(sg: ShardedTileGraph, x_o: jax.Array, combine,
                      direction=G, weights_stacked=None, weight_op=None,
                      exclude_self_loops: bool = False,
                      src_active_o=None) -> jax.Array:
    """Combine per-shard pulls sequentially on one card: the per-step working
    set is ONE shard, not the whole graph.
    "or" supports bool (reachability) AND int words (bit-parallel MS-BFS
    frontiers, coloring bitmasks): the identity/accumulator follow x_o's
    dtype. src_active_o: optional bool [v_pad] ORIGINAL source restriction."""
    mon = M.get(combine)
    ident = mon.identity(x_o.dtype)
    init = jnp.full((sg.v_pad,), ident, x_o.dtype)

    if weights_stacked is None:
        def body(acc, g):
            out = _shard_pull_original(g, x_o, combine, direction=direction,
                                       exclude_self_loops=exclude_self_loops,
                                       src_active_o=src_active_o)
            return mon.combine(acc, out), None
        acc, _ = jax.lax.scan(body, init, sg.stacked)
    else:
        def body(acc, gw):
            g, w = gw
            out = _shard_pull_original(g, x_o, combine, direction=direction,
                                       edge_values=w.incoming,
                                       weight_op=weight_op,
                                       exclude_self_loops=exclude_self_loops,
                                       src_active_o=src_active_o)
            return mon.combine(acc, out), None
        acc, _ = jax.lax.scan(body, init, (sg.stacked, weights_stacked))
    return acc


@functools.partial(jax.jit, static_argnums=(3,))
def _pr_scan_run(sg: ShardedTileGraph, rev, dmask, max_iterations: int):
    v, v_pad = sg.v, sg.v_pad
    real = jnp.arange(v_pad) < v
    k = (1.0 - 0.85) / v

    def it(_, ranks):
        dangling = jnp.sum(jnp.where(dmask, ranks, 0.0)) / v
        acc = sharded_pull_scan(sg, ranks * rev, "add", direction=G,
                                exclude_self_loops=True)
        acc = jnp.where(real, acc, 0.0)
        return jnp.where(real, k + 0.85 * (acc + dangling), 0.0)

    ranks0 = jnp.where(real, 1.0 / v, 0.0).astype(jnp.float32)
    return jax.lax.fori_loop(0, max_iterations, it, ranks0)


def pagerank_sharded_scan(sg: ShardedTileGraph, ec, max_iterations: int = 100
                          ) -> jax.Array:
    """Single-card PageRank over sequential shards; returns [v_pad] ORIGINAL."""
    rev, dmask = pr_consts(ec)
    return _pr_scan_run(sg, jnp.asarray(_pad_v(rev, sg.v_pad)),
                        jnp.asarray(_pad_v(dmask, sg.v_pad, fill=False)),
                        max_iterations)


@functools.partial(jax.jit, static_argnums=(1,))
def hits_sharded_scan(sg: ShardedTileGraph, iterations: int = 20):
    """Single-card HITS over sequential shards (hits.hpp:5-176 semantics);
    returns (auth, hub) [v_pad] ORIGINAL."""
    v, v_pad = sg.v, sg.v_pad
    real = (jnp.arange(v_pad) < v).astype(jnp.float32)

    def normalize(x):
        n = jnp.sqrt(jnp.sum(x * x))
        return jnp.where(n > 0, x / n, x)

    def it(_, state):
        auth, hub = state
        a = sharded_pull_scan(sg, hub, "add", direction=G) * real
        auth = normalize(a)
        h = sharded_pull_scan(sg, auth, "add", direction=S) * real
        return auth, normalize(h)

    return jax.lax.fori_loop(0, iterations, it, (real, real))


@functools.partial(jax.jit, static_argnums=(2,))
def bfs_sharded_scan(sg: ShardedTileGraph, source, max_levels: int = 10_000):
    """Single-card level-synchronous pull BFS over sequential shards;
    (source,) -> levels [v_pad] ORIGINAL (source level 1, unvisited -1)."""
    v, v_pad = sg.v, sg.v_pad
    INF = jnp.iinfo(jnp.int32).max
    real = jnp.arange(v_pad) < v
    levels0 = jnp.where(jnp.arange(v_pad) == source, 1, INF)
    levels0 = jnp.where(real, levels0, INF)

    def cond(state):
        levels, size, cur = state
        return (size > 0) & (cur < max_levels)

    def it(state):
        levels, _, cur = state
        on = levels == cur
        reached = sharded_pull_scan(sg, on, "or", direction=G) & real
        newly = reached & (levels == INF)
        return (jnp.where(newly, cur + 1, levels),
                jnp.sum(newly, dtype=jnp.int32), cur + 1)

    levels, _, _ = jax.lax.while_loop(
        cond, it, (levels0, jnp.int32(1), jnp.int32(1)))
    return jnp.where(levels == INF, -1, levels)


@functools.partial(jax.jit, static_argnums=(1,))
def cc_sharded_scan(sg: ShardedTileGraph, max_iterations: int = 1000):
    """Single-card Shiloach-Vishkin over sequential shards;
    -> (labels [v_pad] ORIGINAL, iterations run) — the iteration count feeds
    the per-iteration MTEPS bench row (VERDICT r3 #2)."""
    v, v_pad = sg.v, sg.v_pad
    real = jnp.arange(v_pad) < v
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    labels0 = jnp.where(real, ids, jnp.int32(v))
    BIGI = jnp.int32(jnp.iinfo(jnp.int32).max)

    def hook(labels):
        m_in = sharded_pull_scan(sg, labels, "min", direction=G)
        m_out = sharded_pull_scan(sg, labels, "min", direction=S)
        m = jnp.minimum(jnp.where(real, m_in, BIGI),
                        jnp.where(real, m_out, BIGI))
        return jnp.minimum(labels, m)

    def jump(labels):
        return jnp.take(labels, jnp.minimum(labels, v_pad - 1), mode="clip")

    def cond(state):
        labels, prev, it = state
        return (it < max_iterations) & jnp.any(labels != prev)

    def it_fn(state):
        labels, _, it = state
        new = hook(labels)
        new = jax.lax.cond(it % 4 == 3, lambda l: jump(jump(l)),
                           lambda l: l, new)
        new = jnp.where(real, new, jnp.int32(v))
        return new, labels, it + 1

    labels, _, iters = jax.lax.while_loop(
        cond, it_fn, (labels0, jnp.full_like(labels0, -1), jnp.int32(0)))
    return labels, iters


@functools.partial(jax.jit, static_argnums=(2,))
def msbfs_sharded_scan(sg: ShardedTileGraph, roots, max_levels: int = 32766):
    """Bit-parallel multi-source BFS over sequential shards (single card):
    32 roots ride one int32 word per vertex through a single bitwise-or pull
    scan per level — the scan-path twin of models/bfs.vgl_msbfs.
    roots: int32 [32] ORIGINAL ids (duplicates fine). Returns levels int8
    [32, v_pad] in ORIGINAL ordering (source level 1, unvisited -1; int8
    keeps the state small — depth capped at 126)."""
    v, v_pad = sg.v, sg.v_pad
    max_levels = min(max_levels, 126)
    real = jnp.arange(v_pad) < v
    bits = jnp.int32(1) << jnp.arange(32, dtype=jnp.int32)
    seed = jnp.zeros(v_pad, jnp.int32).at[roots].add(bits, mode="drop")
    seed = jnp.where(real, seed, 0)
    lev0 = jnp.where(
        ((seed[None, :] >> jnp.arange(32, dtype=jnp.int32)[:, None]) & 1) == 1,
        jnp.int8(1), jnp.int8(-1))

    def cond(state):
        seen, frontier, levels, cur, alive = state
        return alive & (cur < max_levels)

    def body(state):
        seen, frontier, levels, cur, _ = state
        reached = sharded_pull_scan(sg, frontier, "or", direction=G)
        reached = jnp.where(real, reached, 0)
        newly = reached & ~seen
        bit = (newly[None, :] >> jnp.arange(32, dtype=jnp.int32)[:, None]) & 1
        levels2 = jnp.where(bit == 1, (cur + 1).astype(jnp.int8), levels)
        return (seen | newly, newly, levels2, cur + 1, jnp.any(newly != 0))

    _, _, levels, _, _ = jax.lax.while_loop(
        cond, body, (seed, seed, lev0, jnp.int32(1), jnp.any(seed != 0)))
    return levels


@functools.partial(jax.jit, static_argnums=(2, 3))
def cc_hybrid_sharded_scan(sg: ShardedTileGraph, hub,
                           max_flood_levels: int = 1000,
                           max_iterations: int = 1000):
    """Single-card CC, flood-hybrid (the reference's own BFS-based CC
    `algorithms/cc/bfs_based.hpp` is the same idea):

    Phase A floods the hub's WEAK component with bool or-pulls over both
    containers and freezes it at one label. Phase B runs hook-min iterations
    for the remaining (small, shallow) components only. Pure hook-min must
    propagate the giant component's minimum id across its full eccentricity,
    each step 2 full min-pull scans; the flood covers the same distance in
    bool pulls, and the tail components converge in a handful of hooks
    because they are tiny. No label can leak INTO the frozen component:
    any outside vertex adjacent to it would have been flooded (weak
    reachability is direction-closed over both pulls).

    hub: ORIGINAL id of a vertex in (very likely) the largest component —
    callers pass the max-out-degree vertex. Correct for ANY hub; a poor
    choice only costs performance.  -> (labels [v_pad] ORIGINAL, flood
    levels, hook iterations)."""
    v, v_pad = sg.v, sg.v_pad
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    real = ids < v

    # --- phase A: weak-reachability flood from hub ---
    reach0 = (ids == hub)

    def fcond(state):
        reach, frontier, lv = state
        return jnp.any(frontier) & (lv < max_flood_levels)

    def fbody(state):
        reach, frontier, lv = state
        via_in = sharded_pull_scan(sg, frontier, "or", direction=G)
        via_out = sharded_pull_scan(sg, frontier, "or", direction=S)
        newly = (via_in | via_out) & ~reach & real
        return reach | newly, newly, lv + 1

    reach, front_end, flood_levels = jax.lax.while_loop(
        fcond, fbody, (reach0, reach0, jnp.int32(0)))

    # non-closure guard (models/cc._cc_hybrid_run twin): freezing a PARTIAL
    # flood (loop capped at max_flood_levels with a live frontier) would split
    # the hub's component into two labels — freeze only when the flood closed
    freeze = reach & ~jnp.any(front_end)

    # --- phase B: hook-min for the unflooded remainder ---
    BIGI = jnp.int32(jnp.iinfo(jnp.int32).max)
    hub_label = hub.astype(jnp.int32)
    labels0 = jnp.where(freeze, hub_label, ids)
    labels0 = jnp.where(real, labels0, jnp.int32(v))

    def hcond(state):
        labels, prev, it = state
        return (it < max_iterations) & jnp.any(labels != prev)

    def hbody(state):
        labels, _, it = state
        m_in = sharded_pull_scan(sg, labels, "min", direction=G)
        m_out = sharded_pull_scan(sg, labels, "min", direction=S)
        m = jnp.minimum(jnp.where(real, m_in, BIGI),
                        jnp.where(real, m_out, BIGI))
        new = jnp.minimum(labels, m)
        # NO pointer jumps here (unlike cc_sharded_scan): the flood already
        # covered the only deep component and the tail components are shallow
        # the flooded component is already labeled: freeze it (its vertices
        # otherwise re-derive the component minimum over many iterations)
        new = jnp.where(freeze, hub_label, new)
        new = jnp.where(real, new, jnp.int32(v))
        return new, labels, it + 1

    labels, _, hook_iters = jax.lax.while_loop(
        hcond, hbody, (labels0, jnp.full_like(labels0, -1), jnp.int32(0)))
    return labels, flood_levels, hook_iters


def _sssp_scan_impl(sg, weights_stacked, source, partial, max_iterations):
    v, v_pad = sg.v, sg.v_pad
    real = jnp.arange(v_pad) < v
    dist0 = jnp.where(jnp.arange(v_pad) == source, 0.0, jnp.inf)
    dist0 = jnp.where(real, dist0, jnp.inf).astype(jnp.float32)
    changed0 = jnp.arange(v_pad) == source

    def cond(state):
        dist, changed, it = state
        return (it < max_iterations) & jnp.any(changed)

    def body(state):
        dist, changed, it = state
        cand = sharded_pull_scan(sg, dist, "min", direction=G,
                                 weights_stacked=weights_stacked,
                                 weight_op="add",
                                 src_active_o=changed if partial else None)
        new = jnp.minimum(dist, jnp.where(real, cand, jnp.inf))
        return new, new < dist, it + 1

    dist, _, iters = jax.lax.while_loop(cond, body,
                                        (dist0, changed0, jnp.int32(0)))
    return dist, iters


@functools.partial(jax.jit, static_argnums=(3, 4))
def sssp_sharded_scan(sg: ShardedTileGraph, weights_stacked, source,
                      partial: bool = True, max_iterations: int = 10_000):
    """Single-card Bellman-Ford over sequential shards — the scan-path twin
    of make_sssp_sharded_partial. partial=True relaxes only edges out of recently-changed sources
    (src_active masking — sssp/shortest_paths.hpp:135-141 semantics);
    partial=False is the all-active sweep. -> (dist [v_pad] ORIGINAL,
    iterations run)."""
    return _sssp_scan_impl(sg, weights_stacked, source, partial,
                           max_iterations)
