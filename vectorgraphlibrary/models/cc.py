"""Connected components: Shiloach-Vishkin label propagation + BFS-based.

Capability match for the reference CC (`algorithms/cc/cc.h:18-44`,
`shiloach_vishkin.hpp:6-91` hook+jump loop; `bfs_based.hpp`). Design:
labels live in ORIGINAL id space (so label values are ordering-independent); each SV
iteration is two tiled pulls (incoming + outgoing = undirected neighborhood min) and
a pointer-halving jump — all inside one jitted `lax.while_loop` with the
reduce-changes convergence test, zero host round-trips.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.vertices import VertexArray, reorder
from ..ops.advance import advance_pull_value
from . import common

S, G, O = (TraversalDirection.SCATTER, TraversalDirection.GATHER,
           TraversalDirection.ORIGINAL)


@functools.partial(jax.jit, static_argnums=(1,))
def _sv_run(graph: VGLGraph, max_iterations: int):
    v, v_pad = graph.v, graph.v_pad
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    real = ids < v
    labels0 = jnp.where(real, ids, jnp.int32(v))   # ORIGINAL ids as labels

    def hook(labels):
        """min over undirected neighborhood, computed per direction."""
        lab_g = common.to_direction(graph, labels, O, G)
        m_in = advance_pull_value(graph, lab_g, "min", direction=G)
        m_in_orig = common.to_direction(graph, m_in, G, O)

        lab_s = common.to_direction(graph, labels, O, S)
        m_out = advance_pull_value(graph, lab_s, "min", direction=S)
        # NOTE: swapping containers makes "incoming" = outgoing edges, so this pull
        # aggregates over OUT-neighbors while staying in the tiled pull kernel.
        m_out_orig = common.to_direction(graph, m_out, S, O)
        return jnp.minimum(labels, jnp.minimum(m_in_orig, m_out_orig))

    def jump(labels):
        return jnp.take(labels, jnp.minimum(labels, v_pad - 1), mode="clip")

    def cond(state):
        labels, prev, it = state
        return (it < max_iterations) & jnp.any(labels != prev)

    def body(state):
        labels, _, it = state
        new = hook(labels)
        # pointer-halving jumps run every 4th iteration as chain
        # accelerators only. A hook-only fixpoint is already correct CC (labels locally minimal =>
        # constant per weak component), so stopping on no-change stays sound.
        new = jax.lax.cond(it % 4 == 3, lambda l: jump(jump(l)),
                           lambda l: l, new)
        new = jnp.where(real, new, jnp.int32(v))
        return new, labels, it + 1

    labels, _, iters = jax.lax.while_loop(
        cond, body, (labels0, jnp.full_like(labels0, -1), jnp.int32(0)))
    return labels, iters


def vgl_shiloach_vishkin(graph: VGLGraph, max_iterations: int = 1000
                         ) -> tuple[VertexArray, int]:
    labels, iters = _sv_run(graph, max_iterations)
    return VertexArray(values=labels, direction=O), int(iters)


def _cc_hybrid_run(graph: VGLGraph, hub, max_flood: int, max_iterations: int):
    """Flood-hybrid CC (single-card twin of parallel/sharded.
    cc_hybrid_sharded_scan; the reference's own BFS-based CC
    `algorithms/cc/bfs_based.hpp` is the same idea): bool or-pulls flood the
    hub's weak component, freeze it at one label, then hook-min only the remaining
    small components. Correct for ANY hub (a bad hub only costs speed)."""
    v, v_pad = graph.v, graph.v_pad
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    real = ids < v

    def und_or(reach_o):
        r_g = common.to_direction(graph, reach_o, O, G)
        via_in = advance_pull_value(graph, r_g, "or", direction=G)
        via_in_o = common.to_direction(graph, via_in, G, O)
        r_s = common.to_direction(graph, reach_o, O, S)
        via_out = advance_pull_value(graph, r_s, "or", direction=S)
        via_out_o = common.to_direction(graph, via_out, S, O)
        return via_in_o | via_out_o

    reach0 = ids == hub

    def fcond(state):
        reach, frontier, lv = state
        return jnp.any(frontier) & (lv < max_flood)

    def fbody(state):
        reach, frontier, lv = state
        newly = und_or(frontier) & ~reach & real
        return reach | newly, newly, lv + 1

    reach, front_end, flood_lv = jax.lax.while_loop(
        fcond, fbody, (reach0, reach0, jnp.int32(0)))

    # non-closure guard: if the flood hit max_flood with a live frontier
    # (component diameter > max_flood — path/road-like graphs), `reach` is a
    # strict SUBSET of the hub's component; freezing it would split one
    # component into two labels. Freeze only when the flood closed; otherwise
    # phase B degrades to a plain (correct, slower) hook-min over everything.
    freeze = reach & ~jnp.any(front_end)

    BIGI = jnp.int32(jnp.iinfo(jnp.int32).max)
    hub_label = hub.astype(jnp.int32)
    labels0 = jnp.where(freeze, hub_label, ids)
    labels0 = jnp.where(real, labels0, jnp.int32(v))

    def hook(labels):
        lab_g = common.to_direction(graph, labels, O, G)
        m_in = advance_pull_value(graph, lab_g, "min", direction=G)
        m_in_o = common.to_direction(graph, m_in, G, O)
        lab_s = common.to_direction(graph, labels, O, S)
        m_out = advance_pull_value(graph, lab_s, "min", direction=S)
        m_out_o = common.to_direction(graph, m_out, S, O)
        return jnp.minimum(labels, jnp.minimum(
            jnp.where(real, m_in_o, BIGI), jnp.where(real, m_out_o, BIGI)))

    def hcond(state):
        labels, prev, it = state
        return (it < max_iterations) & jnp.any(labels != prev)

    def hbody(state):
        labels, _, it = state
        new = hook(labels)
        # no pointer jumps: the flood covered the deep component, tails are
        # shallow, and jumps are element gathers (~24 ns/elem here)
        new = jnp.where(freeze, hub_label, new)    # frozen hub component
        new = jnp.where(real, new, jnp.int32(v))
        return new, labels, it + 1

    labels, _, iters = jax.lax.while_loop(
        hcond, hbody, (labels0, jnp.full_like(labels0, -1), jnp.int32(0)))
    return labels, flood_lv, iters


@functools.partial(jax.jit, static_argnums=(2, 3))
def _cc_hybrid_jit(graph: VGLGraph, hub, max_flood: int, max_iterations: int):
    return _cc_hybrid_run(graph, hub, max_flood, max_iterations)


def vgl_cc_hybrid(graph: VGLGraph, hub: Optional[int] = None,
                  max_flood: int = 1000, max_iterations: int = 1000
                  ) -> tuple[VertexArray, int]:
    """Flood-hybrid CC; hub defaults to the max-out-degree vertex."""
    if hub is None:
        outdeg_o = common.to_direction(graph, graph.outgoing.degrees, S, O)
        hub = int(jnp.argmax(outdeg_o[:graph.v]))
    labels, _, iters = _cc_hybrid_jit(graph, jnp.int32(hub), max_flood,
                                      max_iterations)
    return VertexArray(values=labels, direction=O), int(iters)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _cc_hybrid_multi(graph: VGLGraph, hubs, max_flood: int,
                     max_iterations: int):
    """k flood-hybrid CC runs (distinct hubs -> genuinely distinct device
    programs, no CSE) in ONE dispatch — the small-graph batch timing
    protocol (bfs.vgl_bfs_device_multi analog)."""
    return jax.lax.map(
        lambda h: _cc_hybrid_run(graph, h, max_flood, max_iterations)[0],
        hubs)


def vgl_cc_hybrid_multi(graph: VGLGraph, hubs) -> VertexArray:
    labels = _cc_hybrid_multi(graph, jnp.asarray(hubs, jnp.int32), 1000, 1000)
    return VertexArray(values=labels, direction=O)


def vgl_bfs_based(graph: VGLGraph, max_components: int = 1_000_000
                  ) -> VertexArray:
    """BFS-based CC (reference cc/bfs_based.hpp): repeatedly BFS-flood the first
    unlabeled vertex over the undirected graph. Efficient when components are few;
    isolated vertices are labeled in one vectorized shot first."""
    v, v_pad = graph.v, graph.v_pad
    ids = jnp.arange(v_pad, dtype=jnp.int32)
    real = ids < v
    # ORIGINAL-space degrees (und: out+in)
    outdeg_o = common.to_direction(graph, graph.outgoing.degrees, S, O)
    indeg_o = common.to_direction(graph, graph.incoming.degrees, G, O)
    und_deg = outdeg_o + indeg_o
    labels = jnp.where(real & (und_deg == 0), ids, jnp.int32(-1))
    labels = jnp.where(real, labels, jnp.int32(v))

    @jax.jit
    def flood_step(reach_o):
        """One undirected BFS-flood expansion in ORIGINAL space."""
        r_g = common.to_direction(graph, reach_o, O, G)
        via_in = advance_pull_value(graph, r_g, "or", direction=G)
        via_in_o = common.to_direction(graph, via_in, G, O)
        r_s = common.to_direction(graph, reach_o, O, S)
        via_out = advance_pull_value(graph, r_s, "or", direction=S)
        via_out_o = common.to_direction(graph, via_out, S, O)
        return (reach_o | via_in_o | via_out_o) & real

    comp = 0
    while comp < max_components:
        unlabeled = np.asarray(jnp.argmax((labels == -1).astype(jnp.int32)))
        seed = int(unlabeled)
        if not bool(np.asarray(labels[seed] == -1)):
            break
        reach = jnp.zeros(v_pad, bool).at[seed].set(True)
        size = 1
        while True:
            reach2 = flood_step(reach)
            new_size = int(jnp.sum(reach2))
            if new_size == size:
                break
            reach, size = reach2, new_size
        labels = jnp.where(reach2, jnp.int32(seed), labels)
        comp += 1
    return VertexArray(values=labels, direction=O)


def seq_cc(ec) -> np.ndarray:
    """Oracle: weakly connected components via SciPy."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csg
    v = ec.vertices_count
    # int32 ones: duplicate edges are summed, and an int8 sum of 256
    # duplicates would wrap to a zero (non-)edge
    a = sp.csr_matrix((np.ones(ec.edges_count, np.int32),
                       (ec.src_ids, ec.dst_ids)), shape=(v, v))
    _, labels = csg.connected_components(a, directed=True, connection="weak")
    return labels.astype(np.int32)
