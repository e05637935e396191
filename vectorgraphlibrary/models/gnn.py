"""GNN-style neighborhood aggregation and sampling on the graph substrate.

BASELINE.json north-star addition: GraphSAGE-style mean aggregation with uniform
neighbor sampling, built on the same degree-sorted tile layout as the analytics
algorithms. The dense feature dimension makes this the matmul-friendly path:

- full aggregation = SpMM: per bucket, row-gather H[adj] + masked mean over the
  width axis (exact float32: the grouped sums ask for Precision.HIGHEST, so
  they never run in TF32);
- sampled aggregation: k uniform out-neighbors per vertex via row_ptr + random
  offsets (pure gathers, reference rw-style batched RNG analog);
- a 2-layer GraphSAGE forward + cross-entropy training step (optax), jittable and
  shard_map-ready (batch dim = vertices). Its dense layers use the default
  matmul precision, which is TF32 on an H100 (about 3 decimal digits), so
  GraphSAGE outputs are compared with a relative tolerance of 1e-2.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TraversalDirection
from ..graph.device import VGLGraph

G, S = TraversalDirection.GATHER, TraversalDirection.SCATTER


def aggregate_sum_count(graph: VGLGraph, feats: jax.Array,
                        direction: TraversalDirection = G
                        ) -> tuple[jax.Array, jax.Array]:
    """Neighbor-feature SUMS + neighbor counts: [v_pad, F] -> ([v_pad, F],
    [v_pad]) in `direction`'s sorted ordering (neighbors = in-neighbors for
    GATHER). Separate sum/count lets edge-partitioned shards psum partials
    before the mean divide (parallel/sharded.make_sage_loss_sharded)."""
    dg = graph.direction(direction)
    v_pad, f = graph.v_pad, feats.shape[1]
    sparts, cparts = [], []
    covered = 0
    if dg.huge is not None:
        h = dg.huge
        gathered = jnp.take(feats, h.adj, axis=0, mode="clip")  # [nc, cw, F]
        valid = (h.adj < v_pad)[:, :, None]
        ssum = jnp.sum(jnp.where(valid, gathered, 0.0), axis=1)
        cnt = jnp.sum(valid[:, :, 0], axis=1)
        rsum = jax.ops.segment_sum(ssum, h.seg_ids, h.n_rows + 1,
                                   indices_are_sorted=True)[:h.n_rows]
        rcnt = jax.ops.segment_sum(cnt, h.seg_ids, h.n_rows + 1,
                                   indices_are_sorted=True)[:h.n_rows]
        sparts.append(rsum)
        cparts.append(rcnt)
        covered = h.n_rows
    for b in dg.buckets:
        if b.flat:
            # flat narrow bucket: grouped sums via einsum against the 0/1
            # group matrix
            from ..ops.tiles import _group_matrix
            gathered = jnp.take(feats, b.adj, axis=0, mode="clip")  # [m,128,F]
            valid = (b.adj < v_pad)
            masked = jnp.where(valid[:, :, None], gathered, 0.0)
            S = _group_matrix(b.width)                               # [128,G]
            ssum = jnp.einsum("mlf,lg->mgf", masked, S,
                              precision=jax.lax.Precision.HIGHEST).reshape(
                -1, f)[:b.rows_pad]
            cnt = jnp.dot(valid.astype(jnp.float32), S,
                          precision=jax.lax.Precision.HIGHEST
                          ).reshape(-1)[:b.rows_pad]
            sparts.append(ssum[:b.rows])
            cparts.append(cnt[:b.rows])
        else:
            gathered = jnp.take(feats, b.adj, axis=0, mode="clip")  # [rp, W, F]
            valid = (b.adj < v_pad)[:, :, None]
            ssum = jnp.sum(jnp.where(valid, gathered, 0.0), axis=1)
            cnt = jnp.sum(valid[:, :, 0], axis=1)
            sparts.append(ssum[:b.rows])
            cparts.append(cnt[:b.rows])
        covered = b.row_start + b.rows
    if covered < v_pad:
        sparts.append(jnp.zeros((v_pad - covered, f), feats.dtype))
        cparts.append(jnp.zeros((v_pad - covered,), jnp.float32))
    ssum = jnp.concatenate(sparts, axis=0)
    cnt = jnp.concatenate([jnp.asarray(c, jnp.float32) for c in cparts])
    return ssum, cnt


def aggregate_mean(graph: VGLGraph, feats: jax.Array,
                   direction: TraversalDirection = G) -> jax.Array:
    """Mean of neighbor features: [v_pad, F] -> [v_pad, F] (sorted ordering of
    `direction`; neighbors = in-neighbors for GATHER)."""
    ssum, cnt = aggregate_sum_count(graph, feats, direction)
    return ssum / jnp.maximum(cnt, 1)[:, None]


def sample_neighbors(graph: VGLGraph, k: int, key,
                     direction: TraversalDirection = S) -> jax.Array:
    """Uniform-with-replacement neighbor sample: int32 [v_pad, k] of sorted ids;
    vertices with no neighbors sample themselves (self-loop fallback)."""
    dg = graph.direction(direction)
    v_pad = graph.v_pad
    deg = dg.degrees
    start = dg.row_ptr[:v_pad]
    u = jax.random.uniform(key, (v_pad, k))
    off = jnp.minimum((u * deg[:, None]).astype(jnp.int32),
                      jnp.maximum(deg - 1, 0)[:, None])
    idx = jnp.take(dg.col_idx, start[:, None] + off, mode="clip")
    self_ids = jnp.broadcast_to(jnp.arange(v_pad, dtype=jnp.int32)[:, None],
                                (v_pad, k))
    return jnp.where((deg > 0)[:, None], idx, self_ids)


def aggregate_sampled_mean(feats: jax.Array, sampled: jax.Array) -> jax.Array:
    """[v_pad, F], [v_pad, k] -> mean of sampled neighbor features."""
    return jnp.mean(jnp.take(feats, sampled, axis=0, mode="clip"), axis=1)


class SageParams(NamedTuple):
    w_self1: jax.Array
    w_nbr1: jax.Array
    b1: jax.Array
    w_self2: jax.Array
    w_nbr2: jax.Array
    b2: jax.Array


def init_sage(key, in_dim: int, hidden: int, out_dim: int) -> SageParams:
    ks = jax.random.split(key, 4)
    s = lambda k, a, b: jax.random.normal(k, (a, b), jnp.float32) / jnp.sqrt(a)
    return SageParams(
        w_self1=s(ks[0], in_dim, hidden), w_nbr1=s(ks[1], in_dim, hidden),
        b1=jnp.zeros(hidden),
        w_self2=s(ks[2], hidden, out_dim), w_nbr2=s(ks[3], hidden, out_dim),
        b2=jnp.zeros(out_dim))


def sage_forward(params: SageParams, graph: VGLGraph, feats: jax.Array,
                 sampled1: jax.Array = None, sampled2: jax.Array = None
                 ) -> jax.Array:
    """2-layer GraphSAGE; full aggregation when sampled==None."""
    agg = (aggregate_mean(graph, feats) if sampled1 is None
           else aggregate_sampled_mean(feats, sampled1))
    h = jax.nn.relu(feats @ params.w_self1 + agg @ params.w_nbr1 + params.b1)
    agg2 = (aggregate_mean(graph, h) if sampled2 is None
            else aggregate_sampled_mean(h, sampled2))
    return h @ params.w_self2 + agg2 @ params.w_nbr2 + params.b2


def make_train_step(graph: VGLGraph, optimizer):
    """Cross-entropy node-classification train step (jittable)."""
    def loss_fn(params, feats, labels, mask, s1, s2):
        logits = sage_forward(params, graph, feats, s1, s2)
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        return jnp.sum(jnp.where(mask, nll, 0.0)) / jnp.maximum(
            jnp.sum(mask), 1)

    @jax.jit
    def step(params, opt_state, feats, labels, mask, s1, s2):
        loss, grads = jax.value_and_grad(loss_fn)(params, feats, labels, mask,
                                                  s1, s2)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), \
            opt_state, loss
    return step


def seq_aggregate_mean(ec, feats: np.ndarray) -> np.ndarray:
    """Oracle: mean of in-neighbor features, original ids, multiplicity kept."""
    v = ec.vertices_count
    acc = np.zeros((v, feats.shape[1]))
    np.add.at(acc, ec.dst_ids, feats[ec.src_ids])
    cnt = np.bincount(ec.dst_ids, minlength=v)
    return acc / np.maximum(cnt, 1)[:, None]
