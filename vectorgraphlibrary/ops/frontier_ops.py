"""generate_new_frontier: filter vertices by a condition into a new Frontier.

Reference: `vgl_compute_api/common/generate_new_frontier.hpp:3-43` + the NEC worker
that flags, counts per part, and switches representation by density thresholds
(`nec/generate_new_frontier.hpp:209-325`). Here: one fused pass produces the
dense mask + active/neighbour counts; the host reads the two scalars when it needs to
pick a sparse-vs-dense kernel for the next advance (direction-optimizing heuristics),
which is the same per-iteration host decision the reference makes.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..config import Sparsity, TraversalDirection, VGLConfig, DEFAULT_CONFIG
from ..graph.device import VGLGraph
from ..graph.frontier import Frontier, classify_sparsity

# cond(ids, degrees, arrays) -> bool [v_pad]


def generate_new_frontier(graph: VGLGraph,
                          cond: Callable,
                          arrays,
                          direction: TraversalDirection = TraversalDirection.SCATTER,
                          cfg: VGLConfig = DEFAULT_CONFIG,
                          classify_on_host: bool = False) -> Frontier:
    dg = graph.direction(direction)
    ids = jnp.arange(graph.v_pad, dtype=jnp.int32)
    mask = cond(ids, dg.degrees, arrays) & (ids < graph.v)
    size = jnp.sum(mask, dtype=jnp.int32)
    nbr = jnp.sum(jnp.where(mask, dg.degrees, 0), dtype=jnp.int32)
    sparsity = Sparsity.DENSE
    if classify_on_host:
        ratio = float(size) / max(graph.v, 1)
        sparsity = classify_sparsity(ratio, cfg.dense_frontier_threshold)
    return Frontier(mask=mask, size=size, neighbours_count=nbr,
                    direction=direction, sparsity=sparsity)
