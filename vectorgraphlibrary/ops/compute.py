"""Compute: per-frontier-vertex map (reference common_compute,
`vgl_compute_api/common/compute.hpp:61-84`; NEC per-sparsity kernels
`nec/compute.hpp:5-60`). Here this is a masked elementwise map over the padded
vertex space — one fused pass regardless of sparsity class."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.frontier import Frontier

# compute_op(vertex_ids, degrees, arrays: Dict[str, Array]) -> Dict[str, Array]
# returns updates for a subset of keys; inactive vertices keep old values.


def compute(graph: VGLGraph,
            arrays: Dict[str, jax.Array],
            compute_op: Callable,
            frontier: Optional[Frontier] = None,
            direction: TraversalDirection = TraversalDirection.SCATTER,
            ) -> Dict[str, jax.Array]:
    if frontier is not None:
        direction = frontier.direction
    dg = graph.direction(direction)
    ids = jnp.arange(graph.v_pad, dtype=jnp.int32)
    updates = compute_op(ids, dg.degrees, arrays)
    real = ids < graph.v
    mask = real if frontier is None else (frontier.mask & real)
    out = dict(arrays)
    for k, new in updates.items():
        old = arrays[k]
        m = mask[:, None] if new.ndim > 1 else mask
        out[k] = jnp.where(m, new, old)
    return out
