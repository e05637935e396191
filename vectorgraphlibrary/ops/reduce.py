"""Reduce: sum/max/min over frontier-vertex values (reference common_reduce,
`vgl_compute_api/common/reduce.hpp:3-66`; NEC OpenMP reductions `nec/reduce.hpp:5-73`).
One masked jnp reduction."""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..config import TraversalDirection
from ..graph.device import VGLGraph
from ..graph.frontier import Frontier
from . import monoid as M


def reduce(graph: VGLGraph,
           values: jax.Array,
           op,
           frontier: Optional[Frontier] = None,
           direction: TraversalDirection = TraversalDirection.SCATTER,
           ) -> jax.Array:
    mon = M.get(op)
    v_pad = values.shape[0]
    real = jnp.arange(v_pad, dtype=jnp.int32) < graph.v
    mask = real if frontier is None else (frontier.mask & real)
    ident = mon.identity(values.dtype)
    masked = jnp.where(mask if values.ndim == 1 else mask[:, None], values, ident)
    return mon.reduce_axis(masked, 0)
