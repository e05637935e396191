"""Tile-layout helpers for narrow (flat, 128-wide) buckets.

Flat buckets pack 128/width vertex-rows per 128-wide array row (see
graph/device.py TileBucket); these helpers do the per-row (grouped) reductions:
- grouped sum  = one matmul against a 0/1 group matrix;
- grouped min/max/or = log2(width) pair-halving strided slices.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import monoid as M


@functools.lru_cache(maxsize=None)
def _group_matrix_np(width: int) -> np.ndarray:
    return (np.arange(128)[:, None] // width ==
            np.arange(128 // width)[None, :]).astype(np.float32)


def _group_matrix(width: int):
    """S[l, g] = 1 if lane l belongs to group g (128/width groups). Only the
    NumPy array is cached — caching a jnp constant would leak tracers."""
    return jnp.asarray(_group_matrix_np(width))


def group_reduce_flat(msg2d: jax.Array, width: int, mon, rows: int) -> jax.Array:
    """(m, 128) lane-major masked messages -> per-vertex-row reduction [rows].
    Messages must already carry the monoid identity in invalid slots.

    add (float) and or (bool) go through one matmul against the group matrix;
    int add through two exact matmuls; min/max/or-words through a
    pair-halving tree of strided slices."""
    m = msg2d.shape[0]
    if mon.name == "add" and jnp.issubdtype(msg2d.dtype, jnp.floating):
        red = jnp.dot(msg2d, _group_matrix(width),
                      preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
        return red.reshape(-1)[:rows].astype(msg2d.dtype)
    if mon.name == "or" and msg2d.dtype == jnp.dtype(bool):
        red = jnp.dot(msg2d.astype(jnp.float32), _group_matrix(width),
                      preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
        return (red > 0).reshape(-1)[:rows]
    if mon.name == "add" and jnp.issubdtype(msg2d.dtype, jnp.integer):
        # exact for ANY int32: split each value into hi = v >> 16 (arithmetic,
        # sign-carrying, |hi| < 2^15) and lo = v & 0xFFFF (< 2^16); each partial
        # row sum stays < 128 * 2^16 = 2^23 < 2^24, so both f32 matmuls are exact
        # and v = hi * 65536 + lo recombines losslessly
        g = _group_matrix(width)
        hi = jnp.dot((msg2d >> 16).astype(jnp.float32), g,
                     preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
        lo = jnp.dot((msg2d & 0xFFFF).astype(jnp.float32), g,
                     preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
        red = hi.astype(jnp.int64 if msg2d.dtype.itemsize > 4 else jnp.int32
                        ) * 65536 + lo.astype(jnp.int32)
        return red.reshape(-1)[:rows].astype(msg2d.dtype)
    # min/max/or-words: pair-halving strided tree; every intermediate stays
    # 2-D, ~log2(w) passes over shrinking arrays.
    x = msg2d
    w = width
    while w > 1:
        x = mon.combine(x[:, ::2], x[:, 1::2])
        w //= 2
    return x.reshape(-1)[:rows]


def row_ids_flat(row_start: int, width: int, m: int) -> jax.Array:
    """(m, 128) int32: owning vertex-row id of each lane-major slot."""
    flat = (jax.lax.broadcasted_iota(jnp.int32, (m, 128), 0) * 128 +
            jax.lax.broadcasted_iota(jnp.int32, (m, 128), 1))
    return row_start + flat // width
