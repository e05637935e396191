"""Combine monoids for edge-message aggregation.

The reference expresses combination inside user lambdas with vector-register
accumulators + post-reduce (`nec/vector_register/vector_registers.h:3-60`) or atomics
(`architecture_independent_api.h:47-69`). Here combination is an explicit
monoid so every advance lowers to dense reductions / segment reductions — races
disappear into functional semantics (SURVEY.md §5 "race detection").
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Monoid:
    name: str
    combine: Callable                 # elementwise binary op
    reduce_axis: Callable             # (arr, axis) -> reduced
    segment_reduce: Callable          # (data, seg_ids, num_segments, sorted) -> arr

    def identity(self, dtype):
        d = jnp.dtype(dtype)
        if self.name == "add":
            return jnp.zeros((), d)
        if self.name == "min":
            return (jnp.array(jnp.iinfo(d).max, d) if jnp.issubdtype(d, jnp.integer)
                    else jnp.array(jnp.inf, d))
        if self.name == "max":
            if d == jnp.dtype(bool):
                return jnp.array(False)
            return (jnp.array(jnp.iinfo(d).min, d) if jnp.issubdtype(d, jnp.integer)
                    else jnp.array(-jnp.inf, d))
        if self.name == "or":
            return jnp.zeros((), d)
        raise ValueError(self.name)

    def scatter_at(self, target, idx, vals, mode="drop"):
        at = target.at[idx]
        if self.name == "add":
            return at.add(vals, mode=mode)
        if self.name == "min":
            return at.min(vals, mode=mode)
        if self.name == "max":
            return at.max(vals, mode=mode)
        if self.name == "or":
            if target.dtype == bool or vals.dtype == bool:
                return at.max(vals, mode=mode)
            # int bitmask OR-scatter: jnp has no at[].or_; decompose as an
            # exact two-halves trick is wrong under collisions, so scatter
            # per-bit would be needed — forbid instead of corrupting
            raise NotImplementedError(
                "int bitwise-or scatter: use a pull/segment formulation "
                "(at[].max only equals OR for {0,1} values)")
        raise ValueError(self.name)


ADD = Monoid("add", jnp.add, jnp.sum, jax.ops.segment_sum)
MIN = Monoid("min", jnp.minimum, jnp.min, jax.ops.segment_min)
MAX = Monoid("max", jnp.maximum, jnp.max, jax.ops.segment_max)
def _or_combine(a, b):
    return jnp.logical_or(a, b) if a.dtype == bool else jnp.bitwise_or(a, b)


def _or_reduce(a, axis):
    if a.dtype == bool:
        return jnp.any(a, axis=axis)
    return jax.lax.reduce(a, jnp.zeros((), a.dtype), jax.lax.bitwise_or, (axis,))


def _or_segment(data, seg_ids, num_segments, indices_are_sorted=False):
    if data.dtype == bool:
        return jax.ops.segment_max(data, seg_ids, num_segments,
                                   indices_are_sorted=indices_are_sorted)
    # int bitmask OR over sorted segments via shift-doubling segmented scan:
    # after log2(n) steps every element holds the OR of its segment prefix,
    # and segment_max recovers the full segment OR. The max MUST run UNSIGNED:
    # a signed max mis-orders values with bit 31 set, and — worse — empty
    # segments take the signed identity int32_min = 0x8000_0000, spuriously
    # setting bit 31 on every gap row (caught by the 32-root MS-BFS test).
    # Unsigned, OR-accumulation is monotone and the empty identity is 0.
    n = data.shape[0]
    x = data.astype(jnp.uint32) if data.dtype != jnp.uint32 else data
    s = 1
    while s < n:
        shifted = jnp.concatenate([jnp.zeros((s,), x.dtype), x[:-s]])
        same = jnp.concatenate([
            jnp.zeros((s,), seg_ids.dtype) - 1, seg_ids[:-s]]) == seg_ids
        x = jnp.where(same, x | shifted, x)
        s *= 2
    out = jax.ops.segment_max(x, seg_ids, num_segments,
                              indices_are_sorted=indices_are_sorted)
    return out.astype(data.dtype)


# logical-or over bool (BFS reachability) / bitwise-or over ints (coloring bitmasks)
OR = Monoid("or", _or_combine, _or_reduce, _or_segment)

MONOIDS = {"add": ADD, "min": MIN, "max": MAX, "or": OR}


def get(name_or_monoid) -> Monoid:
    if isinstance(name_or_monoid, Monoid):
        return name_or_monoid
    return MONOIDS[name_or_monoid]
