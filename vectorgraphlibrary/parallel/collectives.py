"""The three vertex-array exchange policies as XLA collectives.

Reference (`vgl_compute_api/common/mpi_exchange.hpp`, SURVEY.md §2.4.5):
- EXCHANGE_ALL (:78-187): ring MPI_Sendrecv of full arrays + merge_op
  → here: ``merge_all`` = psum/pmin/pmax over the edge axis (XLA lowers to
  ICI-optimal reduce);
- EXCHANGE_RECENTLY_CHANGED (:14-53): copy_if delta compaction + ring + merge
  → here: ``merge_changed`` masks unchanged entries to the merge identity and
  reduces with a dense masked allreduce of V values (``merge_changed_sparse``
  is the compacted-delta form);
- EXCHANGE_PRIVATE_DATA (:193-271): MPI_Allgatherv of owned vertex ranges
  → here: ``gather_private`` = all_gather over the vertex axis.

All functions are meant to be called INSIDE shard_map bodies.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .mesh import EDGE_AXIS, VERTEX_AXIS

_MERGE = {
    "add": lambda x, ax: jax.lax.psum(x, ax),
    "min": lambda x, ax: jax.lax.pmin(x, ax),
    "max": lambda x, ax: jax.lax.pmax(x, ax),
    # unsigned max == bitwise-or merge for replicated monotone frontiers; a
    # SIGNED pmax would mis-order int words with bit 31 set (ops/monoid.py)
    "or": lambda x, ax: jax.lax.pmax(x.astype(jnp.uint32), ax).astype(x.dtype),
}


def merge_all(x, merge_op: str, axis: str = EDGE_AXIS):
    """EXCHANGE_ALL analog: elementwise merge of per-device candidate arrays."""
    return _MERGE[merge_op](x, axis)


def merge_changed(x, prev, merge_op: str, axis: str = EDGE_AXIS):
    """EXCHANGE_RECENTLY_CHANGED analog, dense form: only changed entries
    participate; the merge identity stands in for 'not sent' (reference
    merge_op path :146-150). For the compacted-delta form the reference
    actually sends (`mpi_exchange.hpp:14-53`), see merge_changed_sparse."""
    if merge_op == "add":
        return prev + jax.lax.psum(x - prev, axis)
    if merge_op == "min":
        ident = jnp.array(jnp.inf, x.dtype) if jnp.issubdtype(
            x.dtype, jnp.floating) else jnp.array(jnp.iinfo(x.dtype).max, x.dtype)
        return jnp.minimum(prev, jax.lax.pmin(jnp.where(x != prev, x, ident), axis))
    if merge_op == "max":
        ident = jnp.array(-jnp.inf, x.dtype) if jnp.issubdtype(
            x.dtype, jnp.floating) else jnp.array(jnp.iinfo(x.dtype).min, x.dtype)
        return jnp.maximum(prev, jax.lax.pmax(jnp.where(x != prev, x, ident), axis))
    if merge_op == "or":
        # or-merge is idempotent and monotone: unchanged entries equal prev,
        # so the plain elementwise or of every device's view IS the
        # changed-only merge (BFS-style distributed frontier merges hit this);
        # max runs UNSIGNED for the same bit-31 reason as _MERGE above
        return prev | jax.lax.pmax(x.astype(jnp.uint32), axis).astype(x.dtype)
    raise ValueError(merge_op)


def _compact_delta(x, prev, capacity: int):
    """Per-device copy_if of changed (index, value) pairs into a static
    [capacity] buffer (the reference's prepare_exchange_data,
    mpi_exchange.hpp:14-53). Returns (idx, val, count); overflow entries are
    dropped — callers must guard with the collective overflow test."""
    n = x.shape[0]
    changed = x != prev
    pos = jnp.cumsum(changed.astype(jnp.int32)) - 1
    slot = jnp.where(changed, jnp.minimum(pos, capacity - 1), capacity)
    arange = jnp.arange(n, dtype=jnp.int32)
    idx = jnp.full((capacity + 1,), n, jnp.int32).at[slot].set(
        arange, mode="drop")[:capacity]
    val = jnp.take(x, jnp.minimum(idx, n - 1), mode="clip")
    count = jnp.sum(changed, dtype=jnp.int32)
    return idx, val, count


def delta_capacity_policy(n: int, n_devices: int,
                          requested: int | None = None) -> int:
    """Clamp a merge_changed_sparse capacity so the sparse branch can never
    move more bytes than the dense fallback it is supposed to beat.

    Bytes per device: sparse ≈ 8·D·cap in (all_gather of int32 idx + 4-byte
    val from every device) + 8·cap out; dense ring allreduce ≈ 8·n (4-byte
    payload in+out). Equal-bytes crossover: cap* = n/D. The policy keeps 4×
    headroom (scatter-merge cost and all_gather latency grow with D):
    cap = min(requested or n/64, n/(4·D)), floor 64. Validated by
    tests/test_sharded2.py::test_delta_capacity_policy at D=8."""
    cross = max(64, n // (4 * max(n_devices, 1)))
    if requested is None:
        requested = max(256, n // 64)
    return max(64, min(requested, cross))


def merge_changed_sparse(x, prev, merge_op: str, capacity: int,
                         axis: str = EDGE_AXIS):
    """EXCHANGE_RECENTLY_CHANGED, compacted form: each device copy_if-compacts
    its changed (index, value) deltas into a fixed-capacity buffer, the
    buffers ride ONE all_gather (the XLA collective that replaces the
    reference's power-of-two-shifted MPI_Sendrecv ring,
    mpi_exchange.hpp:156-187), and every device scatter-merges the gathered
    deltas locally. Falls back to the dense masked allreduce when ANY device's
    delta overflows `capacity` (lax.cond — both branches compiled, one runs).

    Convergence tails of SSSP/CC change a handful of vertices per iteration:
    the sparse branch then moves D*capacity*(8..12) bytes instead of the dense
    path's full-array reduce. Crossover: capacity ≈ v_pad / (3*D) equalizes
    bytes; pick capacity well below that (e.g. v_pad/64)."""
    if merge_op not in ("min", "max", "add", "or"):
        raise ValueError(merge_op)
    n = x.shape[0]

    def sparse(_):
        idx, val, _ = _compact_delta(x, prev, capacity)
        gi = jax.lax.all_gather(idx, axis)          # [D, cap]
        gv = jax.lax.all_gather(val, axis)
        gi_f = gi.reshape(-1)
        gv_f = gv.reshape(-1)
        safe = jnp.where(gi_f < n, gi_f, n)         # idx==n (pad) -> dropped
        at = prev.at[safe]
        if merge_op == "min":
            return at.min(gv_f, mode="drop")
        if merge_op == "max":
            return at.max(gv_f, mode="drop")
        if merge_op == "or":
            return at.max(gv_f, mode="drop")        # or over {0,1}
        # add: deltas accumulate relative to prev
        delta = gv_f - jnp.take(prev, safe, mode="clip")
        return at.add(jnp.where(gi_f < n, delta, jnp.zeros_like(delta)),
                      mode="drop")

    def dense(_):
        return merge_changed(x, prev, merge_op, axis)

    worst = jax.lax.pmax(jnp.sum(x != prev, dtype=jnp.int32), axis)
    return jax.lax.cond(worst <= capacity, sparse, dense, None)


def gather_private(x_local, axis: str = VERTEX_AXIS):
    """EXCHANGE_PRIVATE_DATA analog: allgather owned contiguous vertex ranges."""
    return jax.lax.all_gather(x_local, axis, tiled=True)


def scatter_to_owner(values, global_idx, v_local: int, axis: str = VERTEX_AXIS,
                     combine: str = "add", init=None):
    """Scatter edge-parallel messages into this device's owned vertex range;
    out-of-range indices drop (they belong to other devices' ranges)."""
    rank = jax.lax.axis_index(axis)
    local = global_idx - rank * v_local
    # negative indices WRAP in JAX scatter (python indexing semantics); force
    # out-of-range destinations to an out-of-bounds slot so mode="drop" applies
    local = jnp.where((local >= 0) & (local < v_local), local, v_local)
    out = (jnp.zeros((v_local,), values.dtype) if init is None else init)
    at = out.at[local]
    if combine == "add":
        return at.add(values, mode="drop")
    if combine == "min":
        return at.min(values, mode="drop")
    if combine == "max":
        return at.max(values, mode="drop")
    raise ValueError(combine)
