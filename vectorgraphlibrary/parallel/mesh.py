"""Device mesh construction for multi-card execution.

The reference scales with MPI — each rank holds the full graph and advances only its
vertex slice, then re-synchronizes vertex arrays (`vect_csr_graph.h:44-48`,
`common/mpi_exchange.hpp`). Replacement (SURVEY.md §2.4.5 analog): a 2-D
`jax.sharding.Mesh` with axes

- ``"e"`` (edge-parallel): edges are partitioned across devices; partial per-vertex
  accumulators are merged with ``psum``/``pmin``/``pmax`` over this axis — the analog
  of the reference's work-partitioned advance + merge-op exchange;
- ``"v"`` (vertex-partition): per-vertex state is range-partitioned; full views are
  produced by ``all_gather`` over this axis — the analog of EXCHANGE_PRIVATE_DATA's
  per-part MPI_Allgatherv (mpi_exchange.hpp:193-271).

Collectives within a host ride NVLink (XLA hands them to NCCL); multi-host
runs use standard `jax.distributed.initialize` (init_distributed below).
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

EDGE_AXIS = "e"
VERTEX_AXIS = "v"


def make_mesh(n_edge: int = None, n_vertex: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_edge is None:
        n_edge = n // n_vertex
    assert n_edge * n_vertex == n, (n_edge, n_vertex, n)
    arr = np.asarray(devices).reshape(n_edge, n_vertex)
    return Mesh(arr, (EDGE_AXIS, VERTEX_AXIS))


def default_mesh(n_devices: int = None) -> Mesh:
    """Pick a (n_e, n_v) factorization: prefer 2 vertex partitions when possible."""
    n = n_devices or len(jax.devices())
    devices = jax.devices()[:n]
    n_v = 2 if n % 2 == 0 and n >= 2 else 1
    return make_mesh(n // n_v, n_v, devices)


def init_distributed():
    """Multi-host initialization (DCN): standard JAX distributed runtime — the
    analog of LibraryData::init's MPI_Init (library_data/init.hpp:5-14)."""
    import os
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def edge_sharded(mesh: Mesh):
    return NamedSharding(mesh, P(EDGE_AXIS))


def vertex_sharded(mesh: Mesh):
    return NamedSharding(mesh, P(VERTEX_AXIS))
