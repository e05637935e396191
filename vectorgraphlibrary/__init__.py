"""vectorgraphlibrary — a JAX graph-processing framework.

JAX/XLA framework with the capability surface of
afanasyev-ilya/VectorGraphLibrary (the NEC SX-Aurora vector graph framework): a
degree-sorted, tile-padded storage layer; five data-parallel primitives
(advance-pull/gather, advance-push/scatter, compute, reduce, generate_new_frontier)
with sparsity-adaptive frontiers; the full algorithm family in `models/`; multi-card
execution via shard_map collectives in `parallel/`; and a benchmark/verification
harness matching the reference's AVG_PERF / "error count:" contracts.
"""

from .config import (VGLConfig, DEFAULT_CONFIG, GraphFormat, Sparsity,
                     SyntheticGraphType, TraversalDirection)
from .io.edges_container import EdgesContainer
from .io import generation
from .graph.device import VGLGraph, import_graph
from .graph.vertices import VertexArray, vertex_array, reorder, as_original_numpy
from .graph.edges import EdgeArray, build_edge_array_from_host, edge_array_from_flat
from .graph import frontier as frontier_api
from .graph.frontier import Frontier
from .ops.advance import advance_pull, advance_push_sparse
from .ops.compute import compute
from .ops.reduce import reduce
from .ops.frontier_ops import generate_new_frontier
from .ops import monoid
from .runtime.perf_stats import performance_stats, PerformanceStats
from .runtime.timer import Timer, DeviceTimer

__version__ = "0.1.0"
