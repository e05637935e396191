"""Runtime facade: init → prepare_graph → run → report.

Capability match for `VGL_RUNTIME` (`vgl_runtime/vgl_runtime.h:40-59`, `.hpp:5-128`):
init_library (device/distributed init + banner), prepare_graph (generate / load /
import + preprocessing + weights), start/stop_measuring_stats, report_performance
(AVG_PERF contract), finalize_library.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..config import VGLConfig, SyntheticGraphType
from ..graph.device import VGLGraph, import_graph
from ..graph.edges import EdgeArray, build_edge_array_from_host
from ..io import generation
from ..io.edges_container import EdgesContainer
from .perf_stats import performance_stats


def init_library(cfg: VGLConfig) -> None:
    """Device/distributed init + topology banner (reference init.hpp:26-37)."""
    import jax
    from ..parallel.mesh import init_distributed
    from .cache import enable_persistent_cache
    enable_persistent_cache()
    init_distributed()
    devs = jax.devices()
    print(f"VGL init: process {jax.process_index()}/{jax.process_count()}, "
          f"{len(devs)} device(s): {devs[0].platform}")


def load_edges(cfg: VGLConfig) -> EdgesContainer:
    if cfg.load_path:
        return EdgesContainer.load_from_binary_file(cfg.load_path)
    if cfg.import_path:
        from ..io.konect import import_konect
        return import_konect(cfg.import_path)
    kind = "rmat" if cfg.synthetic_type == SyntheticGraphType.RMAT else "ru"
    return generation.generate(kind, cfg.scale, cfg.avg_degree, cfg.seed)


def prepare_graph(cfg: VGLConfig, need_weights: bool = False
                  ) -> Tuple[EdgesContainer, VGLGraph, Optional[EdgeArray]]:
    """Generate/load + import + (optionally) bind weights; the reference's
    VGL_RUNTIME::prepare_graph (vgl_runtime.hpp:27-80)."""
    ec = load_edges(cfg)
    if need_weights and ec.weights is None:
        ec = ec.with_random_weights(cfg.seed + 1)
    if cfg.autotune_format:
        from ..utils.autotuner import default_tuner
        cfg = default_tuner().apply(ec, cfg)
        print(f"autotuner: format={cfg.graph_format.value} "
              f"huge_threshold={cfg.huge_degree_threshold}")
    host = []
    graph = import_graph(ec, cfg, cfg.graph_format, _host_out=host)
    weights = None
    if need_weights:
        weights = build_edge_array_from_host(ec.weights, graph, host[0], host[1])
    return ec, graph, weights


def start_measuring_stats() -> None:
    performance_stats.start_measuring_stats()


def stop_measuring_stats() -> None:
    performance_stats.stop_measuring_stats()
    performance_stats.print_timers_stats()


def report_performance(name: str) -> float:
    return performance_stats.report_performance(name)


def finalize_library() -> None:
    pass
