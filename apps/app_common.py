"""Shared benchmark-app skeleton.

Every app follows the reference main shape (`apps/bfs/bfs.cpp:15-62`):
init → parse → prepare_graph → rounds{run, optional -check} → stats → AVG_PERF.
"""
from __future__ import annotations

import sys
import time

import jax
import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])   # repo root

import vectorgraphlibrary as vgl
from vectorgraphlibrary.models import common
from vectorgraphlibrary.runtime import cli, runtime
from vectorgraphlibrary.runtime.perf_stats import performance_stats


def run_app(app_name: str, run_round, check_round=None, need_weights: bool = False,
            needs_source: bool = True, argv=None) -> int:
    """run_round(ec, graph, weights, source, cfg) -> result (pytree synced for
    timing); check_round(ec, graph, weights, source, result, cfg) -> error count."""
    cfg = cli.parse_args(argv, app_name)
    runtime.init_library(cfg)
    ec, graph, weights = runtime.prepare_graph(cfg, need_weights=need_weights)
    print(f"graph: |V|={graph.v} |E|={graph.e} format={cfg.graph_format.value}")

    # one untimed warmup round: jit compilation would otherwise land in the
    # first measured round and dominate AVG_PERF
    warm_source = common.select_random_source(ec, seed=cfg.seed) \
        if needs_source else None
    jax.block_until_ready(run_round(ec, graph, weights, warm_source, cfg))

    from vectorgraphlibrary.runtime import profiling

    runtime.start_measuring_stats()
    total_errors = 0
    with profiling.trace(profiling.trace_dir_from_env()):
        for it in range(cfg.iterations):
            source = common.select_random_source(ec, seed=cfg.seed + it) \
                if needs_source else None
            t0 = time.perf_counter()
            with profiling.step_annotate(app_name, it):
                result = run_round(ec, graph, weights, source, cfg)
                jax.block_until_ready(result)
            dt = time.perf_counter() - t0
            performance_stats.save_algorithm_performance_stats(
                app_name, dt, graph.e)
            if cfg.check and check_round is not None:
                total_errors += check_round(ec, graph, weights, source, result,
                                            cfg)
    performance_stats.stop_measuring_stats()   # freeze rounds wall time
    # reference-style per-primitive table (ms / GB/s / %roofline / MTEPS):
    # one eager measured pass over the framework primitives on this graph
    # (performance_stats.hpp:471-479 analog); skip with -no-prim-stats
    if getattr(cfg, "prim_stats", True):
        from vectorgraphlibrary.runtime import prim_profile
        prim_profile.profile_graph_primitives(graph, weights)
    performance_stats.print_timers_stats()
    runtime.report_performance(app_name)
    runtime.finalize_library()
    return 1 if (cfg.check and total_errors > 0) else 0
