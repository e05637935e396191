"""Profiling / tracing hooks.

Analog of the reference's tracing stack (SURVEY §5): the reference
combines its `performance_stats` singleton with NEC ftrace compiler hooks
(`graph_library.h:22-24`, `apps/Makefile:36-38`). Here the per-primitive
accounting lives in runtime/perf_stats.py; this module adds the hardware-level
layer — jax.profiler (xprof/tensorboard) traces with named annotations per
abstraction call, switchable by env or API, with no overhead when disabled.

Usage:
    from vectorgraphlibrary.runtime import profiling
    with profiling.trace("/tmp/vgl_trace"):       # writes an xprof trace
        with profiling.annotate("advance:pr"):
            ranks, _ = pr.vgl_page_rank(graph)

Env: VGL_TRACE_DIR=<dir> makes apps (apps/app_common.py) wrap their measured
rounds in a trace automatically — the equivalent of rebuilding the reference
with `-ftrace`.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import jax

TRACE_DIR_ENV = "VGL_TRACE_DIR"


def trace_dir_from_env() -> Optional[str]:
    return os.environ.get(TRACE_DIR_ENV) or None


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace context; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region visible in the xprof timeline (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


def step_annotate(name: str, step: int):
    """Per-iteration StepTraceAnnotation (feeds xprof's step-time analysis)."""
    return jax.profiler.StepTraceAnnotation(name, step_num=step)


def device_memory_profile(path: str) -> None:
    """Dump a pprof-format device memory profile (HBM residency by callsite)."""
    with open(path, "wb") as f:
        f.write(jax.profiler.device_memory_profile())
