"""Wall-clock timing (reference `vgl_runtime/helpers/timer/timer.h:5-38`).

Async dispatch means a bare wall-clock lies; ``DeviceTimer`` blocks on the
result pytree before reading the clock (the analog of the reference's CUDA-event
timing path).
"""
from __future__ import annotations

import time

import jax


class Timer:
    def __init__(self):
        self._start = 0.0
        self._elapsed = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        self._elapsed = time.perf_counter() - self._start
        return self._elapsed

    @property
    def seconds(self) -> float:
        return self._elapsed

    @property
    def ms(self) -> float:
        return self._elapsed * 1.0e3

    def print_bandwidth_stats(self, name: str, bytes_moved: float) -> None:
        gbps = bytes_moved / max(self._elapsed, 1e-12) / 1.0e9
        print(f"{name} time: {self.ms:.3f} ms, bandwidth: {gbps:.2f} GB/s")


class DeviceTimer(Timer):
    """Timer that synchronizes device work at stop()."""

    def stop(self, result=None) -> float:
        if result is not None:
            jax.block_until_ready(result)
        return super().stop()


def block(tree):
    """Block until every array in a pytree is ready; returns the tree."""
    return jax.block_until_ready(tree)
