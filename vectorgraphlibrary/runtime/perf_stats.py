"""Per-primitive performance accounting.

Re-design of the reference's global ``performance_stats`` singleton
(`vgl_runtime/helpers/performance_stats/performance_stats.h:11-104`): every abstraction
call accrues wall time, a bytes-model estimate, and edges visited; reporting prints the
same MTEPS ("Wall (graph500) perf" = edges/(time*1e6), `performance_stats.hpp:259-262`)
and sustained-GB/s roofline lines (`performance_stats.hpp:279-316`), plus the
``AVG_PERF`` / ``MIN_PERF`` / ``MAX_PERF`` contract (`vgl_runtime.hpp:125-128`,
`performance_stats.hpp:388-446`) parsed by the harness.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional

import jax

# Peak device-memory bandwidth (GB/s) by JAX device_kind, from NVIDIA's H100
# data sheet; used for % of roofline reporting the way the reference pins
# 1.2-1.5 TB/s for the SX-Aurora VE (README.md:16). A kind that is not listed
# gets no roofline share: no peak is assumed.
HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,     # H100 SXM5
    "NVIDIA H100 PCIe": 2000.0,
}


def hbm_peak_gbps(device_kind: str) -> Optional[float]:
    return HBM_PEAK_GBPS.get(device_kind)


class PrimitiveStat:
    __slots__ = ("wall_s", "bytes_requested", "edges_visited", "calls")

    def __init__(self):
        self.wall_s = 0.0
        self.bytes_requested = 0.0
        self.edges_visited = 0.0
        self.calls = 0


class PerformanceStats:
    """Accumulates per-primitive stats between reset_timers()/stop cycles."""

    def __init__(self, hbm_roofline_gbps: Optional[float] = None):
        # None: look the peak up from the device kind when reporting
        self.hbm_roofline_gbps = hbm_roofline_gbps
        self.reset_timers()
        self._sample_perf: Dict[str, List[float]] = collections.defaultdict(list)

    # -- lifecycle (reference performance_stats.h:30-60) --
    def reset_timers(self) -> None:
        self.stats: Dict[str, PrimitiveStat] = collections.defaultdict(PrimitiveStat)
        self._inner_wall_start = time.perf_counter()
        self.inner_wall_s = 0.0

    def start_measuring_stats(self) -> None:
        self.reset_timers()

    def stop_measuring_stats(self) -> None:
        self.inner_wall_s = time.perf_counter() - self._inner_wall_start

    # -- accrual (reference advance_worker.hpp:347-360, compute.hpp:67-83) --
    @contextlib.contextmanager
    def timed(self, primitive: str, bytes_requested: float = 0.0,
              edges_visited: float = 0.0, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        st = self.stats[primitive]
        st.wall_s += time.perf_counter() - t0
        st.bytes_requested += bytes_requested
        st.edges_visited += edges_visited
        st.calls += 1

    def update(self, primitive: str, wall_s: float, bytes_requested: float = 0.0,
               edges_visited: float = 0.0) -> None:
        st = self.stats[primitive]
        st.wall_s += wall_s
        st.bytes_requested += bytes_requested
        st.edges_visited += edges_visited
        st.calls += 1

    # -- per-run sample perf (MTEPS per round) --
    def save_algorithm_performance_stats(self, name: str, wall_s: float,
                                         edges_count: int) -> None:
        mteps = edges_count / max(wall_s, 1e-12) / 1.0e6
        self._sample_perf[name].append(mteps)

    # -- reporting (reference performance_stats.hpp:259-316, 388-446) --
    def print_timers_stats(self) -> None:
        total = sum(s.wall_s for s in self.stats.values())
        inner = self.inner_wall_s if self.inner_wall_s > 0 else total
        peak = (self.hbm_roofline_gbps if self.hbm_roofline_gbps is not None
                else hbm_peak_gbps(jax.devices()[0].device_kind))
        print(f"{'primitive':<24}{'ms':>10}{'%':>8}{'GB/s':>10}{'%roof':>8}"
              f"{'MTEPS':>10}{'calls':>7}")
        for name in sorted(self.stats, key=lambda n: -self.stats[n].wall_s):
            st = self.stats[name]
            gbps = st.bytes_requested / max(st.wall_s, 1e-12) / 1.0e9
            mteps = st.edges_visited / max(st.wall_s, 1e-12) / 1.0e6
            roof = (f"{100*gbps/peak:>7.1f}%" if peak is not None
                    else f"{'-':>8}")
            print(f"{name:<24}{st.wall_s*1e3:>10.2f}{100*st.wall_s/max(inner,1e-12):>7.1f}%"
                  f"{gbps:>10.1f}{roof}{mteps:>10.1f}{st.calls:>7}")
        print(f"{'inner wall':<24}{inner*1e3:>10.2f}")

    def report_performance(self, name: str) -> float:
        """Prints the AVG_PERF/MIN_PERF/MAX_PERF MTEPS contract; returns avg MTEPS."""
        samples = self._sample_perf.get(name, [])
        if not samples:
            print(f"AVG_PERF: 0 MTEPS")
            return 0.0
        avg = sum(samples) / len(samples)
        print(f"{name} wall (graph500) perf: {avg:.2f} MTEPS")
        print(f"AVG_PERF: {avg:.2f} MTEPS")
        print(f"MIN_PERF: {min(samples):.2f} MTEPS")
        print(f"MAX_PERF: {max(samples):.2f} MTEPS")
        return avg


# Global singleton, mirroring the reference's `performance_stats` global.
performance_stats = PerformanceStats()
