"""Run-time environment rules: where the compile cache lives, which cards
and which have a roofline peak."""
import os

import numpy as np
import pytest
import jax

from vectorgraphlibrary.runtime import cache
from vectorgraphlibrary.runtime.perf_stats import (PerformanceStats,
                                                   hbm_peak_gbps)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_enable_persistent_cache_uses_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        cache.enable_persistent_cache()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA H100 PCIe", 2000.0)])
def test_peak_table_known_cards(kind, peak):
    assert hbm_peak_gbps(kind) == peak


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"])
def test_peak_table_refuses_unknown_kinds(kind):
    assert hbm_peak_gbps(kind) is None


def test_stats_print_no_roofline_for_unknown_device(capsys):
    st = PerformanceStats()
    st.update("pull", 0.001, 1e9, 1e6)
    st.print_timers_stats()          # CPU device: not in the peak table
    row = [l for l in capsys.readouterr().out.splitlines()
           if l.startswith("pull")][0]
    name, ms, share, gbps, roof, mteps, calls = row.split()
    assert (gbps, roof) == ("1000.0", "-")
