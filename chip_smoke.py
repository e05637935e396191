"""Smoke run of the graph library on NVIDIA GPUs, checked against its oracles.

    python chip_smoke.py             # one card
    python chip_smoke.py --cards 4   # four cards of one host

One card: first the tests marked `gpu` run in this process; then RMAT scale
22, edge factor 32, weighted (4,194,304 vertices, 134,217,728 edges — the
reference's smallest real tier) goes through `runtime.prepare_graph` as
TILE_CSR, the path every app takes; then the hot pulls, PageRank,
direction-optimizing BFS, all-active SSSP and Shiloach-Vishkin CC each run
once to compile and once timed, and are checked against the NumPy/SciPy
oracles.

Four cards: the same graph, sharded over a 1-D mesh of four cards; sharded
PageRank, CC and BFS are compared with the single-card run on card 0 and with
the oracles. Nothing else runs.

The script owns the card(s): it is one JAX process and starts no other. It
refuses (exit code 1, no result line) when JAX's default device is not a GPU.
The last line of stdout is the result: {"ok": true, "device": {...}}.
Any failed check raises, so the process exits non-zero without that line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cuda")

SCALE, EDGE_FACTOR, SEED = 22, 32, 42
PR_ITERATIONS = 10
# PageRank sums f32 messages in an order XLA's GPU reductions do not fix, and
# the oracle sums in f64: each rank must agree to 1e-3 relative, or to 1e-3 of
# the mean rank (1/|V|) for tiny ranks.
PR_RTOL, PR_ATOL_OF_MEAN = 1e-3, 1e-3
# the pulled sums below reach ~1e5 at the RMAT hubs; f32 keeps ~7 digits
PULL_RTOL, PULL_ATOL = 1e-4, 1e-3


def log(*args):
    print(*args, flush=True)


def require_gpu(devices) -> None:
    """Refuse anything but an NVIDIA GPU: no CPU fallback."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX's default "
                         f"device is {d.platform} ({d.device_kind})")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip()


def timed(fn):
    """(result of a compiling first call, seconds of one warm call, result
    of the warm call)."""
    import jax
    first = jax.block_until_ready(fn())
    t0 = time.perf_counter()
    warm = jax.block_until_ready(fn())
    return first, time.perf_counter() - t0, warm


def peak_bytes(device) -> int:
    return (device.memory_stats() or {}).get("peak_bytes_in_use", -1)


def load_graph(need_weights: bool):
    from vectorgraphlibrary.config import GraphFormat, VGLConfig
    from vectorgraphlibrary.runtime import runtime
    import jax
    cfg = VGLConfig(scale=SCALE, avg_degree=EDGE_FACTOR, seed=SEED,
                    graph_format=GraphFormat.TILE_CSR)
    runtime.init_library(cfg)
    t0 = time.perf_counter()
    ec, graph, weights = runtime.prepare_graph(cfg, need_weights=need_weights)
    jax.block_until_ready((graph, weights))
    log(f"graph: RMAT-{SCALE}/{EDGE_FACTOR} |V|={graph.v} |E|={graph.e} "
        f"TILE_CSR, import {time.perf_counter() - t0:.1f} s "
        f"(generation + host build + transfer)")
    return cfg, ec, graph, weights


def check(name: str, errors: int, tolerance: str) -> None:
    log(f"{name}: oracle errors {errors} (tolerance: {tolerance})")
    if errors:
        raise SystemExit(f"chip_smoke: {name} disagrees with its oracle")


def pr_errors(got, want) -> int:
    import numpy as np
    ok = np.isclose(got, want, rtol=PR_RTOL,
                    atol=PR_ATOL_OF_MEAN / len(want))
    return int((~ok).sum())


def check_pulls(ec, graph) -> None:
    """The two hot pulls (PageRank's add, BFS bottom-up's or) against a NumPy
    pull over the COO edge list, at the full graph width."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from vectorgraphlibrary.config import TraversalDirection
    from vectorgraphlibrary.models import common
    from vectorgraphlibrary.ops.advance import advance_pull_value
    G, O = TraversalDirection.GATHER, TraversalDirection.ORIGINAL
    v = graph.v
    rng = np.random.default_rng(SEED)
    x = rng.random(v).astype(np.float32)
    front = rng.random(v) < 0.05
    src, dst = ec.src_ids, ec.dst_ids

    def pad(a):
        out = np.zeros(graph.v_pad, a.dtype)
        out[:v] = a
        return jnp.asarray(out)

    pull_add = jax.jit(lambda g, a: common.to_direction(g, advance_pull_value(
        g, common.to_direction(g, a, O, G), "add", exclude_self_loops=True,
        direction=G), G, O))
    pull_or = jax.jit(lambda g, a: common.to_direction(g, advance_pull_value(
        g, common.to_direction(g, a, O, G), "or", direction=G), G, O))

    xp, fp = pad(x), pad(front)
    _, dt, got = timed(lambda: pull_add(graph, xp))
    keep = src != dst
    want = np.bincount(dst[keep], weights=x[src[keep]], minlength=v)
    bad = ~np.isclose(np.asarray(got)[:v], want, rtol=PULL_RTOL,
                      atol=PULL_ATOL)
    log(f"pull add (PageRank shape, with its two reorders): "
        f"{dt * 1e3:.3f} ms")
    check("pull add", int(bad.sum()),
          f"rtol {PULL_RTOL}, atol {PULL_ATOL}; f32 sums in any order")
    _, dt, got = timed(lambda: pull_or(graph, fp))
    want = np.bincount(dst, weights=front[src], minlength=v) > 0
    log(f"pull or (BFS bottom-up shape, with its two reorders): "
        f"{dt * 1e3:.3f} ms")
    check("pull or", int((np.asarray(got)[:v] != want).sum()), "exact")


def one_card(devices) -> None:
    import numpy as np
    import vectorgraphlibrary as vgl
    from vectorgraphlibrary.models import bfs, cc, common, pr, sssp
    from vectorgraphlibrary.utils import verify

    run_gpu_tests()
    cfg, ec, graph, weights = load_graph(need_weights=True)
    check_pulls(ec, graph)

    def same(a, b):
        return np.array_equal(np.asarray(a.values), np.asarray(b.values))

    first, dt, ranks = timed(lambda: pr.vgl_page_rank(
        graph, max_iterations=PR_ITERATIONS, use_convergence=False)[0])
    got = vgl.as_original_numpy(ranks, graph)
    want = pr.seq_page_rank(ec, max_iterations=PR_ITERATIONS,
                            use_convergence=False)
    rerun = float(np.max(np.abs(np.asarray(first.values)
                                - np.asarray(ranks.values))))
    log(f"pagerank ({PR_ITERATIONS} iterations): {dt:.4f} s warm; "
        f"max |run1 - run2| = {rerun:.3e}")
    check("pagerank", pr_errors(got, want),
          f"rtol {PR_RTOL}, atol {PR_ATOL_OF_MEAN}/|V|; f32 add order")
    check("pagerank ranking (apps' check)",
          verify.verify_ranking_results(got, want), "mean diff < 1e-4")

    source = common.select_random_source(ec, seed=cfg.seed)
    first, dt, levels = timed(lambda: bfs.vgl_bfs_device(graph, source))
    log(f"bfs (direction-optimizing, source {source}): {dt:.4f} s warm")
    check("bfs", verify.verify_results(vgl.as_original_numpy(levels, graph),
                                       bfs.seq_top_down(ec, source)),
          "exact")
    check("bfs rerun", 0 if same(first, levels) else 1, "bit-identical")

    first, dt, dist = timed(lambda: sssp.vgl_dijkstra_all_active(
        graph, weights, source)[0])
    log(f"sssp (all-active Bellman-Ford): {dt:.4f} s warm")
    check("sssp", verify.verify_results(vgl.as_original_numpy(dist, graph),
                                        sssp.seq_dijkstra(ec, source)),
          f"relative {verify.FLOAT_EPS}: f32 path sums vs the f64 oracle")
    check("sssp rerun", 0 if same(first, dist) else 1,
          "bit-identical: the min combine is order-free")

    first, dt, labels = timed(lambda: cc.vgl_shiloach_vishkin(graph)[0])
    log(f"cc (Shiloach-Vishkin): {dt:.4f} s warm")
    check("cc", verify.equal_components(vgl.as_original_numpy(labels, graph),
                                        cc.seq_cc(ec)), "exact partition")
    check("cc rerun", 0 if same(first, labels) else 1, "bit-identical")
    log(f"peak_bytes_in_use: {peak_bytes(devices[0])}")


def run_gpu_tests() -> None:
    """The tests marked `gpu`, in this process (one process per card)."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1

    repo = os.path.dirname(os.path.abspath(__file__))
    counter = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-c", os.path.join(repo, "pytest.ini"),
                      "--rootdir", repo,
                      os.path.join(repo, "tests", "test_gpu.py")],
                     plugins=[counter])
    log(f"gpu tests: exit {int(rc)}, {counter.passed} passed")
    if rc != 0 or counter.passed == 0:
        raise SystemExit("chip_smoke: the gpu-marked tests failed")


def four_cards(devices, cards: int) -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import vectorgraphlibrary as vgl
    from vectorgraphlibrary.models import bfs, cc, common, pr
    from vectorgraphlibrary.parallel import sharded
    from vectorgraphlibrary.parallel.mesh import EDGE_AXIS, make_mesh
    from vectorgraphlibrary.parallel.shard_build import import_sharded
    from vectorgraphlibrary.utils import verify

    if len(devices) < cards:
        raise SystemExit(f"chip_smoke: --cards {cards} but JAX sees "
                         f"{len(devices)} device(s)")
    cfg, ec, graph, _ = load_graph(need_weights=False)
    source = common.select_random_source(ec, seed=cfg.seed)

    # single-card reference on card 0 (the default device)
    _, dt, ranks1 = timed(lambda: pr.vgl_page_rank(
        graph, max_iterations=PR_ITERATIONS, use_convergence=False)[0])
    ranks1 = vgl.as_original_numpy(ranks1, graph)
    log(f"card 0 pagerank: {dt:.4f} s warm")
    _, dt, labels1 = timed(lambda: cc.vgl_shiloach_vishkin(graph)[0])
    labels1 = vgl.as_original_numpy(labels1, graph)
    log(f"card 0 cc: {dt:.4f} s warm")
    _, dt, levels1 = timed(lambda: bfs.vgl_bfs_device(graph, source))
    levels1 = vgl.as_original_numpy(levels1, graph)
    log(f"card 0 bfs: {dt:.4f} s warm")
    del graph

    t0 = time.perf_counter()
    sg = import_sharded(ec, cards)
    mesh = make_mesh(cards, 1, devices[:cards])
    sg = dataclasses.replace(sg, stacked=jax.device_put(
        sg.stacked, NamedSharding(mesh, P(EDGE_AXIS))))
    jax.block_until_ready(sg.stacked)
    log(f"sharded import over {cards} cards: "
        f"{time.perf_counter() - t0:.1f} s")
    leaf = sg.stacked.incoming.col_idx
    for s in leaf.addressable_shards:
        log(f"shard {s.index[0].start}: devices {s.data.devices()}")
    if len({s.device for s in leaf.addressable_shards}) != cards:
        raise SystemExit("chip_smoke: shards do not span the cards")

    run_pr = sharded.make_pr_sharded(sg, mesh, ec,
                                     max_iterations=PR_ITERATIONS)
    _, dt, ranks = timed(run_pr)
    ranks = np.asarray(ranks)[:sg.v]
    log(f"sharded pagerank: {dt:.4f} s warm")
    want = pr.seq_page_rank(ec, max_iterations=PR_ITERATIONS,
                            use_convergence=False)
    check("sharded pagerank vs oracle", pr_errors(ranks, want),
          f"rtol {PR_RTOL}, atol {PR_ATOL_OF_MEAN}/|V|")
    check("sharded pagerank vs card 0", pr_errors(ranks, ranks1),
          f"rtol {PR_RTOL}, atol {PR_ATOL_OF_MEAN}/|V|")

    cc_fn = sharded.make_cc_sharded(sg, mesh)
    _, dt, labels = timed(lambda: cc_fn(sg.stacked))
    labels = np.asarray(labels)[:sg.v]
    log(f"sharded cc: {dt:.4f} s warm")
    check("sharded cc vs oracle",
          verify.equal_components(labels, cc.seq_cc(ec)), "exact partition")
    check("sharded cc vs card 0", verify.equal_components(labels, labels1),
          "exact partition")

    bfs_fn = sharded.make_bfs_sharded(sg, mesh)
    _, dt, levels = timed(lambda: bfs_fn(sg.stacked, jnp.int32(source)))
    levels = np.asarray(levels)[:sg.v]
    log(f"sharded bfs: {dt:.4f} s warm")
    check("sharded bfs vs oracle",
          verify.verify_results(levels, bfs.seq_top_down(ec, source)),
          "exact")
    check("sharded bfs vs card 0", verify.verify_results(levels, levels1),
          "exact")
    for d in devices[:cards]:
        log(f"peak_bytes_in_use {d}: {peak_bytes(d)}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1,
                   help="1: the single-card path; N > 1: only the sharded "
                        "path over N cards and what it is compared with")
    args = p.parse_args(argv)
    import jax
    devices = jax.devices()
    require_gpu(devices)
    log(card_line())
    log(f"device_kind: {devices[0].device_kind}, JAX sees {len(devices)}")
    t0 = time.perf_counter()
    if args.cards == 1:
        one_card(devices)
        used = devices[:1]
    else:
        four_cards(devices, args.cards)
        used = devices[:args.cards]
    log(f"total: {time.perf_counter() - t0:.1f} s")
    print(result_line(used), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
