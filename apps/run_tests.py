#!/usr/bin/env python
"""Benchmark/verification harness.

Capability match for the reference harness (`apps/run_tests.py:10-177` +
`apps/scripts/{settings,benchmarking_api,verification_api,export}.py`):
  --verify     run each app with -check -it 1 over the graph corpus, parse the
               "error count:" contract, enforce per-run wall timeouts
  --benchmark  run each app with -it N, parse "AVG_PERF: X MTEPS"
  --scaling    strong-scaling sweep over virtual device counts (CPU mesh)
Results go to JSON + CSV (the reference exports xlsx; no xlsx lib is baked into
this image, and CSV/JSON feed the same downstream tooling).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

APPS = ["bfs", "pr", "sssp", "cc", "sswp", "hits", "coloring",
        "scc", "lp", "rw", "tc", "mf"]
# graph corpus tiers (reference settings.py:90-157)
TIERS = {
    "tiny": [("rmat", 12, 16), ("ru", 12, 16)],
    "small": [("rmat", 14, 16), ("ru", 14, 16)],
    "medium": [("rmat", 18, 32)],
    "large": [("rmat", 20, 32)],
    # scale-22 runs through the in-process import (host preprocessing
    # included; the tier's timeout accounts for it)
    "xlarge": [("rmat", 22, 16)],
}
DEFAULT_TIMEOUT = 600
TIER_TIMEOUTS = {"xlarge": 3600}


FORCE_CPU = False


def run_app(app: str, args: list, timeout: int) -> tuple[str, float, bool]:
    """Returns (stdout, wall seconds, timed_out)."""
    cmd = [sys.executable, os.path.join(HERE, f"{app}.py")] + args
    env = dict(os.environ)
    if FORCE_CPU:
        env.update(JAX_PLATFORMS="cpu")
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                           cwd=HERE, env=env)
        return r.stdout + r.stderr, time.time() - t0, False
    except subprocess.TimeoutExpired as te:
        out = (te.stdout or b"").decode() if isinstance(te.stdout, bytes) \
            else (te.stdout or "")
        return out, time.time() - t0, True


def parse_error_count(out: str):
    errs = [int(line.split("error count:")[1])
            for line in out.splitlines() if "error count:" in line]
    return max(errs) if errs else None


def parse_avg_perf(out: str):
    for line in out.splitlines():
        if line.startswith("AVG_PERF:"):
            return float(line.split()[1])
    return None


def graph_args(kind, scale, degree):
    if kind == "load":                      # real-graph corpus entry
        return ["-load", scale]             # scale slot carries the path
    base = ["-s", str(scale), "-e", str(degree)]
    return base + (["-ru"] if kind == "ru" else [])


def real_graph_corpus():
    """Locally cached KONECT graphs as ('load', path, name) rows (reference
    real-graph tiers, settings.py:52-86; zero-egress environments use
    whatever sits under .graphs/ — see io/corpus.py)."""
    sys.path.insert(0, REPO)
    from vectorgraphlibrary.io import corpus
    for _name in corpus.BUNDLED:         # materialize the in-repo real graphs
        corpus.bundled_graph(_name)
    rows = []
    d = corpus.graph_dir()
    for f in sorted(os.listdir(d)):
        if f.endswith(".el_container"):
            rows.append(("load", os.path.join(d, f),
                         f[:-len(".el_container")]))
    return rows


REAL_FILTER = None


def tier_graphs(tier):
    if tier == "real":
        rg = real_graph_corpus()
        if REAL_FILTER:
            rg = [r for r in rg if r[2] in REAL_FILTER]
        if not rg:
            print("real tier: no cached corpus graphs under .graphs/ "
                  "(zero-egress? see io/corpus.py)")
        return rg
    return TIERS[tier]


def do_verify(tier, timeout, device):
    rows = []
    ok = True
    for app in APPS:
        for kind, scale, degree in tier_graphs(tier):
            out, wall, to = run_app(
                app, graph_args(kind, scale, degree) + ["-check", "-it", "1"],
                timeout)
            err = parse_error_count(out)
            status = ("TIMED OUT" if to else
                      "ERROR" if err is None else
                      "PASS" if err == 0 else f"FAIL({err})")
            ok &= status == "PASS"
            print(f"verify {app:10s} {kind}-{scale}-{degree}: {status} "
                  f"({wall:.1f}s)")
            rows.append(dict(mode="verify", app=app, graph=f"{kind}-{scale}",
                             status=status, wall_s=round(wall, 1)))
    return rows, ok


def do_benchmark(tier, timeout, iters):
    rows = []
    for app in APPS:
        for kind, scale, degree in tier_graphs(tier):
            out, wall, to = run_app(
                app, graph_args(kind, scale, degree) + ["-it", str(iters)],
                timeout)
            perf = None if to else parse_avg_perf(out)
            print(f"bench {app:10s} {kind}-{scale}-{degree}: "
                  f"{'TIMED OUT' if to else f'{perf} MTEPS'} ({wall:.1f}s)")
            rows.append(dict(mode="benchmark", app=app, graph=f"{kind}-{scale}",
                             mteps=perf, wall_s=round(wall, 1)))
    return rows


def export(rows, path_base):
    with open(path_base + ".json", "w") as f:
        json.dump(rows, f, indent=1)
    if rows:
        with open(path_base + ".csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted({k for r in rows for k in r}))
            w.writeheader()
            w.writerows(rows)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--verify", action="store_true")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--scaling", action="store_true",
                   help="strong-scaling sweep on the virtual CPU mesh")
    p.add_argument("--tier", default="tiny", choices=list(TIERS) + ["real"])
    p.add_argument("--apps", default=None, help="comma-separated subset")
    p.add_argument("--timeout", type=int, default=DEFAULT_TIMEOUT)
    p.add_argument("--it", type=int, default=10)
    p.add_argument("--cpu", action="store_true",
                   help="run apps on the host CPU backend (JAX_PLATFORMS=cpu)")
    p.add_argument("--real", default=None,
                   help="comma-separated real-graph names for --tier real")
    p.add_argument("--out", default=os.path.join(REPO, "harness_results"))
    args = p.parse_args()
    global APPS, FORCE_CPU, REAL_FILTER
    FORCE_CPU = args.cpu
    REAL_FILTER = args.real.split(",") if args.real else None
    if args.apps:
        APPS = args.apps.split(",")
    if (args.timeout == DEFAULT_TIMEOUT and args.tier in TIER_TIMEOUTS):
        args.timeout = TIER_TIMEOUTS[args.tier]
    rows = []
    ok = True
    if args.verify:
        r, ok = do_verify(args.tier, args.timeout, None)
        rows += r
    if args.benchmark:
        rows += do_benchmark(args.tier, args.timeout, args.it)
    if args.scaling:
        out, wall, to = run_app("scaling",
                                ["--cpu", "--devices", "1,2,4,8", "-s", "14"],
                                args.timeout)
        print(out.splitlines()[-1] if out else "scaling produced no output")
        rows.append(dict(mode="scaling", wall_s=round(wall, 1),
                         timed_out=to))
    export(rows, args.out)
    print(f"results written to {args.out}.json/.csv")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
