#!/usr/bin/env python
"""Build a REAL-WORLD graph with zero network egress: the Python-module import
network of this machine's installed packages.

Rationale: the reference benchmarks 30+ KONECT graphs
(`/root/reference/apps/scripts/create_graphs_api.py:83-206`) but this
environment cannot download them. Software-dependency networks are a standard
real-graph category in network science (KONECT itself carries several); the
import graph of a large Python installation (jax, torch, transformers, scipy,
...) is a genuine scale-free network: ~30k modules, popular hubs (numpy, os
wrappers) with in-degrees in the thousands.

Determinism: files are walked in sorted order and module ids are assigned by
sorted module name, so re-running on the same installation reproduces the
snapshot byte-for-byte. The generated edge list is committed under
vectorgraphlibrary/data/ as the zero-egress corpus fallback
(io/corpus.py bundled_graph); this script documents its provenance and
re-creates it.

Usage: python apps/make_real_graph.py [out.el.gz]
"""
from __future__ import annotations

import gzip
import io
import os
import re
import sys
import tokenize

ROOTS = [
    "/usr/lib/python3",
    "/usr/lib/python3.11",
    "/usr/local/lib",
    "/opt",
]

_IMPORT = re.compile(
    r"^\s*(?:import\s+(?P<plain>[\w.\s,]+?)(?:\s+as\s+\w+)?\s*$"
    r"|from\s+(?P<dots>\.*)(?P<frm>[\w.]*)\s+import\s+(?P<names>.+))")


def discover_modules():
    """module name -> file path, walking sorted for determinism."""
    mods = {}
    for root in ROOTS:
        if not os.path.isdir(root):
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            rel = os.path.relpath(dirpath, root)
            parts = [] if rel == "." else rel.split(os.sep)
            # find the top of the importable package path: the nearest ancestor
            # chain of dirs that all contain __init__.py
            for f in sorted(filenames):
                if not f.endswith(".py"):
                    continue
                # module path: longest suffix of parts that is a package chain
                chain = []
                p = dirpath
                while os.path.exists(os.path.join(p, "__init__.py")):
                    chain.append(os.path.basename(p))
                    p = os.path.dirname(p)
                chain.reverse()
                if f == "__init__.py":
                    if not chain:
                        continue
                    name = ".".join(chain)
                else:
                    name = ".".join(chain + [f[:-3]])
                mods.setdefault(name, os.path.join(dirpath, f))
    return mods


def parse_imports(path: str, this_mod: str):
    """Imported dotted names (absolute), best-effort, regex-based."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
        text = raw.decode("utf-8", errors="replace")
    except OSError:
        return
    pkg_parts = this_mod.split(".")
    for line in text.splitlines():
        m = _IMPORT.match(line)
        if not m:
            continue
        if m.group("plain") is not None:
            for item in m.group("plain").split(","):
                name = item.strip().split(" as ")[0].strip()
                if name and re.fullmatch(r"[\w.]+", name):
                    yield name
        else:
            dots, frm = m.group("dots"), m.group("frm")
            if dots:   # relative: resolve against this module's package
                up = len(dots)
                base = pkg_parts[:-up] if up <= len(pkg_parts) else []
                if not base:
                    continue
                yield ".".join(base + ([frm] if frm else []))
            elif frm:
                yield frm
                # "from X import Y" may bind submodule X.Y
                names = m.group("names")
                for item in names.split(","):
                    n = item.strip().split(" as ")[0].strip()
                    if re.fullmatch(r"\w+", n):
                        yield f"{frm}.{n}"


def resolve(name: str, mods) -> str | None:
    """Longest known prefix of a dotted import target."""
    parts = name.split(".")
    while parts:
        cand = ".".join(parts)
        if cand in mods:
            return cand
        parts.pop()
    return None


def main(out_path: str):
    mods = discover_modules()
    names = sorted(mods)
    ids = {n: i for i, n in enumerate(names)}
    print(f"modules: {len(names)}")
    edges = set()
    for src_name in names:
        sid = ids[src_name]
        for target in parse_imports(mods[src_name], src_name) or ():
            r = resolve(target, mods)
            if r is not None and r != src_name:
                edges.add((sid, ids[r]))
    edges = sorted(edges)
    print(f"edges: {len(edges)}")
    buf = io.StringIO()
    buf.write("% pydeps: Python-module import network snapshot\n")
    buf.write("% nodes=modules (id = rank of sorted dotted name), "
              "edge u v = module u imports module v\n")
    buf.write(f"% generated by apps/make_real_graph.py; "
              f"{len(names)} vertices, {len(edges)} edges\n")
    for s, d in edges:
        buf.write(f"{s} {d}\n")
    with open(out_path, "wb") as raw:
        with gzip.GzipFile(fileobj=raw, mode="wb", compresslevel=9,
                           mtime=0) as f:     # mtime=0: reproducible bytes
            f.write(buf.getvalue().encode())
    print(f"wrote {out_path} ({os.path.getsize(out_path)/1e6:.2f} MB)")


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "vectorgraphlibrary", "data", "pydeps.el.gz")
    main(out)
