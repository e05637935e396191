#!/usr/bin/env python
"""Build the SECOND bundled real-world graph with zero network egress: the
static function-call graph of this machine's installed Python code (stdlib +
site-packages: jax, torch, transformers, scipy, ...).

Software call graphs are a standard real-graph category (KONECT carries
several); this one is ~an order of magnitude larger than the bundled import
network (data/pydeps.el.gz), so traversal benchmarks on it measure kernels
rather than per-dispatch latency.

Construction (deterministic: files walked sorted, ids assigned by sorted
qualified name):
- nodes  = function/method definitions, id = "module.qualname";
- edges  = caller -> callee for every Call whose target resolves by:
    1. a name defined in the same module (innermost scope wins),
    2. else the attribute/base name's lexicographically-first global match.
  Unresolved calls (builtins, C extensions, dynamic dispatch) are dropped.
This is a heuristic STATIC call graph — standard practice for call-graph
datasets; provenance is recorded here and in BASELINE.md.

Usage: python apps/make_call_graph.py [out.el.gz]
"""
from __future__ import annotations

import ast
import gzip
import os
import sys

ROOTS = [
    "/usr/lib/python3",
    "/usr/lib/python3.11",
    "/usr/lib/python3.12",
    "/usr/local/lib",
    "/opt",
]


def iter_py_files():
    seen = set()
    for root in ROOTS:
        if not os.path.isdir(root):
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for f in sorted(filenames):
                if f.endswith(".py"):
                    p = os.path.join(dirpath, f)
                    rp = os.path.realpath(p)
                    if rp not in seen:
                        seen.add(rp)
                        yield p


def module_name(path: str) -> str:
    base = os.path.basename(path)[:-3]
    parts = [base] if base != "__init__" else []
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.insert(0, os.path.basename(d))
        d = os.path.dirname(d)
    if not parts:
        parts = [os.path.basename(os.path.dirname(path)) or base]
    return ".".join(parts)


class FnCollector(ast.NodeVisitor):
    """First pass: collect function defs with qualified names."""

    def __init__(self, mod):
        self.mod = mod
        self.stack = []
        self.defs = {}                     # qualname -> simple name

    def _visit_def(self, node):
        qual = ".".join(self.stack + [node.name])
        self.defs[f"{self.mod}.{qual}"] = node.name
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()


class CallCollector(ast.NodeVisitor):
    """Second pass: (caller_qualname, callee_simple_name) pairs."""

    def __init__(self, mod):
        self.mod = mod
        self.stack = []
        self.calls = []                    # (caller_full, callee_simple)

    def _visit_def(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_Call(self, node):
        if self.stack:
            name = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            if name:
                caller = f"{self.mod}." + ".".join(self.stack)
                self.calls.append((caller, name))
        self.generic_visit(node)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "vectorgraphlibrary", "data", "pycalls.el.gz")

    sys.setrecursionlimit(50_000)          # deep generated ASTs in site-pkgs
    defs = {}                              # full qualname -> simple name
    per_mod = {}                           # mod -> FnCollector
    calls = []
    nfiles = 0
    for path in iter_py_files():
        try:
            with open(path, "rb") as f:
                tree = ast.parse(f.read())
            mod = module_name(path)
            fc = FnCollector(mod)
            fc.visit(tree)
            cc = CallCollector(mod)
            cc.visit(tree)
        except (SyntaxError, ValueError, OSError, RecursionError,
                MemoryError):
            continue
        defs.update(fc.defs)
        per_mod.setdefault(mod, {}).update(fc.defs)
        calls.extend(cc.calls)
        nfiles += 1
        if nfiles % 5000 == 0:
            print(f"{nfiles} files, {len(defs)} defs, {len(calls)} call "
                  "sites", flush=True)

    # global simple-name -> lexicographically-first full qualname
    by_simple = {}
    for full in sorted(defs):
        by_simple.setdefault(defs[full], full)
    # per-module simple-name -> first full qualname in that module
    mod_simple = {}
    for mod, d in per_mod.items():
        m = {}
        for full in sorted(d):
            m.setdefault(d[full], full)
        mod_simple[mod] = m

    ids = {full: i for i, full in enumerate(sorted(defs))}
    edges = set()
    for caller, callee in calls:
        mod = caller.split(".")[0]
        # same-module resolution first (any module prefix of the caller)
        target = None
        cmod = caller.rsplit(".", 1)[0]
        while True:
            t = mod_simple.get(cmod, {}).get(callee)
            if t:
                target = t
                break
            if "." not in cmod:
                break
            cmod = cmod.rsplit(".", 1)[0]
        if target is None:
            target = by_simple.get(callee)
        if target is None or caller not in ids:
            continue
        if target != caller:
            edges.add((ids[caller], ids[target]))

    print(f"{nfiles} files -> |V|={len(ids)} |E|={len(edges)}")
    with gzip.open(out, "wt") as f:
        f.write(f"# python static call graph: {len(ids)} functions, "
                f"{len(edges)} resolved call edges\n")
        for s, d in sorted(edges):
            f.write(f"{s} {d}\n")
    print(f"wrote {out} ({os.path.getsize(out)/1e6:.1f} MB)")


if __name__ == "__main__":
    main()
