"""CLI parser matching the reference flag surface.

Capability match for `vgl_runtime/helpers/cmd_parser/cmd_parser.hpp:58-228` /
`parser_options.h:5-83`: graph source (-load/-import/-gen with -s/-e and -rmat/-ru),
-format, -check, -it, traversal/algorithm variant flags (-push/-pull,
-all-active/-partial-active, -td/-bu/-do, -sv/-bfs-based/-purdoms), -dev.
"""
from __future__ import annotations

import argparse

from ..config import VGLConfig, GraphFormat, SyntheticGraphType


def build_parser(app: str = "vgl") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=app, description=f"VGL {app} benchmark")
    p.add_argument("-load", dest="load_path", default=None,
                   help="load binary .el_container graph")
    p.add_argument("-import", dest="import_path", default=None,
                   help="import KONECT text graph")
    p.add_argument("-gen", dest="gen", action="store_true",
                   help="generate synthetic graph (default)")
    p.add_argument("-s", "-scale", dest="scale", type=int, default=14,
                   help="log2 |V| for synthetic graphs")
    p.add_argument("-e", "-edges", dest="avg_degree", type=int, default=16,
                   help="average degree for synthetic graphs")
    p.add_argument("-rmat", dest="rmat", action="store_true", default=True)
    p.add_argument("-ru", "-random_uniform", dest="ru", action="store_true")
    p.add_argument("-format", dest="graph_format", default="vect_csr",
                   help="el/csr/csr_vg/vect_csr, or 'auto' (autotuner pick, "
                        "see utils/autotuner.py)")
    p.add_argument("-check", dest="check", action="store_true")
    p.add_argument("-it", "-iterations", dest="iterations", type=int, default=10)
    p.add_argument("-push", dest="push", action="store_true",
                   help="all-active SSSP/SSWP: accepted for reference CLI "
                        "parity but selects the SAME pull kernel as -pull "
                        "(each sweep relaxes every edge either way; see "
                        "models/sssp.py). -partial-active is the genuine "
                        "push-mode (compacted-frontier scatter) path")
    p.add_argument("-pull", dest="pull", action="store_true")
    p.add_argument("-all-active", dest="all_active", action="store_true")
    p.add_argument("-partial-active", dest="partial_active", action="store_true")
    p.add_argument("-td", dest="variant_td", action="store_true")
    p.add_argument("-bu", dest="variant_bu", action="store_true")
    p.add_argument("-do", dest="variant_do", action="store_true")
    p.add_argument("-sv", dest="variant_sv", action="store_true")
    p.add_argument("-bfs-based", dest="variant_bfs_based", action="store_true")
    p.add_argument("-purdoms", dest="variant_purdoms", action="store_true")
    p.add_argument("-seed", dest="seed", type=int, default=42)
    p.add_argument("-no-prim-stats", dest="prim_stats", action="store_false",
                   help="skip the per-primitive profiling pass after the run")
    return p


def parse_args(argv=None, app: str = "vgl") -> VGLConfig:
    ns = build_parser(app).parse_args(argv)
    variant = "auto"
    for name in ("td", "bu", "do", "sv", "bfs_based", "purdoms"):
        if getattr(ns, f"variant_{name}"):
            variant = name
    autotune = ns.graph_format.lower() == "auto"
    return VGLConfig(
        scale=ns.scale,
        avg_degree=ns.avg_degree,
        synthetic_type=(SyntheticGraphType.RANDOM_UNIFORM if ns.ru
                        else SyntheticGraphType.RMAT),
        graph_format=(GraphFormat.TILE_CSR if autotune
                      else GraphFormat.parse(ns.graph_format)),
        autotune_format=autotune,
        load_path=ns.load_path,
        import_path=ns.import_path,
        check=ns.check,
        iterations=ns.iterations,
        push_mode=not ns.pull,
        all_active=not ns.partial_active,
        algorithm_variant=variant,
        seed=ns.seed,
        prim_stats=ns.prim_stats,
    )
