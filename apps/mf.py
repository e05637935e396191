"""Max-flow benchmark app (reference apps/mf analog)."""
import sys

import numpy as np

from app_common import run_app          # first: puts the repo on sys.path
import vectorgraphlibrary as vgl
from vectorgraphlibrary.models import mf


_PREP_CACHE = {}


def _prep(ec, cfg):
    # cache per (container, seed): mf.build_residual memoizes the imported
    # 2e-arc graph ON the prepared container, so rounds must reuse it
    key = (id(ec), cfg.seed)
    if key not in _PREP_CACHE:
        dedup = ec.remove_self_loops_and_duplicates()
        rng = np.random.default_rng(cfg.seed)
        _PREP_CACHE[key] = vgl.EdgesContainer(
            dedup.src_ids, dedup.dst_ids, dedup.vertices_count,
            rng.integers(1, 100, dedup.edges_count).astype(np.float32))
    return _PREP_CACHE[key]


def run_round(ec, graph, weights, source, cfg):
    ec2 = _prep(ec, cfg)
    indeg = np.bincount(ec2.dst_ids, minlength=ec2.vertices_count)
    sink = int(np.argmax(np.where(np.arange(len(indeg)) != source, indeg, -1)))
    flow = mf.vgl_ford_fulkerson(ec2, graph, source, sink)
    return np.asarray([flow, sink])


def check_round(ec, graph, weights, source, result, cfg):
    ec2 = _prep(ec, cfg)
    flow, sink = float(result[0]), int(result[1])
    want = mf.seq_ford_fulkerson(ec2, source, sink)
    errors = 0 if abs(flow - want) < 1e-6 else 1
    print(f"error count: {errors}")
    return errors


if __name__ == "__main__":
    sys.exit(run_app("mf", run_round, check_round))
