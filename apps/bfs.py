"""BFS benchmark app (reference apps/bfs/bfs.cpp analog)."""
import sys

from app_common import run_app
import vectorgraphlibrary as vgl
from vectorgraphlibrary.models import bfs
from vectorgraphlibrary.utils import verify


def run_round(ec, graph, weights, source, cfg):
    if cfg.algorithm_variant == "td":
        return bfs.vgl_top_down(graph, source)
    if cfg.algorithm_variant == "bu":
        return bfs.vgl_bfs(graph, source, alpha=1e-9)  # bu from level 2 on
    # direction-optimizing default: the fully device-resident state machine
    return bfs.vgl_bfs_device(graph, source)


def check_round(ec, graph, weights, source, result, cfg):
    got = vgl.as_original_numpy(result, graph)
    want = bfs.seq_top_down(ec, source)
    return verify.verify_results(got, want)


if __name__ == "__main__":
    sys.exit(run_app("bfs", run_round, check_round))
