"""SSSP benchmark app (reference apps/sssp analog)."""
import sys

from app_common import run_app
import vectorgraphlibrary as vgl
from vectorgraphlibrary.models import sssp
from vectorgraphlibrary.utils import verify


def run_round(ec, graph, weights, source, cfg):
    if cfg.all_active:
        # -push/-pull both land here: the reference dispatches distinct
        # scatter/gather kernels (shortest_paths.h:19-80), but the pull
        # advance realizes the identical all-edges relaxation for either
        # direction, so the flag is a documented alias (see -push help).
        dist, _ = sssp.vgl_dijkstra_all_active(graph, weights, source)
    else:
        # device-resident work frontier: one dispatch per run, no host
        # round-trip per iteration
        dist, _ = sssp.vgl_dijkstra_partial_device(graph, weights, source)
    return dist


def check_round(ec, graph, weights, source, result, cfg):
    got = vgl.as_original_numpy(result, graph)
    want = sssp.seq_dijkstra(ec, source)
    return verify.verify_results(got, want)


if __name__ == "__main__":
    sys.exit(run_app("sssp", run_round, check_round, need_weights=True))
