"""PageRank benchmark app (reference apps/pr analog)."""
import sys

from app_common import run_app
import vectorgraphlibrary as vgl
from vectorgraphlibrary.models import pr
from vectorgraphlibrary.utils import verify


# fixed iteration count on BOTH the device run and the oracle: the device
# convergence test runs in f32 and the oracle's in f64, so convergence-mode
# runs stop at different iterations and fail the ranking check spuriously
_PR_ITERS = 100


def run_round(ec, graph, weights, source, cfg):
    ranks, _ = pr.vgl_page_rank(graph, max_iterations=_PR_ITERS,
                                use_convergence=False)
    return ranks.values


def check_round(ec, graph, weights, source, result, cfg):
    from vectorgraphlibrary.config import TraversalDirection
    arr = vgl.VertexArray(values=result, direction=TraversalDirection.GATHER)
    got = vgl.as_original_numpy(arr, graph)
    want = pr.seq_page_rank(ec, max_iterations=_PR_ITERS, use_convergence=False)
    return verify.verify_ranking_results(got, want)


if __name__ == "__main__":
    sys.exit(run_app("pr", run_round, check_round, needs_source=False))
