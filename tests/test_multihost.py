"""Simulated multi-HOST (DCN) validation: two OS processes, each with 2
virtual CPU devices, joined by jax.distributed (Gloo collectives) — the
fake-cluster analog of the reference's mpirun -np 2 runs
(`apps/bin/mpi_run.sh:20-34`, `apps/misc/mpi_test.cpp`). The sharded flagship
PageRank runs over the 4 GLOBAL devices and must match the oracle in every
process."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:%PORT%",
                           num_processes=nproc, process_id=pid)
import numpy as np, jax.numpy as jnp
from vectorgraphlibrary.io import generation
from vectorgraphlibrary.parallel.shard_build import import_sharded
from vectorgraphlibrary.parallel import sharded
from vectorgraphlibrary.parallel.mesh import make_mesh
from vectorgraphlibrary.models import pr as prm

ec = generation.rmat(scale=9, avg_degree=8, seed=3)
n_dev = len(jax.devices())
assert jax.process_count() == nproc, jax.process_count()
assert n_dev == 2 * nproc, n_dev
sg = import_sharded(ec, n_dev)
mesh = make_mesh(n_dev, 1)
run = sharded.make_pr_sharded(sg, mesh, ec, max_iterations=20)
got = np.asarray(jax.device_get(run()))[:sg.v]
want = prm.seq_page_rank(ec, max_iterations=20, use_convergence=False)
err = float(np.abs(got - want).max())
assert err < 1e-6, err
print(f"proc {pid}: PR over {nproc} processes x 2 devices OK (maxdiff {err:.2e})")
"""


@pytest.mark.timeout(600)
def test_two_process_sharded_pagerank(tmp_path):
    # ephemeral port: a fixed one collides with parallel runs or a lingering
    # listener from a killed prior run (initialize then hangs to its timeout)
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("%PORT%", str(port)))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(script), str(i), "2"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=REPO)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert "OK" in out
