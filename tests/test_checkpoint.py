"""Checkpoint/resume subsystem (runtime/checkpoint.py)."""
import os

import numpy as np
import jax.numpy as jnp

from vectorgraphlibrary.runtime import checkpoint as ck


def test_save_load_roundtrip(tmp_path):
    state = {"ranks": jnp.arange(10, dtype=jnp.float32),
             "it": jnp.int32(7),
             "nested": (jnp.ones(3), jnp.zeros(2, jnp.int32))}
    p = str(tmp_path / "s.npz")
    ck.save_state(p, 42, state)
    step, got = ck.load_state(p, like=state)
    assert step == 42
    np.testing.assert_array_equal(got["ranks"],
                                  np.arange(10, dtype=np.float32))
    assert int(got["it"]) == 7
    np.testing.assert_array_equal(got["nested"][1], np.zeros(2, np.int32))


def test_manager_cadence_prune_restore(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "ck"), every_n=2, keep=2)
    for step in range(7):
        wrote = mgr.maybe_save(step, {"x": jnp.full(4, step)})
        assert wrote == (step % 2 == 0)
    steps = mgr._steps()
    assert steps == [4, 6]                       # pruned to last 2
    step, state = mgr.restore_latest(like={"x": jnp.zeros(4)})
    assert step == 6
    np.testing.assert_array_equal(state["x"], np.full(4, 6.0))


def test_restore_skips_corrupt(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "ck"), every_n=1, keep=3)
    mgr.maybe_save(1, {"x": jnp.ones(2)})
    mgr.maybe_save(2, {"x": jnp.full(2, 2.0)})
    with open(mgr.path(3), "wb") as f:                 # truncated garbage
        f.write(b"not an npz")
    step, state = mgr.restore_latest(like={"x": jnp.zeros(2)})
    assert step == 2
    np.testing.assert_array_equal(state["x"], np.full(2, 2.0))


def test_run_with_checkpoints_resume(tmp_path):
    d = str(tmp_path / "ck")

    def body(step, s):
        return {"x": s["x"] + 1.0}

    mgr = ck.CheckpointManager(d, every_n=2, keep=5)
    # crash after 5 steps (simulate by running only 5)
    last, s = ck.run_with_checkpoints(body, {"x": jnp.zeros(1)}, 5, mgr)
    assert float(s["x"][0]) == 5.0
    # fresh manager resumes from step 4's snapshot and completes to 10
    mgr2 = ck.CheckpointManager(d, every_n=2, keep=5)
    last2, s2 = ck.run_with_checkpoints(body, {"x": jnp.zeros(1)}, 10, mgr2)
    assert last2 == 10
    assert float(s2["x"][0]) == 10.0             # 5 (restored) + remaining
