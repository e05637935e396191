"""Algorithm-state checkpoint / resume.

The reference persists only preprocessed graphs (binary save/load per format,
`vgl_datastructures/graphs/vect_csr/vect_csr_graph.h:90-92`) and has no
algorithm-state checkpointing (SURVEY §5); long-running iterative jobs restart
from scratch on failure. This module adds the standard JAX-world capability the
reference lacks: snapshot any pytree of device arrays (iteration state of PR /
SSSP / CC / a GNN train step) to one .npz with its tree structure, and resume.

Design notes:
- save is synchronous host-side `np.savez` after a `device_get` — checkpoint
  cadence for graph-analytic fixpoints is every N coarse iterations, so async
  orchestration buys nothing here;
- files are written atomically (tmp + rename) so a preempted writer never
  leaves a truncated checkpoint;
- `CheckpointManager` keeps the last `keep` snapshots, restores the newest
  readable one, and tolerates concurrent/killed writers.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional, Tuple

import jax
import numpy as np


def _flatten(state: Any):
    leaves, treedef = jax.tree_util.tree_flatten(state)
    return leaves, treedef


def save_state(path: str, step: int, state: Any) -> None:
    """Snapshot a pytree of arrays/scalars to `path` (.npz), atomically."""
    leaves, treedef = _flatten(state)
    host = [np.asarray(x) for x in jax.device_get(leaves)]
    payload = {f"leaf_{i}": a for i, a in enumerate(host)}
    payload["__meta__"] = np.frombuffer(json.dumps({
        "step": int(step),
        "treedef": str(treedef),
        "n_leaves": len(host),
    }).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str, like: Any = None) -> Tuple[int, Any]:
    """Load (step, state). `like`: a pytree with the same structure used to
    rebuild the treedef (required to reconstruct containers; without it a flat
    leaf list is returned)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    if like is not None:
        _, treedef = _flatten(like)
        if treedef.num_leaves != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, template has "
                f"{treedef.num_leaves}")
        return meta["step"], jax.tree_util.tree_unflatten(treedef, leaves)
    return meta["step"], leaves


_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


class CheckpointManager:
    """Directory of rolling ckpt_<step>.npz snapshots."""

    def __init__(self, directory: str, every_n: int = 10, keep: int = 3):
        self.directory = directory
        self.every_n = max(int(every_n), 1)
        self.keep = max(int(keep), 1)
        os.makedirs(directory, exist_ok=True)

    def _steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def maybe_save(self, step: int, state: Any) -> bool:
        """Save when `step` hits the cadence; prunes old snapshots. Returns
        whether a snapshot was written."""
        if step % self.every_n != 0:
            return False
        save_state(self.path(step), step, state)
        for old in self._steps()[:-self.keep]:
            try:
                os.unlink(self.path(old))
            except OSError:
                pass
        return True

    def restore_latest(self, like: Any = None) -> Optional[Tuple[int, Any]]:
        """(step, state) of the newest readable snapshot, or None."""
        for step in reversed(self._steps()):
            try:
                return load_state(self.path(step), like=like)
            except Exception:
                continue
        return None


def run_with_checkpoints(body, state: Any, n_steps: int,
                         manager: CheckpointManager,
                         start_step: int = 0) -> Tuple[int, Any]:
    """Host-stepped fixpoint driver with checkpointing: resumes from the
    manager's newest snapshot (if any), runs `state = body(step, state)` for the
    remaining steps, snapshotting on cadence. Use for coarse outer loops (the
    per-iteration jitted step stays fused); returns (last_step+1, state)."""
    restored = manager.restore_latest(like=state)
    if restored is not None:
        start_step, state = restored
        start_step += 1
    step = start_step
    for step in range(start_step, n_steps):
        state = body(step, state)
        manager.maybe_save(step, state)
    return (step + 1 if n_steps > start_step else start_step), state
