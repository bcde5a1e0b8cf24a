"""Asynchronous checkpoints, the counterpart of
sfm_nerf_tpu/train/orbax_ckpt.py:OrbaxCheckpointer (``ckpt_backend='orbax'``).

orbax imports jax, so the port writes its own files: the same
``model_{step:06d}.ckpt.npz`` that train/checkpoint.py:save_checkpoint
writes (a temporary name, then ``os.replace``), which either package's npz
loader reads.  A deliberate departure: the JAX backend writes orbax's step
directories, this one npz files.

``save`` returns before anything reaches the disk.  It snapshots the
tensors into pinned host buffers by ``non_blocking`` copies on the current
CUDA stream and records an event after them; the trainer's next in-place
update runs on the same stream, so it is ordered after the copies and the
host never waits.  One background thread waits on the event and writes the
file.  On the CPU the snapshot is a plain copy.  ``wait`` blocks until every
save has committed and raises a writer's error; the trainer waits before
``fit`` returns and before an interrupt is re-raised.

Resume semantics are the JAX class's: the numerically newest step wins,
and saving a step that is already saved (or in flight) does nothing.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sfm_nerf_tpu_torch.train import checkpoint as ckpt_lib


def _snapshot(tree: Any) -> Any:
    """``tree`` (nested dicts of tensors, arrays and numbers) with every
    tensor copied to the host: CUDA tensors into pinned buffers, without
    waiting."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.detach()
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.is_floating_point() else tree.numpy()
    return tree


class AsyncCheckpointer:
    """The trainer's save/resume contract with the file write off the
    training thread (see the module docstring)."""

    def __init__(self, ckpt_dir: str):
        self._dir = os.path.abspath(ckpt_dir)
        os.makedirs(self._dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._pending: List[Future] = []
        self._steps = set(self._on_disk())

    def _on_disk(self) -> List[int]:
        return [int(n[len("model_"):-len(".ckpt.npz")]) for n in os.listdir(self._dir)
                if n.startswith("model_") and n.endswith(".ckpt.npz")]

    def save(self, step: int, params: Any, opt_state: Optional[dict] = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Snapshot ``params`` and ``opt_state`` (JAX-layout trees of tensors
        or arrays, ``opt_state`` as save_checkpoint takes it) and ``extra``
        (numbers or scalar tensors) and write them in the background.
        Returns the path the file will have."""
        path = os.path.join(self._dir, ckpt_lib.checkpoint_name(step))
        if step in self._steps:
            return path                  # idempotent (final == cadence step)
        self._steps.add(step)
        snap = _snapshot({"params": params, "opt": opt_state, "extra": dict(extra or {})})
        done = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            done = torch.cuda.Event()
            done.record()
        self._pending.append(self._pool.submit(self._write, step, snap, done))
        return path

    def _write(self, step: int, snap: dict, done) -> str:
        if done is not None:
            done.synchronize()           # the snapshot's copies have landed
        tree = _numpy(snap)
        extra = {k: np.asarray(v) for k, v in tree["extra"].items()}
        return ckpt_lib.save_checkpoint(self._dir, step, tree["params"], tree["opt"], extra)

    def latest_step(self) -> Optional[int]:
        """The newest step saved, committed or in flight (None: none)."""
        return max(self._steps, default=None)

    def restore(self, step: Optional[int] = None) -> Tuple[dict, Optional[dict], int]:
        """(params, opt_state, step) of ``step`` (default: the newest), as
        numpy trees.  The npz keys carry the tree, so unlike the JAX class
        no templates are needed.  Waits for in-flight saves first."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        return ckpt_lib.load_checkpoint(
            os.path.join(self._dir, ckpt_lib.checkpoint_name(step)))

    def wait(self) -> None:
        """Block until every save has committed; raise the first writer
        error."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
