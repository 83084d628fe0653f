"""Failure recovery: resumable streaming fits via periodic checkpoints.

A copy of the JAX package's ``utils/fault.py``. A long streaming fit
snapshots (step counter, optimizer state, model parameters) every
``every_steps`` device steps, or at epoch boundaries, and a restarted
process resumes from the last snapshot, fast-forwarding the input stream to
the recorded position. Resuming replays the same chunk sequence from the
recorded step, so a killed and resumed fit lands on the same bits as an
uninterrupted one.

The state is written with numpy leaves (tensors are copied to the host
first), never torch tensors, and in the JAX package's pickle layout
(``{"step", "state", "meta"}``), so each package reads the other's
snapshots.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch

__all__ = ["StreamCheckpointer", "host_tree"]


def host_tree(tree):
    """``tree`` (nested dicts) with every tensor replaced by a numpy copy
    on the host; other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    return tree


class StreamCheckpointer:
    """Atomic pickle snapshots of (step, tree-of-arrays) training state."""

    def __init__(self, path: str, every_steps: int = 100):
        self.path = path
        self.every_steps = max(1, int(every_steps))

    def maybe_save(self, step: int, state, meta=None) -> bool:
        if step % self.every_steps != 0:
            return False
        self.save(step, state, meta)
        return True

    def save(self, step: int, state, meta=None) -> None:
        """Write the snapshot atomically: a crash leaves the previous one
        whole and no temporary file behind. Tensors in ``state`` are
        copied to the host here (which waits for the device to finish
        writing them)."""
        host_state = host_tree(state)
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump({"step": int(step), "state": host_state, "meta": meta}, f)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def delete(self) -> None:
        """Remove the snapshot (called by fits on successful completion)."""
        if os.path.exists(self.path):
            os.unlink(self.path)

    def load(self, expect_meta=None):
        """(step, state) of the last snapshot, or (0, None) if none exists.

        ``expect_meta``: the caller's configuration fingerprint. Resuming a
        snapshot written under other settings would train a corrupted
        model, so a mismatch raises. Unpickle only snapshots this program
        (or the JAX package) wrote: unpickling can run code."""
        if not os.path.exists(self.path):
            return 0, None
        with open(self.path, "rb") as f:
            blob = pickle.load(f)
        saved_meta = blob.get("meta")
        if expect_meta is not None and saved_meta is not None and saved_meta != expect_meta:
            raise ValueError(
                f"checkpoint {self.path!r} was written with a different "
                f"configuration: saved={saved_meta!r} vs current={expect_meta!r}. "
                "Delete the checkpoint or restore the original settings.")
        return blob["step"], blob["state"]

