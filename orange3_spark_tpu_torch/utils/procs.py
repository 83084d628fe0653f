"""Process-group kill with a bounded pipe drain — the ONE copy.

A child can spawn helper descendants that inherit its stdout pipe and
outlive it; a plain ``subprocess.run`` timeout then blocks forever in its
post-kill ``communicate()`` — inside the exact code that exists to bound
the wait. Every launcher of a killable child in its own process group
(the fleet supervisor's replicas) goes through this helper so the subtle
parts — group kill, bounded second wait, salvaging output already flushed
before the kill — cannot drift apart across copies."""

from __future__ import annotations

import os
import signal
import subprocess


def kill_process_group(proc: subprocess.Popen, *, grace_s: float = 0.0,
                       drain_s: float = 30.0) -> str:
    """Kill ``proc``'s process group and return whatever stdout text can
    still be drained. ``grace_s`` > 0 sends SIGTERM first and gives the
    child that long to clean up its OWN subtree before the SIGKILL; ``drain_s`` bounds the
    post-kill pipe read — an escaped descendant can hold the pipe open
    forever, and lines already flushed must never be discarded."""
    def _sig(s) -> None:
        try:
            os.killpg(proc.pid, s)
        except ProcessLookupError:
            pass

    out = ""
    if grace_s > 0:
        _sig(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=grace_s)
            return out or ""
        except subprocess.TimeoutExpired:
            pass
    _sig(signal.SIGKILL)
    try:
        out, _ = proc.communicate(timeout=drain_s)
    except subprocess.TimeoutExpired as e:
        ob = e.stdout or ""
        out = ob.decode("utf-8", "replace") if isinstance(ob, bytes) else ob
    return out or ""
