"""Fail points (counterpart of the fail-point half of
apex_tpu/checkpoint/chaos.py).

`arm("serve.stall_step", count=2)` makes the 2nd check of that point
fire.  Raise-style points (`check`) raise `SimulatedPreemption`, which
stands in for a SIGKILL; injection-style points (`fire`) return True
and the call site injects its own fault (a wedged engine, poisoned
output) for the detector under test to catch.  A no-op dict lookup when
nothing is armed.

The point names are those of the JAX package, so a spec written for one
package arms the other.  The shard-corruption helpers and the
resume guard wait for the checkpoint port.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict


class SimulatedPreemption(RuntimeError):
    """Raised by an armed fail point — stands in for the SIGKILL."""


_ARMED: Dict[str, int] = {}

# the single-host checkpoint writer's points
CKPT_POINTS = ("ckpt.before_shards", "ckpt.mid_shards",
               "ckpt.before_manifest")
# multi-host points: a host dying before its sub-manifest, process 0
# before the global manifest barrier, a rank mid-step
HOST_POINTS = ("host.before_submanifest", "host.before_barrier",
               "rank.lost_at_step")
# serving-plane points.  `serve.kill_mid_drain` is raise-style (checked
# by `DecodeEngine.drain`'s loop); `serve.stall_step` (the engine stops
# making retire-poll progress) and `serve.poison_logits` (garbage token
# ids the retire poll's validity guard must catch) are injection points
# consumed via `fire()`.
SERVE_POINTS = ("serve.stall_step", "serve.poison_logits",
                "serve.kill_mid_drain")
POINTS = CKPT_POINTS + HOST_POINTS + SERVE_POINTS  # all arm() accepts

# Cross-process arming: a launcher can't call arm() inside a child, so
# children read these variables.
# APEX_TPU_CHAOS        "point:count[,point:count...]"
# APEX_TPU_CHAOS_PROC   arm only in the child whose
#                       APEX_TPU_PROCESS_ID matches (absent = all)
ENV_VAR = "APEX_TPU_CHAOS"
ENV_PROC_VAR = "APEX_TPU_CHAOS_PROC"


def arm_from_env(environ=None, var: str = ENV_VAR) -> list:
    """Arm the fail points named by ``APEX_TPU_CHAOS`` (workers call
    this once at startup), honouring ``APEX_TPU_CHAOS_PROC``.  Returns
    the (point, count) list actually armed."""
    env = os.environ if environ is None else environ
    spec = env.get(var, "").strip()
    if not spec:
        return []
    target = env.get(ENV_PROC_VAR, "").strip()
    if target and env.get("APEX_TPU_PROCESS_ID", "").strip() != target:
        return []
    armed = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        point, sep, count = item.partition(":")
        n = int(count) if sep else 1
        arm(point, n)
        armed.append((point, n))
    return armed


def arm(point: str, count: int = 1) -> None:
    """Arm `point` to fire on its `count`-th check (count=1: the next)."""
    if point not in POINTS:
        raise ValueError(f"unknown fail point {point!r}; choices: {POINTS}")
    if count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    _ARMED[point] = count


def disarm_all() -> None:
    _ARMED.clear()


def check(point: str) -> None:
    """Raise `SimulatedPreemption` when the countdown armed for `point`
    reaches zero; a no-op when nothing is armed."""
    n = _ARMED.get(point)
    if n is None:
        return
    if n <= 1:
        _ARMED.pop(point, None)
        raise SimulatedPreemption(f"simulated preemption at {point}")
    _ARMED[point] = n - 1


def fire(point: str) -> bool:
    """Like `check()` but RETURNS True instead of raising — for points
    whose effect is an injected corruption or stall that a detector
    downstream must catch.  Same countdown semantics."""
    n = _ARMED.get(point)
    if n is None:
        return False
    if n <= 1:
        _ARMED.pop(point, None)
        return True
    _ARMED[point] = n - 1
    return False


@contextlib.contextmanager
def preempt_at(point: str, count: int = 1):
    """Scoped arming: the fail point is disarmed on exit even when the
    body died somewhere else first."""
    arm(point, count)
    try:
        yield
    finally:
        _ARMED.pop(point, None)
