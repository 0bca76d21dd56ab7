"""Fault injection for the checkpoint, fleet and serving paths
(counterpart of apex_tpu/checkpoint/chaos.py).

* **Fail points.**  `arm("ckpt.mid_shards", count=2)` makes the 2nd
  check of that point fire.  Raise-style points (`check`) raise `SimulatedPreemption`, which
stands in for a SIGKILL; injection-style points (`fire`) return True
and the call site injects its own fault (a wedged engine, poisoned
output) for the detector under test to catch.  A no-op dict lookup when
nothing is armed.

  The point names are those of the JAX package, so a spec written for
  one package arms the other.
* **Host-side corruption.**  `truncate_shard` / `delete_shard` /
  `corrupt_manifest` damage a committed checkpoint the way a dying disk
  does; `sharded.verify_shards` must then refuse it, naming the ranks.
* **`resume_guard`.**  Any exception dumps a flight report whose reason
  names the LAST COMMITTED step.  It takes any recorder with
  `dump(reason=, oom=)` (the port's FlightRecorder is not written yet).
* **`LostRankWatchdog`.**  A straggler detector's persistent flag
  escalated: a rank past `deadline` consecutive outlier steps raises
  `RankLostError` (the rank, its skew, the last committed step) instead
  of letting the next collective hang.  It takes any detector with
  `update(timings)`, `last`, `threshold` and `reset()`.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Optional

from apex_tpu_torch.checkpoint.sharded import MANIFEST


class SimulatedPreemption(RuntimeError):
    """Raised by an armed fail point — stands in for the SIGKILL."""


class RankLostError(RuntimeError):
    """A dp rank declared lost or stalled by the watchdog.  `rank` names
    it and `last_committed` is the resume point (None when nothing ever
    committed): the fields the elastic orchestrator picks the surviving
    topology from."""

    def __init__(self, msg: str, rank: Optional[int] = None,
                 last_committed: Optional[int] = None):
        super().__init__(msg)
        self.rank = rank
        self.last_committed = last_committed


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


# ---------------------------------------------------------------------------
# host-side corruption of a COMMITTED checkpoint
# ---------------------------------------------------------------------------

def _shard_file(path: str, field: str, rank: int) -> str:
    with open(os.path.join(path, MANIFEST)) as f:
        m = json.load(f)
    for fe in m["fields"][field]["files"]:
        if fe["rank"] == rank:
            return os.path.join(path, fe["file"])
    raise ValueError(f"field {field!r} has no rank {rank}")


def truncate_shard(path: str, field: str, rank: int = 0,
                   keep_bytes: int = 7) -> str:
    """Chop a committed shard file down to `keep_bytes` (the half-synced
    disk).  Returns the damaged file's path."""
    fp = _shard_file(path, field, rank)
    with open(fp, "rb") as f:
        head = f.read(keep_bytes)
    with open(fp, "wb") as f:
        f.write(head)
    return fp


def delete_shard(path: str, field: str, rank: int = 0) -> str:
    fp = _shard_file(path, field, rank)
    os.remove(fp)
    return fp


def corrupt_manifest(path: str, mode: str = "truncate") -> str:
    """Damage the manifest itself: ``truncate`` chops its JSON mid-byte
    (an interrupted overwrite), ``stale`` makes it name a shard file
    that does not exist (manifest and data out of sync)."""
    mf = os.path.join(path, MANIFEST)
    if mode == "truncate":
        with open(mf, "rb") as f:
            raw = f.read()
        with open(mf, "wb") as f:
            f.write(raw[: max(1, len(raw) // 2)])
    elif mode == "stale":
        with open(mf) as f:
            m = json.load(f)
        first = next(iter(m["fields"]))
        m["fields"][first]["files"][0]["file"] = "gone.rank000.bin"
        with open(mf, "w") as f:
            json.dump(m, f)
    else:
        raise ValueError(f"mode must be 'truncate' or 'stale', got {mode!r}")
    return mf


# ---------------------------------------------------------------------------
# crash dumps: the resume guard and the lost-rank watchdog
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def resume_guard(recorder, manager):
    """On ANY exception (a crash, a `SimulatedPreemption`, a
    `RankLostError`) `recorder.dump` a report whose reason carries the
    last COMMITTED checkpoint step (read from disk through `manager`),
    so the operator knows where `restore()` will land without trusting
    the dying process; then re-raise."""
    from apex_tpu_torch.monitor.compile import watermarks as wm

    try:
        yield recorder
    except BaseException as e:
        last = manager.last_committed_step if manager is not None else None
        where = (f"step {last}" if last is not None
                 else "NONE COMMITTED — restart from scratch")
        recorder.dump(
            reason=f"exception: {e!r}; last committed checkpoint: {where}",
            oom=wm.is_oom(e))
        raise


class LostRankWatchdog:
    """Escalates a straggler detector's persistent flag into a loud
    failure instead of a collective hang.

    Feed it each step's gathered (n_ranks, k) timing matrix (or call
    `check()` after updating a shared detector).  Once any rank has
    been an outlier for `deadline` CONSECUTIVE steps it raises
    `RankLostError` naming the rank, its skew and, with a manager
    attached, the last committed step.  A rank that recovers for a step
    resets to zero (the detector's count); `check()` judges each
    detector summary once (keyed on its step index), so polling between
    updates neither re-raises on stale data nor double-counts.
    `reset()` clears the detector for an elastic topology change."""

    def __init__(self, straggler, manager=None, deadline: int = 10):
        if deadline < 1:
            raise ValueError(f"deadline must be >= 1, got {deadline}")
        self.straggler = straggler
        self.manager = manager
        self.deadline = deadline
        self._judged_step: Optional[int] = None

    def reset(self) -> None:
        """Forget all flap history (the elastic-resume rebuild hook)."""
        self._judged_step = None
        if hasattr(self.straggler, "reset"):
            self.straggler.reset()

    def check(self, timings=None) -> Optional[dict]:
        """Fold `timings` (when given) and raise if any rank crossed the
        deadline; returns the detector's last summary otherwise."""
        if timings is not None:
            self.straggler.update(timings)
        last = self.straggler.last
        if not last:
            return None
        if last.get("step_index") == self._judged_step:
            return last  # already judged this summary
        self._judged_step = last.get("step_index")
        for f in last["flagged"]:
            if f["consecutive"] >= self.deadline:
                lc = (self.manager.last_committed_step
                      if self.manager is not None else None)
                where = (f"step {lc}" if lc is not None
                         else "none committed")
                raise RankLostError(
                    f"rank {f['rank']} lost/stalled: {f['consecutive']} "
                    f"consecutive steps beyond "
                    f"{self.straggler.threshold}x the median (skew "
                    f"{f['skew']:.2f}); resume from last committed "
                    f"checkpoint: {where}",
                    rank=int(f["rank"]), last_committed=lc)
        return last
