"""The elastic-resume orchestration loop (counterpart of
apex_tpu/checkpoint/orchestrator.py; pure Python).

A supervised train-loop driver that turns a lost rank into recovery:

    detect lost rank
      → flight-recorder dump naming the last committed step
      → rebuild the mesh at the surviving dp topology
      → `restore_sharded` re-shard restore at dp=N→M
      → resume training

with retry/backoff around session builds (transient coordinator errors)
and a HARD escalation path, `EscalationError`, when recovery is
impossible: no committed checkpoint, the resume budget exhausted, or a
build that keeps failing past the retry policy.

The caller owns the training specifics through one callback::

    def build(dp, resume_step, attempt):
        # construct mesh/model/optimizer/manager at `dp` ranks, restore
        # from `resume_step` (None = from scratch), configure the
        # CheckpointManager with `attempt` (multi-host saves bump the
        # attempt token across retries of one step), and return a
        # zero-arg callable that runs the segment.
        return run_segment

    orch = ElasticOrchestrator(ckpt_dir, build, initial_dp=4,
                               recorder=recorder, watchdog=watchdog)
    result = orch.run()

`run_segment()` returns the finished result, or raises `RankLostError`
(usually from the `LostRankWatchdog` driven inside its loop) to trigger
a resume cycle.  `stats()` gives the `fleet_*` telemetry scalars.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from apex_tpu_torch.checkpoint.chaos import RankLostError
from apex_tpu_torch.checkpoint.sharded import latest_committed_step


class EscalationError(RuntimeError):
    """The orchestrator cannot recover on its own: no committed
    checkpoint to resume from, the resume budget is exhausted, or the
    session build kept failing past the retry policy.  A human (or a
    higher-level scheduler) must intervene — this is the HARD
    escalation path, deliberately not retried."""


class RetryPolicy:
    """Exponential backoff for transient build failures.  `attempts`
    counts TOTAL tries (first one included); `delay(i)` is the sleep
    before retry i (1-based)."""

    def __init__(self, attempts: int = 3, backoff_s: float = 0.05,
                 multiplier: float = 2.0):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        if backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {backoff_s}")
        self.attempts = attempts
        self.backoff_s = backoff_s
        self.multiplier = multiplier

    def delay(self, retry_index: int) -> float:
        return self.backoff_s * (self.multiplier ** (retry_index - 1))


class ElasticOrchestrator:
    """Supervised elastic training: run → lost rank → dump → rebuild at
    the surviving topology → re-shard restore → resume.

    directory: the fleet's shared checkpoint root (the resume point is
    ALWAYS re-read from disk — the dying session's opinion is never
    trusted).  build: the session factory described in the module
    docstring.  initial_dp / min_dp: topology bounds; choose_dp
    overrides the default shrink rule ``max(min_dp, dp - 1)`` and
    receives ``(dp, exc)`` — `RankLostError.rank` names the dead rank
    when a smarter placement wants it.  recorder: an optional
    `FlightRecorder`; every lost-rank event dumps a crash report whose
    reason names the last committed step BEFORE any rebuild starts
    (any object with `dump(reason=, oom=)`).
    watchdog: optional `LostRankWatchdog`, `reset()` on every rebuild
    (rank counts legitimately change at dp=N→M).  max_resumes bounds
    the recovery budget; transient names the exception types worth
    retrying at the SAME topology (coordinator hiccups), everything
    else propagates."""

    def __init__(self, directory: str, build: Callable[..., Callable], *,
                 initial_dp: int, min_dp: int = 1,
                 choose_dp: Optional[Callable[[int, BaseException],
                                              int]] = None,
                 recorder=None, watchdog=None, max_resumes: int = 4,
                 retry: Optional[RetryPolicy] = None,
                 transient: Tuple[type, ...] = (ConnectionError,
                                                TimeoutError),
                 sleep: Callable[[float], None] = time.sleep):
        if initial_dp < 1 or min_dp < 1 or min_dp > initial_dp:
            raise ValueError(
                f"need 1 <= min_dp <= initial_dp, got min_dp={min_dp} "
                f"initial_dp={initial_dp}")
        if max_resumes < 0:
            raise ValueError(f"max_resumes must be >= 0, got {max_resumes}")
        self.directory = directory
        self.build = build
        self.initial_dp = initial_dp
        self.min_dp = min_dp
        self.choose_dp = choose_dp
        self.recorder = recorder
        self.watchdog = watchdog
        self.max_resumes = max_resumes
        self.retry = retry or RetryPolicy()
        self.transient = tuple(transient)
        self.sleep = sleep
        self.dp = initial_dp
        self.resumes = 0
        self.events: List[dict] = []

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The `fleet_*` telemetry scalars:
        `fleet_resumes` — completed lost-rank recovery cycles,
        `fleet_dp` — the topology currently training."""
        return {"fleet_resumes": int(self.resumes),
                "fleet_dp": int(self.dp)}

    def _dump(self, reason: str, exc: BaseException) -> None:
        if self.recorder is None:
            return
        try:
            from apex_tpu_torch.monitor.compile import watermarks as wm
            self.recorder.dump(reason=reason, oom=wm.is_oom(exc))
        except Exception:  # the dump is forensics, never the failure
            pass

    def _build_session(self, dp: int, resume_step: Optional[int],
                       attempt: int) -> Callable:
        """`build` under the retry policy: transient errors back off
        and retry at the SAME topology; exhaustion escalates."""
        last_exc: Optional[BaseException] = None
        for i in range(1, self.retry.attempts + 1):
            try:
                return self.build(dp, resume_step, attempt)
            except self.transient as e:
                last_exc = e
                self.events.append({
                    "kind": "transient_build_failure", "dp": dp,
                    "try": i, "error": repr(e)})
                if i < self.retry.attempts:
                    self.sleep(self.retry.delay(i))
        raise EscalationError(
            f"session build at dp={dp} failed {self.retry.attempts} "
            f"times on transient errors (last: {last_exc!r}) — "
            "escalating to the operator") from last_exc

    # ------------------------------------------------------------------

    def run(self) -> Any:
        """Drive sessions until one finishes.  Returns its result."""
        while True:
            resume_step = latest_committed_step(self.directory)
            attempt = self.resumes
            session = self._build_session(self.dp, resume_step, attempt)
            try:
                result = session()
            except RankLostError as e:
                last = latest_committed_step(self.directory)
                where = (f"step {last}" if last is not None
                         else "NONE COMMITTED")
                self._dump(
                    f"rank lost at dp={self.dp}: {e}; last committed "
                    f"checkpoint: {where}; orchestrator rebuilding at "
                    "the surviving topology", e)
                if last is None:
                    raise EscalationError(
                        "a rank was lost and NO committed checkpoint "
                        f"exists under {self.directory} — nothing to "
                        "resume from; restart from scratch (lost-rank "
                        f"cause: {e})") from e
                if self.resumes >= self.max_resumes:
                    raise EscalationError(
                        f"resume budget exhausted: {self.resumes} "
                        f"recoveries already spent (max_resumes="
                        f"{self.max_resumes}); the fleet is flapping — "
                        "escalating to the operator") from e
                new_dp = (self.choose_dp(self.dp, e) if self.choose_dp
                          else max(self.min_dp, self.dp - 1))
                if not self.min_dp <= new_dp:
                    raise EscalationError(
                        f"surviving topology dp={new_dp} is below "
                        f"min_dp={self.min_dp} — not enough healthy "
                        "ranks to continue") from e
                self.events.append({
                    "kind": "rank_lost", "rank": getattr(e, "rank", None),
                    "dp_from": self.dp, "dp_to": new_dp,
                    "resume_step": last})
                self.resumes += 1
                self.dp = new_dp
                if self.watchdog is not None:
                    self.watchdog.reset()
                continue
            return result
