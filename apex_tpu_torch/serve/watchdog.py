"""Engine watchdog (counterpart of apex_tpu/serve/watchdog.py).

A serving node's worst failure is not a crash, which raises, but a
wedge: the decode loop stops making progress (a hung copy, a kernel that
never completes, a CUDA call that never returns) while the process looks
alive and nothing raises.  This module notices it and restarts:

* the engine bumps `steps_completed` at every step that completed its
  retire poll — the one heartbeat (a stalled step, real or injected by
  the `serve.stall_step` fail point, never bumps it);
* `EngineWatchdog.check()`, called by the drive loop between steps,
  raises `EngineStalledError` naming the stuck step once the engine has
  had live work but no heartbeat for `stall_timeout_s` (after dumping a
  report to a flight recorder, when one is given);
* `restart()` builds a fresh `DecodeEngine` of the same deployment on
  the old engine's device and restores the newest periodic snapshot
  (`snapshot_every=`), so decoding resumes mid-generation bit for bit
  (`DecodeEngine.state_dict`): greedy decode is deterministic, so the
  steps replayed since the snapshot come out the same.  The snapshot is
  taken on the watchdog's side of the heartbeat, because a wedged card
  cannot be asked for its state after the wedge.

The port has no flight recorder yet, so `recorder=` stays a parameter:
an object with a `dump(reason=...)` method, called as the JAX watchdog
calls it; without one nothing is dumped.  `DecodeEngine.serve_record()`
stamps `serve_watchdog_stalls` / `serve_watchdog_restarts` once a
watchdog is attached.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from apex_tpu_torch.serve.engine import DecodeEngine


class EngineStalledError(RuntimeError):
    """The engine made no retire-poll progress within the stall timeout
    while holding live work.  Carries what the restart path needs:
    `step` (the heartbeat it stuck at), `stalled_for_s`, and
    `snapshot_step` (the restart point, None when no snapshot was ever
    taken)."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 stalled_for_s: Optional[float] = None,
                 snapshot_step: Optional[int] = None):
        super().__init__(msg)
        self.step = step
        self.stalled_for_s = stalled_for_s
        self.snapshot_step = snapshot_step


class EngineWatchdog:
    """Host-side stall detector and restart for one `DecodeEngine`.

    >>> dog = EngineWatchdog(eng, stall_timeout_s=5.0, snapshot_every=8)
    >>> while eng.pending:
    ...     eng.step()
    ...     try:
    ...         dog.check()
    ...     except EngineStalledError:
    ...         eng = dog.restart()      # fresh engine, bitwise resume

    `clock=` is injectable so the trip threshold is testable without
    waiting; `snapshot_every=N` snapshots `state_dict()` every N
    progressing steps (0 disables it: `restart()` then needs a snapshot
    handed in).  A snapshot costs a card sync and a host copy of the KV
    pool, so a deployment picks its cadence as it prices checkpoints."""

    def __init__(self, engine: DecodeEngine, stall_timeout_s: float = 30.0,
                 recorder=None, snapshot_every: int = 0,
                 clock: Callable[[], float] = time.perf_counter):
        if stall_timeout_s <= 0:
            raise ValueError(
                f"stall_timeout_s must be > 0, got {stall_timeout_s}")
        if snapshot_every < 0:
            raise ValueError(
                f"snapshot_every must be >= 0, got {snapshot_every}")
        self.engine = engine
        self.stall_timeout_s = stall_timeout_s
        self.recorder = recorder
        self.snapshot_every = snapshot_every
        self.clock = clock
        self.stalls = 0
        self.restarts = 0
        self.snapshot: Optional[dict] = None
        self.snapshot_step: Optional[int] = None
        self._last_heartbeat = engine.steps_completed
        self._last_progress_t = clock()
        self._since_snapshot = 0
        engine.watchdog = self

    def check(self) -> None:
        """Judge the heartbeat.  Progress (or an idle engine) resets the
        stall clock; live work without progress past the timeout raises
        `EngineStalledError` naming the stuck step, after dumping a
        report when a recorder is attached."""
        now = self.clock()
        hb = self.engine.steps_completed
        if hb != self._last_heartbeat:
            self._last_heartbeat = hb
            self._last_progress_t = now
            if self.snapshot_every:
                self._since_snapshot += 1
                if self._since_snapshot >= self.snapshot_every:
                    self.take_snapshot()
            return
        if not self.engine.pending:
            # no work is not a stall: the clock re-arms at the next submit
            self._last_progress_t = now
            return
        stalled = now - self._last_progress_t
        if stalled <= self.stall_timeout_s:
            return
        self.stalls += 1
        live = len(self.engine._live)
        queued = len(self.engine._pending)
        where = (f"snapshot at step {self.snapshot_step}"
                 if self.snapshot_step is not None
                 else "NO SNAPSHOT — restart loses in-flight work")
        msg = (f"serve engine stalled: no retire-poll progress for "
               f"{stalled:.2f}s (timeout {self.stall_timeout_s:.2f}s) "
               f"stuck at step {hb} with {live} live / {queued} queued "
               f"request(s); restart point: {where}")
        if self.recorder is not None:
            self.recorder.dump(reason=f"engine watchdog: {msg}")
        raise EngineStalledError(msg, step=hb, stalled_for_s=stalled,
                                 snapshot_step=self.snapshot_step)

    def take_snapshot(self) -> Optional[dict]:
        """Snapshot the engine now (a card-synced `state_dict()`): the
        restart point.  Never call it on an engine suspected of a stall:
        the sync would hang on the wedge.

        The snapshot is the last known-good one: a candidate whose
        output rings hold ids outside the vocabulary (poison, detected
        only at retire time, possibly steps after it was made) is
        refused, returning None and keeping the previous snapshot, so a
        restart always lands before the poison."""
        snap = self.engine.state_dict()
        ds = snap["decode_state"]
        vocab = self.engine.model_cfg.vocab_size
        n_gen = ds["n_generated"]
        out = ds["out_tokens"]
        for slot in range(out.shape[0]):
            toks = out[slot, :int(n_gen[slot])]
            if toks.size and (int(toks.min()) < 0
                              or int(toks.max()) >= vocab):
                return None            # poisoned: keep the good one
        self.snapshot = snap
        self.snapshot_step = self.engine.steps_completed
        self._since_snapshot = 0
        return self.snapshot

    def restart(self, snapshot: Optional[dict] = None,
                params=None) -> DecodeEngine:
        """Build a fresh engine of the same deployment on the old one's
        device (its `model_cfg`, `params` unless given, `serve_cfg`,
        telemetry and SLO), restore `snapshot` (default: the newest
        periodic one) and re-arm the watchdog on it.  Decoding resumes
        bit for bit where the unstalled run would be."""
        snap = snapshot if snapshot is not None else self.snapshot
        if snap is None:
            raise ValueError(
                "EngineWatchdog.restart: no snapshot to restore "
                "(snapshot_every=0 and none handed in)")
        old = self.engine
        eng = DecodeEngine(
            old.model_cfg, params if params is not None else old.params,
            old.serve_cfg, telemetry=old.telemetry is not None, slo=old.slo,
            device=old.device)
        eng.load_state_dict(snap)
        self.restarts += 1
        self.engine = eng
        old.watchdog = None
        eng.watchdog = self
        self._last_heartbeat = eng.steps_completed
        self._last_progress_t = self.clock()
        self._since_snapshot = 0
        return eng
