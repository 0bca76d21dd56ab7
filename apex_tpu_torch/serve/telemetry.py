"""Serving observatory (a copy of apex_tpu/serve/telemetry.py, which is
pure host Python): the request-lifecycle ledger, streaming SLO
percentiles, and queue/pool gauges that make a RUNNING `DecodeEngine`
answer "what is my TTFT p99 right now".

Design constraints, in the order they bind:

  * **Zero device syncs on the decode hot path.**  Every number here
    is HOST-side: lifecycle timestamps are `time.perf_counter` stamps
    of scheduler events, per-token counts come from the retire wave's
    already-fetched `n_generated`/`out_tokens`, and the gauges read
    the host-side allocator/queue state the scheduler already owns.

  * **Honest timestamps under async dispatch.**  CUDA launches return
    before the device finishes, so a stamp taken right after a launch
    would measure host overhead, not decode.  The one moment the
    engine is KNOWN to be caught up is the retire poll at the top of
    each `step()`: copying `state.done` to the host waits for every
    previously launched step (the admitting prefill and its decode
    included).  So first-token and retire stamps are taken at that
    post-fetch moment — a request admitted in step N gets its
    first-token stamp when step N+1's poll completes, which bounds the
    device-side truth at the engine's own one-step granularity without
    adding a single sync.

  * **Bounded memory at production churn.**  Percentiles stream
    through a fixed-size reservoir (`StreamingPercentiles`: exact
    below capacity, Vitter's algorithm R above it, deterministic
    seeding), and the completed-request ledger keeps a bounded tail
    (the newest `tail_cap` records) plus exact lifetime counters.

Per-request derivations (`RequestRecord`):

    queue_wait = admit_t - submit_t          (head-of-line time)
    ttft       = first_token_t - submit_t    (submission -> first token
                                              observable on host)
    decode_s   = retire_t - first_token_t
    per-token  = decode_s / (n_tokens - 1)   (None for 1-token requests:
                                              both stamps ride the same
                                              poll, there is no
                                              per-token signal in them)

`ServeSLO` turns the live estimators into a deployment gate: a
breach report names the violated axis AND the offending percentile.

`step_latency_percentiles` is the ONE implementation of the
per-token-latency-over-pure-decode-steps convention `measure_decode`
quotes, so live telemetry and the measured drive cannot drift apart.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence

# v2: the ledger grew TERMINAL STATES — before, every
# submitted request was assumed to retire normally; now a request ends
# in exactly one of `ok` / `expired` (deadline passed in queue or in a
# live slot) / `cancelled` (client abandoned, in queue or
# mid-generation) / `shed` (overload control refused it), and the
# lifetime counters balance EXACTLY: n_submitted == n_retired +
# n_expired + n_cancelled + n_shed + n_open (`RequestLedger.balance()`
# is the one spelling, probe- and test-enforced).  Records carry
# `status` + `deadline_ms`, the summary carries the terminal counters
# and the new `service_s` estimator (admit→retire span of OK requests
# — what the engine's proactive-shed projection quotes).
SERVE_TELEMETRY_VERSION = 2

# a request's terminal states (RequestRecord.status; "open" until then)
TERMINAL_STATES = ("ok", "expired", "cancelled", "shed")

# reservoir size: exact percentiles for every CI-scale run (and any
# sane bench sweep), ~32 KiB of floats at production churn
_DEFAULT_ESTIMATOR_CAPACITY = 4096
# completed-request records kept for the crash-dump tail
_DEFAULT_TAIL_CAP = 1024


# ---------------------------------------------------------------------------
# streaming percentiles
# ---------------------------------------------------------------------------


class StreamingPercentiles:
    """Bounded-memory percentile estimator: exact until `capacity`
    samples, then a uniform reservoir (Vitter's algorithm R — each of
    the n seen samples survives with probability capacity/n).

    Deterministic: replacement draws come from a private
    `random.Random(seed)`, so two runs over the same sample stream
    produce the same estimate (the slo_probe fixture depends on it).
    Lifetime `n` / `mean` / `min` / `max` are exact regardless of
    eviction.  `percentile(q)` matches `np.percentile`'s linear
    interpolation over the retained sample, so below capacity the
    estimate IS the oracle (the tiny-sample tests pin equality, the
    beyond-capacity tests pin tolerance)."""

    def __init__(self, capacity: int = _DEFAULT_ESTIMATOR_CAPACITY,
                 seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._rng = random.Random(seed)
        self._buf: List[float] = []
        self._sorted: Optional[List[float]] = None
        self.n = 0                       # lifetime count (exact)
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def add(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            raise ValueError(f"non-finite sample {x!r}")
        self.n += 1
        self._sum += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        if len(self._buf) < self.capacity:
            self._buf.append(x)
            self._sorted = None
        else:
            j = self._rng.randrange(self.n)
            if j < self.capacity:
                self._buf[j] = x
                self._sorted = None

    def extend(self, xs: Sequence[float]) -> None:
        for x in xs:
            self.add(x)

    @property
    def mean(self) -> Optional[float]:
        return self._sum / self.n if self.n else None

    @property
    def min(self) -> Optional[float]:
        return self._min if self.n else None

    @property
    def max(self) -> Optional[float]:
        return self._max if self.n else None

    def percentile(self, q: float) -> Optional[float]:
        """np.percentile(..., q) over the retained sample (linear
        interpolation); None when no samples have been seen."""
        if not self._buf:
            return None
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q={q} not in [0, 100]")
        if self._sorted is None:
            self._sorted = sorted(self._buf)
        s = self._sorted
        if len(s) == 1:
            return s[0]
        pos = (len(s) - 1) * (q / 100.0)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def summary(self) -> dict:
        """JSON-safe digest: exact counters + p50/p95/p99 estimates
        (all None when empty — a never-stamped axis, not a zero)."""
        return {
            "n": self.n,
            "retained": len(self._buf),
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
        }


# ---------------------------------------------------------------------------
# the request-lifecycle ledger
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle, host-stamped (monotonic seconds from
    `time.perf_counter` — deltas are meaningful, absolutes are not)."""

    request_id: int
    n_prompt: int
    max_new: int
    submit_t: float
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    retire_t: Optional[float] = None
    n_tokens: int = 0
    slot: Optional[int] = None
    # a request re-registered after a preemption resume: its in-flight
    # stamps are resume-relative, so it counts in the ledger's totals
    # but never feeds the latency estimators.  (Since schema v2 the
    # SUBMIT stamp of a restored request IS its original one — the
    # snapshot preserves submit age — only the admit/first-token
    # re-stamps are resume artifacts.)
    restored: bool = False
    # terminal state (schema v2): "open" until the request ends, then
    # exactly one of TERMINAL_STATES.  `where` records which side of
    # the scheduler a non-ok terminal hit ("queue" | "live").
    status: str = "open"
    where: Optional[str] = None
    deadline_ms: Optional[float] = None

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def decode_s(self) -> Optional[float]:
        if self.retire_t is None or self.first_token_t is None:
            return None
        return self.retire_t - self.first_token_t

    @property
    def per_token_s(self) -> Optional[float]:
        """Decode seconds per generated token AFTER the first; None
        when there is no per-token signal: below 2 tokens, and
        whenever the first-token and retire stamps rode the SAME poll
        (a request that finished within its admitting step has a zero
        decode span — feeding 0.0 would deflate the latency
        estimator, not measure it)."""
        d = self.decode_s
        if d is None or d <= 0.0 or self.n_tokens < 2:
            return None
        return d / (self.n_tokens - 1)

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "n_prompt": self.n_prompt,
            "max_new": self.max_new,
            "n_tokens": self.n_tokens,
            "slot": self.slot,
            "submit_t": self.submit_t,
            "admit_t": self.admit_t,
            "first_token_t": self.first_token_t,
            "retire_t": self.retire_t,
            "queue_wait_s": self.queue_wait_s,
            "ttft_s": self.ttft_s,
            "per_token_s": self.per_token_s,
            "restored": self.restored,
            "status": self.status,
            "where": self.where,
            "deadline_ms": self.deadline_ms,
        }


class RequestLedger:
    """submit -> admit -> first-token -> retire, for every request.

    Open records (submitted, not yet retired) live in a dict keyed by
    request id; retiring a request derives its queue-wait / TTFT /
    per-token latency, feeds the streaming estimators, and moves the
    record to the bounded `tail` (newest `tail_cap` — the crash-dump
    attachment).  Lifetime counters are exact and are the numbers the
    slo_probe reconciles against the engine's own `(admitted,
    retired)` step accounting."""

    def __init__(self, tail_cap: int = _DEFAULT_TAIL_CAP,
                 estimator_capacity: int = _DEFAULT_ESTIMATOR_CAPACITY):
        self._open: Dict[int, RequestRecord] = {}
        self.tail = collections.deque(maxlen=tail_cap)
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_retired = 0
        self.tokens_emitted = 0
        # terminal-state counters (schema v2).  The `_queue`/`_live`
        # split records WHERE a request died — the reconciliation
        # teeth: queue-side terminals never touched a slot, live-side
        # ones exited through the retire poll like a normal retire.
        self.n_expired_queue = 0
        self.n_expired_live = 0
        self.n_cancelled_queue = 0
        self.n_cancelled_live = 0
        self.n_shed = 0
        # distinct seeds: identical sample streams into two estimators
        # must not share an eviction pattern
        self.queue_wait = StreamingPercentiles(estimator_capacity, seed=1)
        self.ttft = StreamingPercentiles(estimator_capacity, seed=2)
        self.token_lat = StreamingPercentiles(estimator_capacity, seed=3)
        # admit→retire span of OK requests: the per-request service
        # time the engine's proactive-shed projection quotes
        self.service = StreamingPercentiles(estimator_capacity, seed=5)

    # ----------------------------- hooks -----------------------------

    def on_submit(self, request_id: int, n_prompt: int, max_new: int,
                  t: float, deadline_ms: Optional[float] = None) -> None:
        self._open[request_id] = RequestRecord(
            request_id=request_id, n_prompt=n_prompt, max_new=max_new,
            submit_t=t, deadline_ms=deadline_ms)
        self.n_submitted += 1

    def on_admit(self, request_id: int, slot: int, t: float) -> None:
        rec = self._open.get(request_id)
        if rec is None or rec.admit_t is not None:
            raise ValueError(
                f"ledger: admit of request {request_id} that is "
                f"{'already admitted' if rec else 'not open'}")
        rec.admit_t = t
        rec.slot = slot
        self.n_admitted += 1

    def on_first_token(self, request_ids: Sequence[int], t: float) -> None:
        """Stamp first-token for requests whose admitting step's work
        is now bounded (the engine calls this right after the retire
        poll's device fetch — see the module docstring)."""
        for rid in request_ids:
            rec = self._open.get(rid)
            if rec is not None and rec.first_token_t is None:
                rec.first_token_t = t

    def on_retire(self, request_id: int, n_tokens: int, t: float) -> None:
        rec = self._open.pop(request_id, None)
        if rec is None:
            raise ValueError(f"ledger: retire of request {request_id} "
                             "that is not open")
        rec.retire_t = t
        rec.n_tokens = int(n_tokens)
        rec.status = "ok"
        self.n_retired += 1
        self.tokens_emitted += rec.n_tokens
        if rec.restored:
            # totals yes, latency no: the stamps are resume-relative
            self.tail.append(rec)
            return
        if rec.queue_wait_s is not None:
            self.queue_wait.add(rec.queue_wait_s)
        if rec.ttft_s is not None:
            self.ttft.add(rec.ttft_s)
        if rec.per_token_s is not None:
            self.token_lat.add(rec.per_token_s)
        if rec.admit_t is not None:
            self.service.add(t - rec.admit_t)
        self.tail.append(rec)

    def _close_terminal(self, request_id: int, t: float, status: str,
                        where: str, n_tokens: int) -> RequestRecord:
        rec = self._open.pop(request_id, None)
        if rec is None:
            raise ValueError(
                f"ledger: {status} of request {request_id} that is "
                "not open")
        rec.retire_t = t
        rec.n_tokens = int(n_tokens)
        rec.status = status
        rec.where = where
        # non-ok terminals count in the totals and ride the tail but
        # NEVER feed the latency estimators: the SLO percentiles judge
        # the latency of requests the engine actually served — a shed
        # request's zero-length "service" or an expired request's
        # deadline-capped wait would deflate/skew them, not measure
        # them (tokens_emitted likewise counts only delivered output)
        self.tail.append(rec)
        return rec

    def on_expire(self, request_id: int, t: float, n_tokens: int = 0,
                  where: str = "queue") -> None:
        """Terminal `expired`: the request's deadline passed — in the
        queue (never admitted; evicted at the admit sweep) or in a
        live slot (evicted at the retire poll, partial tokens noted
        but not delivered)."""
        self._close_terminal(request_id, t, "expired", where, n_tokens)
        if where == "queue":
            self.n_expired_queue += 1
        else:
            self.n_expired_live += 1

    def on_cancel(self, request_id: int, t: float, n_tokens: int = 0,
                  where: str = "queue") -> None:
        """Terminal `cancelled`: the client abandoned the request —
        removed from the queue, or retired mid-generation through the
        `done` mask at the next retire poll."""
        self._close_terminal(request_id, t, "cancelled", where, n_tokens)
        if where == "queue":
            self.n_cancelled_queue += 1
        else:
            self.n_cancelled_live += 1

    def on_shed(self, request_id: int, t: float) -> None:
        """Terminal `shed`: overload control refused the request at
        admission (bounded queue full, or the SLO projection said a
        new arrival would breach the queue-wait contract)."""
        self._close_terminal(request_id, t, "shed", "queue", 0)
        self.n_shed += 1

    def reopen_restored(self, request_id: int, n_prompt: int,
                        max_new: int, t: float,
                        slot: Optional[int] = None,
                        submit_t: Optional[float] = None,
                        deadline_ms: Optional[float] = None) -> None:
        """Re-register a request restored from a preemption snapshot
        (`DecodeEngine.load_state_dict`).  Since schema v2 the snapshot
        preserves each request's submit AGE, so restored requests keep
        their ORIGINAL submit stamps (`submit_t=`, already
        re-absolutized by the engine) — a restored queued request's
        queue wait includes the time it already spent waiting before
        the preemption.  In-flight requests additionally stamp
        admit/first-token at the restore moment and are marked
        `restored`, so they reconcile in the counters without feeding
        resume-relative admit deltas into the latency estimators."""
        self.on_submit(request_id, n_prompt, max_new,
                       t if submit_t is None else submit_t,
                       deadline_ms=deadline_ms)
        if slot is not None:
            self.on_admit(request_id, slot, t)
            self.on_first_token([request_id], t)
            self._open[request_id].restored = True

    # --------------------------- readers -----------------------------

    @property
    def n_open(self) -> int:
        return len(self._open)

    @property
    def n_expired(self) -> int:
        return self.n_expired_queue + self.n_expired_live

    @property
    def n_cancelled(self) -> int:
        return self.n_cancelled_queue + self.n_cancelled_live

    def balance(self) -> dict:
        """The exact-reconciliation identity (schema v2): every
        submitted request is in exactly one terminal state or still
        open, and every admitted request either retired normally or
        was evicted from a live slot.  Returns the two residuals
        (both MUST be zero) plus the terms — the probe and the tests
        assert `ok`."""
        submitted_residual = self.n_submitted - (
            self.n_retired + self.n_expired + self.n_cancelled
            + self.n_shed + self.n_open)
        admitted_residual = self.n_admitted - (
            self.n_retired + self.n_expired_live + self.n_cancelled_live
            + sum(1 for r in self._open.values()
                  if r.admit_t is not None))
        return {
            "ok": submitted_residual == 0 and admitted_residual == 0,
            "submitted_residual": submitted_residual,
            "admitted_residual": admitted_residual,
            "n_submitted": self.n_submitted,
            "n_admitted": self.n_admitted,
            "n_retired": self.n_retired,
            "n_expired": self.n_expired,
            "n_cancelled": self.n_cancelled,
            "n_shed": self.n_shed,
            "n_open": self.n_open,
        }

    def summary(self) -> dict:
        """JSON-safe digest: exact counters + the estimator summaries
        (seconds; the serve_record stamps convert to ms)."""
        return {
            "n_submitted": self.n_submitted,
            "n_admitted": self.n_admitted,
            "n_retired": self.n_retired,
            "n_expired": self.n_expired,
            "n_expired_queue": self.n_expired_queue,
            "n_expired_live": self.n_expired_live,
            "n_cancelled": self.n_cancelled,
            "n_cancelled_queue": self.n_cancelled_queue,
            "n_cancelled_live": self.n_cancelled_live,
            "n_shed": self.n_shed,
            "n_open": self.n_open,
            "balance_ok": self.balance()["ok"],
            "tokens_emitted": self.tokens_emitted,
            "queue_wait_s": self.queue_wait.summary(),
            "ttft_s": self.ttft.summary(),
            "per_token_s": self.token_lat.summary(),
            "service_s": self.service.summary(),
        }

    def tail_dicts(self) -> List[dict]:
        return [r.to_dict() for r in self.tail]


# ---------------------------------------------------------------------------
# per-step gauges + the aggregate telemetry object
# ---------------------------------------------------------------------------


class ServeTelemetry:
    """Everything the engine's observability plane holds: the ledger,
    per-step churn counters, the newest gauge snapshot + lifetime
    peaks, and the pure-decode step-time estimator fed by synced
    drive loops (`measure_decode`).  Owned by `DecodeEngine` (constructed
    with `telemetry=True`, the default); pure host state."""

    def __init__(self, tail_cap: int = _DEFAULT_TAIL_CAP,
                 estimator_capacity: int = _DEFAULT_ESTIMATOR_CAPACITY,
                 step_time_warmup: int = 2):
        self.ledger = RequestLedger(tail_cap=tail_cap,
                                    estimator_capacity=estimator_capacity)
        self.n_steps = 0
        self.churn_steps = 0
        self.gauges: dict = {}
        self.peaks = {"queue_depth": 0, "slots_live": 0, "pool_util": 0.0,
                      "pages_used": 0, "queue_saturation": 0.0}
        # per-token latency over PURE decode steps, the measure_decode
        # convention — fed by drive loops that sync per step; the first
        # `step_time_warmup` recorded steps carry compiles and are
        # dropped (reset_step_times() after an explicit warmup also
        # works)
        self.step_lat = StreamingPercentiles(estimator_capacity, seed=4)
        self._step_time_warmup = step_time_warmup
        self._step_times_seen = 0

    # ----------------------------- hooks -----------------------------

    def note_step(self, admitted: int, retired: int, gauges: dict) -> None:
        """One engine `step()`: churn accounting + gauge snapshot.
        Called by the engine on every step, decode or drained."""
        self.n_steps += 1
        if admitted or retired:
            self.churn_steps += 1
        self.gauges = dict(gauges)
        for k in self.peaks:
            v = gauges.get(k)
            if v is not None and v > self.peaks[k]:
                self.peaks[k] = v

    def record_step_time(self, seconds: float, churned: bool,
                         warmup: Optional[int] = None) -> None:
        """A device-synced per-step wall time from a drive loop that
        blocks per step (measure_decode / slo_probe).  Only pure
        decode steps past the warmup feed the estimator — the same
        exclusions `step_latency_percentiles` applies post-hoc
        (`measure_decode` passes its own `warm=` through so the two
        views cannot disagree; the one residual difference is the
        post-hoc `min(warm, len - 1)` clamp on runs shorter than the
        warmup, which a streaming feed cannot know upfront)."""
        w = self._step_time_warmup if warmup is None else warmup
        self._step_times_seen += 1
        if self._step_times_seen <= w or churned:
            return
        self.step_lat.add(seconds)

    def reset_step_times(self) -> None:
        self.step_lat = StreamingPercentiles(self.step_lat.capacity,
                                             seed=4)
        self._step_times_seen = self._step_time_warmup

    # --------------------------- readers -----------------------------

    def slo_summary(self) -> dict:
        """The axes `ServeSLO.evaluate` judges, in ms.  Missing
        samples are None (an axis with no data is SKIPPED by the
        verdict, never vacuously passed as 0)."""
        def ms(v):
            return None if v is None else 1e3 * v
        return {
            "ttft_p99_ms": ms(self.ledger.ttft.percentile(99.0)),
            "per_token_p99_ms": ms(self.ledger.token_lat.percentile(99.0)),
            "queue_wait_max_ms": ms(self.ledger.queue_wait.max),
            "n_retired": self.ledger.n_retired,
        }

    def serve_record(self) -> dict:
        """Flat `serve_*` JSON scalars for `MetricsLogger(serve=...)`
        (SCHEMA v7).  Gauges stamp always (a serving engine always has
        a queue depth); percentile fields stamp only once samples
        exist — optional-never-null, the v4 rule."""
        g = self.gauges
        rec = {
            "serve_queue_depth": int(g.get("queue_depth", 0)),
            "serve_slots_live": int(g.get("slots_live", 0)),
            "serve_pages_free": int(g.get("pages_free", 0)),
            "serve_pool_util": float(g.get("pool_util", 0.0)),
            "serve_requests_retired": int(self.ledger.n_retired),
            "serve_tokens_emitted": int(self.ledger.tokens_emitted),
        }
        # schema v2: terminal-state counters — real lifetime
        # counts like requests_retired, stamped always (0 is a real
        # count for a healthy engine, not a missing sample)
        rec["serve_shed_total"] = int(self.ledger.n_shed)
        rec["serve_expired_total"] = int(self.ledger.n_expired)
        rec["serve_cancelled_total"] = int(self.ledger.n_cancelled)
        led = self.ledger
        if led.ttft.n:
            rec["serve_ttft_p50_ms"] = 1e3 * led.ttft.percentile(50.0)
            rec["serve_ttft_p99_ms"] = 1e3 * led.ttft.percentile(99.0)
        if led.token_lat.n:
            rec["serve_token_p50_ms"] = 1e3 * led.token_lat.percentile(50.0)
            rec["serve_token_p99_ms"] = 1e3 * led.token_lat.percentile(99.0)
        if led.queue_wait.n:
            rec["serve_queue_wait_p99_ms"] = (
                1e3 * led.queue_wait.percentile(99.0))
            rec["serve_queue_wait_max_ms"] = 1e3 * led.queue_wait.max
        return rec

    def report(self) -> dict:
        """The full JSON-safe observatory dict — what
        `FlightRecorder.attach_serve` rides into the crash dump and
        what `validate_serve_report` schema-checks."""
        return {
            "serve_telemetry_version": SERVE_TELEMETRY_VERSION,
            "steps": {"n_steps": self.n_steps,
                      "churn_steps": self.churn_steps,
                      "pure_decode_step_s": self.step_lat.summary()},
            "gauges": dict(self.gauges),
            "peaks": dict(self.peaks),
            "ledger": self.ledger.summary(),
            "ledger_tail": self.ledger.tail_dicts(),
        }


_REQUIRED_REPORT = ("serve_telemetry_version", "steps", "gauges", "peaks",
                    "ledger", "ledger_tail")
_REQUIRED_LEDGER = ("n_submitted", "n_admitted", "n_retired", "n_open",
                    "n_expired", "n_cancelled", "n_shed", "balance_ok",
                    "tokens_emitted", "queue_wait_s", "ttft_s",
                    "per_token_s", "service_s")
_REQUIRED_EST = ("n", "retained", "mean", "min", "max", "p50", "p95", "p99")


def validate_serve_report(report: dict) -> None:
    """Raise ValueError unless `report` matches the current serve-
    telemetry schema — the slo_probe `--selftest` fixture-drift gate
    (exact version pin, the flight-report convention: a drifted
    fixture must fail loudly, not render garbage)."""
    if not isinstance(report, dict):
        raise ValueError(f"report is {type(report).__name__}, want dict")
    for k in _REQUIRED_REPORT:
        if k not in report:
            raise ValueError(f"missing serve report field {k!r}")
    if report["serve_telemetry_version"] != SERVE_TELEMETRY_VERSION:
        raise ValueError(
            f"serve_telemetry_version "
            f"{report['serve_telemetry_version']!r} != "
            f"{SERVE_TELEMETRY_VERSION}")
    led = report["ledger"]
    if not isinstance(led, dict):
        raise ValueError("ledger is not a dict")
    for k in _REQUIRED_LEDGER:
        if k not in led:
            raise ValueError(f"missing ledger field {k!r}")
    for axis in ("queue_wait_s", "ttft_s", "per_token_s", "service_s"):
        est = led[axis]
        if not isinstance(est, dict):
            raise ValueError(f"ledger estimator {axis!r} is not a dict")
        for k in _REQUIRED_EST:
            if k not in est:
                raise ValueError(
                    f"ledger estimator {axis!r} missing field {k!r}")
    for k in ("n_submitted", "n_admitted", "n_retired", "n_open",
              "n_expired", "n_cancelled", "n_shed", "tokens_emitted"):
        if not isinstance(led[k], int) or isinstance(led[k], bool):
            raise ValueError(f"ledger counter {k!r} is not an int")
    if not isinstance(led["balance_ok"], bool):
        raise ValueError("ledger balance_ok is not a bool")
    if not isinstance(report["ledger_tail"], list):
        raise ValueError("ledger_tail is not a list")
    for i, rec in enumerate(report["ledger_tail"]):
        for k in ("request_id", "n_tokens", "submit_t", "retire_t"):
            if k not in rec:
                raise ValueError(f"ledger_tail[{i}] missing field {k!r}")


# ---------------------------------------------------------------------------
# SLO config + verdict
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOBreach:
    """One violated axis: which, at which percentile, by how much."""

    axis: str            # "ttft" | "per_token" | "queue_wait"
    percentile: str      # "p99" | "max"
    observed_ms: float
    limit_ms: float

    def describe(self) -> str:
        return (f"{self.axis} {self.percentile} "
                f"{self.observed_ms:.3f} ms > SLO {self.limit_ms:.3f} ms")


@dataclasses.dataclass
class SLOVerdict:
    """`ok` is the gate; `breaches` name every violated axis;
    `skipped` lists configured axes that had NO samples (a fresh
    engine can't pass or fail — slo_probe treats a skipped axis it
    expected to measure as its own failure); `n_judged` counts the
    axes that were actually compared — an all-skipped verdict has
    `ok=True, n_judged=0`, which readers (the `serve_slo_ok` stamp)
    must treat as unmeasured, not green."""

    ok: bool
    breaches: List[SLOBreach]
    skipped: List[str]
    summary: dict
    n_judged: int = 0

    @property
    def grounded(self) -> bool:
        """True when this verdict carries real information: a breach
        (always real), or every configured axis measured.  A green
        with skipped axes is vacuous and must not be stamped."""
        return (not self.ok) or (self.n_judged > 0 and not self.skipped)

    def describe(self) -> str:
        if self.ok:
            parts = ["serve SLO: OK"]
            if self.skipped:
                parts.append(f"(no samples for: {', '.join(self.skipped)})")
            return " ".join(parts)
        return ("serve SLO: BREACH — "
                + "; ".join(b.describe() for b in self.breaches))

    def to_dict(self) -> dict:
        return {"ok": self.ok,
                "breaches": [dataclasses.asdict(b) for b in self.breaches],
                "skipped": list(self.skipped),
                "n_judged": self.n_judged,
                "grounded": self.grounded,
                "summary": dict(self.summary)}


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """A deployment's latency contract.  None disables an axis.

    * `ttft_p99_ms` — p99 time-to-first-token (submission to the first
      token being host-observable).
    * `per_token_p99_ms` — p99 per-request decode latency per token
      after the first.
    * `max_queue_wait_ms` — the WORST observed queue wait (a max, not
      a percentile: one starved request is an incident, and a p99
      would launder it at low request counts)."""

    ttft_p99_ms: Optional[float] = None
    per_token_p99_ms: Optional[float] = None
    max_queue_wait_ms: Optional[float] = None

    def evaluate_summary(self, summary: dict) -> SLOVerdict:
        """Judge a `ServeTelemetry.slo_summary()`-shaped dict (the
        fixture path: the slo_probe selftest replays a committed
        summary through the same verdict code the live path uses)."""
        breaches: List[SLOBreach] = []
        skipped: List[str] = []
        n_judged = 0
        axes = (
            ("ttft", "p99", self.ttft_p99_ms,
             summary.get("ttft_p99_ms")),
            ("per_token", "p99", self.per_token_p99_ms,
             summary.get("per_token_p99_ms")),
            ("queue_wait", "max", self.max_queue_wait_ms,
             summary.get("queue_wait_max_ms")),
        )
        for axis, pct, limit, observed in axes:
            if limit is None:
                continue
            if observed is None:
                skipped.append(axis)
                continue
            n_judged += 1
            if observed > limit:
                breaches.append(SLOBreach(
                    axis=axis, percentile=pct,
                    observed_ms=float(observed), limit_ms=float(limit)))
        return SLOVerdict(ok=not breaches, breaches=breaches,
                          skipped=skipped, summary=dict(summary),
                          n_judged=n_judged)

    def evaluate(self, telemetry: "ServeTelemetry") -> SLOVerdict:
        return self.evaluate_summary(telemetry.slo_summary())

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# the one step-latency convention (measure_decode re-expressed)
# ---------------------------------------------------------------------------


def step_latency_percentiles(per_step_s: Sequence[float],
                             churn: Sequence[bool],
                             warm: int = 2) -> dict:
    """Per-token latency percentiles over PURE decode steps — the ONE
    timing convention (previously inlined in `measure_decode`; bench,
    examples/serve_gpt.py, and the live `ServeTelemetry.step_lat`
    estimator all quote it from here now).

    Exclusions, exactly as before: the first `min(warm, len - 1)`
    steps (compiles), then any step that admitted or retired (prefill/
    cleanup work rides in it).  An all-churn window falls back to
    every post-warmup step and marks itself with
    `pure_decode_steps == 0` (callers warn — a silent fallback would
    stamp prefill bursts as decode latency)."""
    import numpy as np

    per_step_s = list(per_step_s)
    churn = list(churn)
    if not per_step_s:
        raise ValueError("step_latency_percentiles: no steps recorded")
    if len(churn) != len(per_step_s):
        raise ValueError(
            f"step_latency_percentiles: {len(per_step_s)} step times vs "
            f"{len(churn)} churn flags")
    w = min(warm, len(per_step_s) - 1)        # never an empty window
    window = per_step_s[w:]
    pure = [t for t, c in zip(window, churn[w:]) if not c]
    decode_only = pure or window
    return {
        "p50_ms": 1e3 * float(np.percentile(decode_only, 50)),
        "p99_ms": 1e3 * float(np.percentile(decode_only, 99)),
        "pure_decode_steps": len(pure),
        "window_steps": len(window),
    }
