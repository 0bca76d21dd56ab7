"""`MetricsLogger` — the host side of the telemetry loop (counterpart of
apex_tpu/monitor/logger.py).

The train step accumulates a `MetricsState` on the device; the logger
fetches it (the ONLY host sync, and only at log time: one device-to-host
copy of the stacked fields), derives the host-side rates the device
cannot know — step time, tokens/sec, MFU — and fans a flat,
schema-versioned record out to sinks.

Schema: every record is a flat JSON object carrying
`monitor_schema_version`; `validate_record`/`validate_records` are the
single source of truth.  `SCHEMA`, `OPTIONAL_SCHEMA` and
`SCHEMA_VERSION` are the JAX package's, so a record of either package
passes the other's validator.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch

from apex_tpu_torch.monitor import flops as flops_lib
from apex_tpu_torch.monitor.metrics import MetricsState
from apex_tpu_torch.monitor.sinks import MetricSink, ScalarWriter

# The schema's versions (the JAX package's): v2 serializes non-finite
# floats as null + a "<key>_nonfinite" marker and adds the tap_* summary
# fields; v3 the compile & memory fields (`n_compiles`, `hbm_*`); v4 the
# comms fields (`comms_*`); v5 the serving measurement fields; v6 the
# checkpoint fields (`ckpt_*`); v7 the live serving gauges and ledger
# percentiles; v8 the fleet fields (`fleet_*`, the commit barrier);
# v9 the Mixture-of-Experts fields (`moe_*`); v10 the serving-resilience
# counters; v11 the runtime-timeline fields (`timeline_*`).  Every
# optional field is type-checked only when present (OPTIONAL_SCHEMA).
SCHEMA_VERSION = 11

# field -> (python type, finite_required).  loss_scale may legitimately
# be large but is finite; grad/update norms are inf/nan ON overflow
# steps, so they are only finite-required when the step didn't overflow
# (validate_record handles the conditional).
SCHEMA = {
    "monitor_schema_version": (int, True),
    "step": (int, True),
    "loss": (float, True),
    "grad_norm": (float, False),      # finite unless overflow_delta > 0
    "param_norm": (float, True),
    "update_norm": (float, True),
    "loss_scale": (float, True),
    "overflow_count": (int, True),
    "skipped_steps": (int, True),
    "tokens_seen": (float, True),
    "step_time_ms": (float, True),
    "tokens_per_sec": (float, True),
    "mfu": (float, True),
}

# optional fields — validated only when present.  The
# bool flag is none_ok: watermark fields are null on backends whose
# allocator doesn't report (CPU), while a present n_compiles must be a
# real count.  Any other `compile_*`/`hbm_*` key must be a JSON scalar
# or null (the prefix is reserved for the observatory).
OPTIONAL_SCHEMA = {
    "n_compiles": (int, False),
    "steady_recompiles": (int, False),
    "hbm_bytes_in_use": (int, True),
    "hbm_peak_bytes_in_use": (int, True),
    "hbm_bytes_limit": (int, True),
    # v4: comms observatory stamps.  A present count/bytes is
    # a real inventory total (never null) and the predicted comm
    # seconds is always a table price; fraction and overlap are
    # null-legal — CPU backends withhold cost analysis (fraction) and
    # emit no async collectives (overlap).
    "comms_n_collectives": (int, False),
    "comms_bytes": (int, False),
    "comms_predicted_comm_s": (float, True),
    "comms_comm_fraction": (float, True),
    "comms_overlap_ok": (bool, True),
    # v5: serving stamps.  A serve measurement that ran
    # carries real values for all of these (no null-legal fields — on
    # a backend where serving can't run, bench simply doesn't stamp
    # them, per the try/except-per-metric convention).
    "serve_streams": (int, False),
    "serve_decode_tokens_per_sec": (float, False),
    "serve_p50_ms": (float, False),
    "serve_p99_ms": (float, False),
    "serve_recompile_ok": (bool, False),
    # v6: checkpoint-cadence pricing.  Present only once a
    # CheckpointManager has committed a save; never null (the blocking
    # and writer costs of a save that happened are real numbers).
    "ckpt_blocking_s": (float, False),
    "ckpt_save_s": (float, False),
    "ckpt_last_step": (int, False),
    "ckpt_bytes": (int, False),
    # v7: the live serving observatory.  Gauges are always
    # real values (a serving engine always has a queue depth);
    # percentile fields appear only once the ledger has samples, and
    # serve_slo_ok only when a ServeSLO is attached — never null.
    "serve_queue_depth": (int, False),
    "serve_slots_live": (int, False),
    "serve_pages_free": (int, False),
    "serve_pool_util": (float, False),       # instantaneous gauge
    "serve_pool_util_peak": (float, False),  # run peak (bench stamp)
    "serve_requests_retired": (int, False),
    "serve_tokens_emitted": (int, False),
    "serve_ttft_p50_ms": (float, False),
    "serve_ttft_p99_ms": (float, False),
    "serve_token_p50_ms": (float, False),
    "serve_token_p99_ms": (float, False),
    "serve_queue_wait_p99_ms": (float, False),
    "serve_queue_wait_max_ms": (float, False),
    "serve_slo_ok": (bool, False),
    # v8: fleet fault tolerance.  Barrier seconds appear
    # only on a multi-host process 0 that committed; fleet_* appear
    # only when an ElasticOrchestrator is attached (fleet=) or bench's
    # resume cycle ran — never null.
    "ckpt_commit_barrier_s": (float, False),
    "fleet_resumes": (int, False),
    "fleet_dp": (int, False),
    "fleet_resume_ok": (bool, False),
    # v9: the MoE plane.  Aux scalars appear once an
    # MoERecorder is attached (moe=) and fed a step's aux;
    # moe_tokens_per_sec is bench's stamp — never null.
    "moe_tokens_per_sec": (float, False),
    "moe_aux_loss": (float, False),
    "moe_z_loss": (float, False),
    "moe_drop_fraction": (float, False),
    "moe_gate_entropy": (float, False),
    # v10: serving resilience.  Terminal counters stamp
    # with the rest of the live serve plane; watchdog counters only
    # when an EngineWatchdog is attached; shed fraction / goodput are
    # bench's overload-leg stamps — never null.
    "serve_shed_total": (int, False),
    "serve_expired_total": (int, False),
    "serve_cancelled_total": (int, False),
    "serve_watchdog_stalls": (int, False),
    "serve_watchdog_restarts": (int, False),
    "serve_shed_fraction": (float, False),
    "serve_goodput_tokens_per_sec": (float, False),
    # v11: the measured runtime timeline.  Fractions/gap
    # stamp whenever a TimelineReport is attached; the overlap verdict
    # stamps only from a trace whose schedule is measurable (TPU) —
    # never null.
    "timeline_device_busy_fraction": (float, False),
    "timeline_host_gap_ms": (float, False),
    "timeline_collective_fraction": (float, False),
    "timeline_measured_overlap_ok": (bool, False),
}
_OPTIONAL_PREFIXES = ("compile_", "hbm_", "comms_", "serve_", "ckpt_",
                      "fleet_", "moe_", "timeline_")


def validate_record(record: dict, prev_step: Optional[int] = None) -> None:
    """Raise ValueError unless `record` matches SCHEMA: all fields
    present, right types, finite where finiteness is expected, and
    step > prev_step when given.  Extra keys are allowed (bench.py adds
    its own)."""
    if record.get("monitor_schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"monitor_schema_version {record.get('monitor_schema_version')!r}"
            f" != {SCHEMA_VERSION}")
    overflowed = record.get("overflowed_this_window", False)
    for name, (typ, finite) in SCHEMA.items():
        if name not in record:
            raise ValueError(f"missing field {name!r}")
        v = record[name]
        if (v is None and typ is float
                and isinstance(record.get(f"{name}_nonfinite"), str)):
            # JSONLSink round-trip of a non-finite float: null + marker
            # (sinks.sanitize_json_floats).  Reconstruct the value so
            # the finiteness rules below still apply — a null grad_norm
            # on a non-overflow window must keep failing.
            v = float(record[f"{name}_nonfinite"])
        if typ is float and isinstance(v, int) and not isinstance(v, bool):
            v = float(v)  # JSON round-trips 1.0 as 1
        if not isinstance(v, typ) or isinstance(v, bool):
            raise ValueError(f"field {name!r} is {type(record[name]).__name__},"
                             f" want {typ.__name__}")
        if typ is float and finite and not math.isfinite(v):
            raise ValueError(f"field {name!r} non-finite: {v}")
        if name == "grad_norm" and not overflowed and not math.isfinite(v):
            raise ValueError(f"grad_norm non-finite ({v}) on a step that "
                             "did not overflow")
    for name, (typ, none_ok) in OPTIONAL_SCHEMA.items():
        if name not in record:
            continue
        v = record[name]
        if v is None:
            if not none_ok:
                raise ValueError(f"optional field {name!r} is null but "
                                 "must carry a value when present")
            continue
        if typ is float and isinstance(v, int) and not isinstance(v, bool):
            v = float(v)  # JSON round-trips 0.0 as 0
        if not isinstance(v, typ) or (typ is not bool
                                      and isinstance(v, bool)):
            raise ValueError(f"optional field {name!r} is "
                             f"{type(v).__name__}, want {typ.__name__}")
    for k, v in record.items():
        if (k.startswith(_OPTIONAL_PREFIXES) and k not in OPTIONAL_SCHEMA
                and not k.endswith("_nonfinite")
                and not isinstance(v, (int, float, str, type(None)))):
            raise ValueError(
                f"observatory field {k!r} must be a JSON scalar or "
                f"null, got {type(v).__name__}")
    if record["step"] < 0:
        raise ValueError(f"negative step {record['step']}")
    if prev_step is not None and record["step"] <= prev_step:
        raise ValueError(
            f"non-monotonic step: {record['step']} after {prev_step}")


def validate_records(records: Sequence[dict]) -> None:
    """validate_record over a trajectory, enforcing monotonic steps."""
    prev = None
    for r in records:
        validate_record(r, prev_step=prev)
        prev = r["step"]


def _fetch(metrics: MetricsState) -> dict:
    """The record's fields on the host in ONE device-to-host copy: the
    fields stacked as f64 (exact for the i32 counters and the f32
    values), then split by name."""
    vec = torch.stack([f.reshape(()).to(torch.float64)
                       for f in metrics]).cpu().tolist()
    return dict(zip(MetricsState._fields, vec))


class MetricsLogger:
    """Derive rates + write records.

    flops_per_step enables MFU (use `monitor.flops.gpt_step_flops` et
    al.); peak_flops=None resolves the per-chip peak from the device
    name (`flops.device_peak_flops`: an H100's row on the card, the JAX
    package's v5e fallback on the CPU).  `.writer` is a
    SummaryWriter-compatible `ScalarWriter` over the SAME sinks, so
    `Timers.write(names, logger.writer, iteration)` interleaves timer
    scalars into the same stream.
    """

    def __init__(self, sinks: Sequence[MetricSink], *,
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 log_tuner: bool = True,
                 taps: bool = False,
                 sentry=None,
                 memory: bool = False,
                 memory_device=None,
                 ckpt=None,
                 serve=None,
                 fleet=None,
                 moe=None,
                 timeline=None):
        self.sinks = list(sinks)
        self.flops_per_step = flops_per_step
        # None resolves the per-chip peak from the device name LAZILY,
        # on the first log_step that computes MFU (no CUDA call as a
        # constructor side effect).  An unknown kind, or no card, falls
        # back to V5E_BF16_PEAK as the JAX package does; multi-chip
        # runs pass the aggregate peak explicitly.
        self._peak_flops = peak_flops
        # sentry: a compile.RecompileSentry — every record gains
        # `n_compiles` (+ `steady_recompiles` once any happened), so a
        # silent retrace is visible in the same JSONL stream as the
        # step-time it inflated.  memory: stamp the hbm_* device
        # watermarks per record (None on backends that don't report —
        # the fields stay, null; schema-legal by OPTIONAL_SCHEMA).
        self.sentry = sentry
        self.memory = memory
        self.memory_device = memory_device
        # ckpt: a checkpoint.CheckpointManager — every record gains the
        # ckpt_* cadence-pricing scalars of the newest committed save
        # (nothing is stamped before the first save), so the
        # JSONL stream shows what checkpointing cost next to the
        # step-time it may have inflated.
        self.ckpt = ckpt
        # serve: a serve.DecodeEngine (anything with .serve_record())
        # — every record gains the v7 `serve_*` live gauges and ledger
        # percentiles, so "what is my TTFT p99 right now"
        # reads out of the same JSONL stream as the training metrics.
        # All host-side state the scheduler already owns: stamping
        # adds zero device syncs.
        self.serve = serve
        # fleet: a checkpoint.ElasticOrchestrator (anything with a
        # .stats() of fleet_* scalars) — every record gains the v8
        # `fleet_resumes` / `fleet_dp` fields, so an elastic topology
        # shrink is visible in the same stream as the step-times it
        # changed.
        self.fleet = fleet
        # moe: a moe.MoERecorder (anything with .moe_record()) — every
        # record gains the v9 `moe_*` aux scalars of the newest step
        # the trainer fed it, so router collapse and
        # capacity dropping are visible in the same stream as the
        # loss they degrade.  Host-side only: the trainer updates the
        # recorder with the aux pytree the step already returns.
        self.moe = moe
        # timeline: a monitor.timeline.TimelineReport (anything with
        # .timeline_record()) — every record gains the v11 timeline_*
        # measured-anatomy scalars: a run that captured a
        # profiler window stamps what the schedule actually did next
        # to the step-times it explains.  Assignable after
        # construction (`logger.timeline = analyze_trace(path)`), the
        # natural order — the trace only exists once the capture
        # window closed mid-run.
        self.timeline = timeline
        # taps=True: log_step(…, taps=tap_state) folds the flight
        # recorder's per-layer stat planes into each record as compact
        # summary fields (tap_fwd_absmax / tap_grad_absmax /
        # tap_nonfinite / tap_first_bad) — extra keys, schema-legal —
        # so divergence onset is visible in the SAME JSONL stream the
        # run already ships
        self.taps = taps
        # stamp the active kernel-autotuner config fingerprint into
        # every record: two trajectories with different
        # fingerprints ran different tuned kernels.  Extra keys are
        # schema-legal (validate_record allows them).
        self.log_tuner = log_tuner
        self.writer = ScalarWriter(*self.sinks)
        self._last_t = time.perf_counter()
        self._last_step = 0
        self._last_tokens = 0.0
        self._last_overflows = 0

    @property
    def peak_flops(self) -> float:
        if self._peak_flops is None:
            self._peak_flops = flops_lib.device_peak_flops()
        return self._peak_flops

    @peak_flops.setter
    def peak_flops(self, value) -> None:
        self._peak_flops = value

    def reset_timer(self, metrics: Optional[MetricsState] = None) -> None:
        """Restart the rate window (call after warmup/compile so the
        first logged step_time is not dominated by compilation).  Pass
        the current MetricsState when warmup steps were COUNTED in the
        pytree: the step/token/overflow baselines resync to it —
        otherwise the first window divides by the warmup's extra steps
        and under-reports step time / inflates tokens-per-sec."""
        self._last_t = time.perf_counter()
        if metrics is not None:
            m = _fetch(metrics)
            self._last_step = int(m["step"])
            self._last_tokens = m["tokens_seen"]
            self._last_overflows = int(m["overflow_count"])

    def log_step(self, metrics: MetricsState, extra: Optional[dict] = None,
                 taps=None, tap_names: Optional[Sequence[str]] = None,
                 ) -> dict:
        """Fetch the record (one device-to-host copy), derive rates over
        the window since the previous log_step, write to all sinks,
        return the record.

        taps / tap_names (with `MetricsLogger(taps=True)`): the step's
        `monitor.trace.TapState` + ordered labels; the record gains the
        tap_* summary fields (worst forward/gradient absmax across all
        taps, total non-finite element count, and the first-bad tap
        name — "" when clean, one more copy)."""
        m = _fetch(metrics)
        now = time.perf_counter()
        step = int(m["step"])
        d_steps = max(1, step - self._last_step)
        dt = max(now - self._last_t, 1e-12)
        d_tokens = m["tokens_seen"] - self._last_tokens
        overflows = int(m["overflow_count"])
        record = {
            "monitor_schema_version": SCHEMA_VERSION,
            "step": step,
            "loss": m["loss"],
            "grad_norm": m["grad_norm"],
            "param_norm": m["param_norm"],
            "update_norm": m["update_norm"],
            "loss_scale": m["loss_scale"],
            "overflow_count": overflows,
            "skipped_steps": int(m["skipped_steps"]),
            "tokens_seen": m["tokens_seen"],
            "step_time_ms": dt / d_steps * 1e3,
            "tokens_per_sec": d_tokens / dt,
            "mfu": (flops_lib.mfu(self.flops_per_step, dt / d_steps,
                                  self.peak_flops)
                    if self.flops_per_step else 0.0),
            "overflowed_this_window": overflows > self._last_overflows,
        }
        if self.log_tuner:
            try:
                from apex_tpu_torch import tune
                t = tune.stats()
                record["tuner_fingerprint"] = t["fingerprint"]
                record["tuner_hits"] = t["hits"]
                record["tuner_misses"] = t["misses"]
            except Exception:  # pragma: no cover — never break logging
                pass
        if self.taps and taps is not None:
            record.update(self._tap_summary(taps, tap_names))
        if self.sentry is not None:
            record["n_compiles"] = int(self.sentry.n_compiles)
            if self.sentry.steady_recompiles:
                record["steady_recompiles"] = int(
                    self.sentry.steady_recompiles)
        if self.memory:
            import apex_tpu_torch.monitor.compile.watermarks as _wm
            record.update(_wm.hbm_watermarks(self.memory_device))
        if self.ckpt is not None:
            record.update(self.ckpt.stats())
        if self.serve is not None:
            record.update(self.serve.serve_record())
        if self.fleet is not None:
            record.update(self.fleet.stats())
        if self.moe is not None:
            record.update(self.moe.moe_record())
        if self.timeline is not None:
            record.update(self.timeline.timeline_record())
        if extra:
            record.update(extra)
        for s in self.sinks:
            s.write(record)
        self._last_t = now
        self._last_step = step
        self._last_tokens = m["tokens_seen"]
        self._last_overflows = overflows
        return record

    @staticmethod
    def _tap_summary(taps, tap_names: Optional[Sequence[str]]) -> dict:
        """Compress a TapState into flat record fields: the worst
        per-plane absmax over all taps and the non-finite provenance.
        One device-to-host copy of the (2n, 4) planes and the two
        indices — the cost class of the metrics fetch."""
        from apex_tpu_torch.monitor.trace.taps import _host

        fwd, grad, bad_f, bad_g = _host(taps)
        names = list(tap_names or [])

        def worst(plane):
            vals = [float(v) for v in plane[:, 0]]
            finite = [v for v in vals if math.isfinite(v)]
            # a non-finite absmax IS the signal — report inf, not the
            # max of the surviving finite taps
            return max(vals, default=0.0) if len(finite) == len(vals) \
                else float("inf")

        n_bad = float(fwd[:, 3].sum() + grad[:, 3].sum()) \
            if fwd.size else 0.0
        first_bad = ""
        for idx in (bad_f, bad_g):
            if 0 <= idx < len(names):
                first_bad = names[idx]
                break
        return {
            "tap_fwd_absmax": worst(fwd) if fwd.size else 0.0,
            "tap_grad_absmax": worst(grad) if grad.size else 0.0,
            "tap_nonfinite": n_bad,
            "tap_first_bad": first_bad,
        }

    def close(self) -> None:
        for s in self.sinks:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
