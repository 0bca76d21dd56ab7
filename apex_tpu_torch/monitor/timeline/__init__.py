"""apex_tpu_torch.monitor.timeline — the runtime timeline observatory
(counterpart of apex_tpu.monitor.timeline).

It measures what the device did, from the Chrome trace-event JSON
(`trace.json.gz`) that `torch.profiler` / `monitor.ProfileCapture`
writes:

  * events — the trace parser (`read_trace`, the named
             `TraceParseError` on truncated or corrupt files), Kineto's
             device categories and the JAX package's trace form
  * report — `analyze_trace(path) -> TimelineReport`: per-step device
             busy fraction (the union over the device's streams) and
             host gap, wall-time attribution by category (gemm /
             collective / infeed_outfeed / other), the MEASURED
             per-collective overlap fraction, `crosscheck_comms`
             against a `CommsReport`, the schema, validator and
             renderer
"""

from apex_tpu_torch.monitor.timeline.events import (  # noqa: F401
    TraceEvent,
    TraceEvents,
    TraceParseError,
    newest_trace,
    parse_trace,
    read_trace,
)
from apex_tpu_torch.monitor.timeline.report import (  # noqa: F401
    CATEGORIES,
    IDLE_BUSY_FLOOR,
    TIMELINE_SCHEMA_VERSION,
    CollectiveSpan,
    StepAnatomy,
    TimelineReport,
    analyze_events,
    analyze_trace,
    classify_op,
    crosscheck_comms,
    render_crosscheck,
    render_timeline_table,
    validate_timeline_report,
)
