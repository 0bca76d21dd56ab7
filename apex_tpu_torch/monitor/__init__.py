"""apex_tpu_torch.monitor — training telemetry (counterpart of
apex_tpu.monitor).

  * metrics  — `MetricsState`, a record of 0-dim device tensors that
               rides through the train step (no host sync to collect);
               the hot paths (`parallel.ddp.make_train_step`,
               `schedules.forward_backward_no_pipelining`,
               `amp.FP16_Optimizer.step`) thread it via their optional
               `metrics=` hooks
  * logger   — host-side `MetricsLogger` + sinks (JSONL / console /
               SummaryWriter adapter) + derived rates (step time,
               tokens/sec, MFU from `monitor.flops` accounting against
               the card's peak)
  * trace    — the numerics flight recorder: per-layer stat taps with
               NaN/overflow provenance, cross-rank timing + straggler
               detection, and the crash-dump ring (`monitor.trace`)
  * profiler — `profile_capture(step_range)`: a torch.profiler trace
               (host + device) armed over a chosen step window
  * compile  — the step audit (`analyze_step` -> `CompileReport`: the
               step run once on clones of its arguments, its memory
               budget table, the donation and counted-flops checks), the
               recompile sentry and the device memory watermarks with
               OOM classification (`monitor.compile`)
  * comms    — the collective & overlap observatory: the inventory the
               collective wrappers record while a step runs
               (`comms_report` -> `CommsReport`), the async-window
               overlap classification and the link roofline
               (`monitor.comms`)
  * timeline — the runtime timeline observatory: a captured trace as a
               MEASURED per-step anatomy (`analyze_trace` ->
               `TimelineReport`: device busy union and host gap,
               category attribution, per-collective measured overlap)
               and `crosscheck_comms` against the comms report

The JAX package's optimized-HLO parser (`monitor.comms.hlo`'s
`parse_module` / `inventory_from_hlo`) has no input in an eager step and
is not ported; the inventory recorder takes its place.
"""

from apex_tpu_torch.monitor import flops  # noqa: F401
from apex_tpu_torch.monitor.flops import (  # noqa: F401
    DEVICE_BF16_PEAKS,
    V5E_BF16_PEAK,
    bert_step_flops,
    device_peak_flops,
    gpt_step_flops,
    mfu,
    transformer_step_flops,
)
from apex_tpu_torch.monitor import compile  # noqa: F401,A004 — subpackage
from apex_tpu_torch.monitor.compile import (  # noqa: F401
    CompileReport,
    RecompileSentry,
    analyze_step,
    device_memory_stats,
    render_budget_table,
)
from apex_tpu_torch.monitor import comms  # noqa: F401
from apex_tpu_torch.monitor.comms import (  # noqa: F401
    DEVICE_ICI_BANDWIDTH,
    CommsReport,
    comms_report,
    device_link_bandwidth,
    render_comms_table,
)
from apex_tpu_torch.monitor import timeline  # noqa: F401
from apex_tpu_torch.monitor.timeline import (  # noqa: F401
    TIMELINE_SCHEMA_VERSION,
    TimelineReport,
    TraceParseError,
    analyze_trace,
    crosscheck_comms,
    render_timeline_table,
    validate_timeline_report,
)
from apex_tpu_torch.monitor.logger import (  # noqa: F401
    SCHEMA,
    SCHEMA_VERSION,
    MetricsLogger,
    validate_record,
    validate_records,
)
from apex_tpu_torch.monitor.metrics import (  # noqa: F401
    MetricsConfig,
    MetricsState,
    global_norm,
    infer_tokens_per_step,
    init_metrics,
    update_metrics,
)
from apex_tpu_torch.monitor.profiler import (  # noqa: F401
    ProfileCapture,
    ProfileStepReentryError,
    profile_capture,
)
from apex_tpu_torch.monitor.sinks import (  # noqa: F401
    ConsoleSink,
    JSONLSink,
    MetricSink,
    ScalarWriter,
    SummaryWriterSink,
    sanitize_json_floats,
)
from apex_tpu_torch.monitor import trace  # noqa: F401
from apex_tpu_torch.monitor.trace import (  # noqa: F401
    FlightRecorder,
    StragglerDetector,
    TapState,
    TraceConfig,
)
