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
  * compile  — the recompile sentry and the device memory watermarks
               with OOM classification (`monitor.compile`)

The JAX package's trace and HLO observatories (its profiler capture,
timeline, compile report and comms inventory) are not ported yet.
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
    RecompileSentry,
    device_memory_stats,
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
