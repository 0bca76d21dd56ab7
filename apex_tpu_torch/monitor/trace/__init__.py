"""apex_tpu_torch.monitor.trace — the numerics flight recorder
(counterpart of apex_tpu.monitor.trace).

`monitor` answers "how fast / how healthy" a step; this subpackage
answers "WHERE did it go wrong" with three planes that ride through the
step with no host sync and no collective a tap:

  * taps      — `TapState`: per-layer [absmax, mean, rms, nonfinite]
                for forward activations AND their gradients at named
                tap points (`ops._common.tap`, in models/gpt.py,
                models/bert.py, models/moe_gpt.py and moe/layer.py),
                plus first-nonfinite provenance indices on the device.
                An untapped step runs the ops it always ran.
  * timing    — `gather_rank_timings`: one all-gather of a small
                per-rank duration vector a step; the host-side
                `StragglerDetector` turns the history into max/median
                skew and persistent-outlier flags.
  * recorder  — `FlightRecorder`: a bounded ring of the last N steps'
                planes (kept on the device until needed) that dumps ONE
                JSON report on an exception or an explicit dump();
                `render_report` prints the last-good → first-bad
                timeline.
"""

from apex_tpu_torch.monitor.trace.recorder import (  # noqa: F401
    FLIGHT_RECORDER_VERSION,
    FlightRecorder,
)
from apex_tpu_torch.monitor.trace.report import (  # noqa: F401
    render_report,
    validate_report,
)
from apex_tpu_torch.monitor.trace.straggler import (  # noqa: F401
    StragglerDetector,
)
from apex_tpu_torch.monitor.trace.taps import (  # noqa: F401
    TAP_PLANES,
    TAP_STAT_DIM,
    TAP_STAT_FIELDS,
    TIMING_FIELDS,
    TapContext,
    TapState,
    TraceConfig,
    finalize,
    gather_rank_timings,
    make_probes,
    provenance,
    tap,
    tap_context,
    tap_stats,
    taps_to_dict,
)
