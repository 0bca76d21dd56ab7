"""apex_tpu_torch.serve — the serving path of the port (counterpart of
apex_tpu.serve).

Three layers, bottom-up:

  * ops/flash_decode.py — single/few-query attention against a PAGED KV
    cache, a CUDA C++ kernel that reads each slot's pages through its
    block table itself;
  * serve/kv_cache.py — the page pool + block-table allocator;
  * serve/engine.py — continuous batching: a host-side scheduler that
    admits and retires requests into a fixed slot grid every step; the
    per-slot state lives on the device and a RecompileSentry enforces
    that churn never changes the decode step's shapes.

  * serve/telemetry.py — the request-lifecycle ledger, streaming
    percentiles, gauges and the `ServeSLO` verdict (pure host Python).
  * serve/watchdog.py — `EngineWatchdog`: a stalled engine's heartbeat
    trips `EngineStalledError`, and `restart()` resumes a fresh engine
    from a periodic snapshot, bit for bit.
"""

from apex_tpu_torch.ops.flash_decode import (  # noqa: F401
    flash_decode,
    paged_attention_reference,
)
from apex_tpu_torch.serve.engine import (  # noqa: F401
    SHED_POLICIES,
    DecodeEngine,
    DecodeState,
    FinishedRequest,
    PoisonedOutputError,
    ServeConfig,
    build_flagship_engine,
    choose_shed_victim,
    flagship_n_slots,
    measure_decode,
)
from apex_tpu_torch.serve.kv_cache import (  # noqa: F401
    TRASH_PAGE,
    KVCacheConfig,
    PageAccountingError,
    PagedKVCache,
    default_page_size,
    gather_slot,
)
from apex_tpu_torch.serve.telemetry import (  # noqa: F401
    SERVE_TELEMETRY_VERSION,
    TERMINAL_STATES,
    RequestLedger,
    RequestRecord,
    ServeSLO,
    ServeTelemetry,
    SLOBreach,
    SLOVerdict,
    StreamingPercentiles,
    step_latency_percentiles,
    validate_serve_report,
)
from apex_tpu_torch.serve.watchdog import (  # noqa: F401
    EngineStalledError,
    EngineWatchdog,
)
