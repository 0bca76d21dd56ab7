"""apex_tpu_torch.monitor.compile — the recompile sentry and the device
memory watermarks (counterpart of apex_tpu.monitor.compile).

  * sentry     — `RecompileSentry`: wraps a step, fingerprints each
                 call's argument signature, warns once on a
                 steady-state change; its events ride into
                 `MetricsLogger` records and, with `recorder=`, the
                 `FlightRecorder`'s crash dump.
  * watermarks — the allocator's watermarks per log interval (None on
                 the CPU, never a crash) and `is_oom`, so the
                 flight-recorder guard dumps an allocator death with a
                 memory snapshot.

The compile report of the JAX package (`analyze_step`, the HBM budget
table) is not ported yet: it reads XLA's compiled program, which eager
PyTorch does not build.
"""

from apex_tpu_torch.monitor.compile.sentry import RecompileSentry  # noqa: F401
# the module itself is not shadowed: the function export is named
# hbm_watermarks so `compile.watermarks` stays the submodule
from apex_tpu_torch.monitor.compile.watermarks import (  # noqa: F401
    WATERMARK_FIELDS,
    all_device_memory_stats,
    device_memory_stats,
    hbm_watermarks,
    is_oom,
)
