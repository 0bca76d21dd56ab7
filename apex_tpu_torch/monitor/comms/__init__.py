"""apex_tpu_torch.monitor.comms — the collective & overlap observatory
(counterpart of apex_tpu.monitor.comms).

  * inventory — the recorder the collective wrappers of `parallel.mesh`
                report to while a step runs (what replaces the JAX
                package's optimized-HLO parser: an eager step compiles
                no program), and the names "<kind>.<n>" they give each
                collective's range in a captured trace.
  * hlo      — the shared vocabulary: the collective kinds in the JAX
                spelling, element sizes.  The JAX HLO parser
                (`parse_module`, `inventory_from_hlo`,
                `comms_report(hlo_text=)`) has no input here and is not
                ported.
  * roofline — `DEVICE_ICI_BANDWIDTH` (the TPU rows and NVLink's H100
                data-sheet peaks) and the ring-algorithm cost formulas.
  * report   — `comms_report(step, args) -> CommsReport`: the
                inventory, the per-collective overlap classification
                (matmul flops issued between an async collective's issue
                and its wait), the comm-bound verdict, the
                serialized-collective gate, and the cross-check against
                the rank-timing plane.

`monitor.analyze_step(..., comms=True)` attaches the report to the
`CompileReport` from the same run.
"""

from apex_tpu_torch.monitor.comms import hlo  # noqa: F401
from apex_tpu_torch.monitor.comms.inventory import (  # noqa: F401
    InventoryRecorder,
)
from apex_tpu_torch.monitor.comms.report import (  # noqa: F401
    COMMS_SCHEMA_VERSION,
    OVERLAP_BYTES_FLOOR,
    Collective,
    CommsReport,
    apply_allowlist,
    comms_report,
    crosscheck_rank_timing,
    parse_allowlist,
    render_comms_table,
    serialized_collectives,
    validate_comms_report,
)
from apex_tpu_torch.monitor.comms.roofline import (  # noqa: F401
    DEVICE_ICI_BANDWIDTH,
    V5E_ICI_BYTES_PER_S,
    collective_seconds,
    device_link_bandwidth,
)
