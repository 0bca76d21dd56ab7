"""apex_tpu_torch.moe — expert-parallel Mixture-of-Experts (counterpart of
apex_tpu/moe).

A top-k router with fp32 gates and capacity-factor dropping
(`router`), dense dispatch/combine whose cross-expert exchange is one
tiled all-to-all over the ep group each way (`dispatch`), and `MoEMLP`
(`layer`), the drop-in for a transformer block's MLP that
`models/moe_gpt.py` trains under `parallel.ddp.make_train_step` with the
ZeRO-2 optimizers sharded over the combined (dp, ep) group.

`MoERecorder` holds the newest step's MoE aux scalars on the host
(`update` floats them: feed it the copy the logger fetches anyway);
`moe_record()` gives the `moe_*` fields a metrics record carries;
`monitor.MetricsLogger(moe=recorder)` stamps them into every record.
"""

from __future__ import annotations

from apex_tpu_torch.moe.layer import MoEAux, MoEMLP, mean_aux  # noqa: F401
from apex_tpu_torch.moe.router import (  # noqa: F401
    RouterOutput,
    capacity_destinations,
    expert_capacity,
    topk_gates,
    topk_gates_blocked,
    topk_gates_dense,
)

__all__ = [
    "MoEAux", "MoEMLP", "mean_aux", "MoERecorder",
    "RouterOutput", "capacity_destinations", "expert_capacity",
    "topk_gates", "topk_gates_blocked", "topk_gates_dense",
]


class MoERecorder:
    """Host-side holder of the newest MoE step aux (≡ the JAX package's).

    `update(aux)` takes a `MoEAux`, or any mapping / NamedTuple with
    aux_loss / drop_fraction / ... fields, bare or `moe_`-prefixed (the
    model's stats dict, what the train step's aux carries); tensors are
    floated here.  `moe_record()` is {} before the first update."""

    def __init__(self):
        self._last = None

    def update(self, aux) -> None:
        if hasattr(aux, "_asdict"):
            aux = aux._asdict()
        self._last = {
            (k[4:] if k.startswith("moe_") else k): float(v)
            for k, v in dict(aux).items()}

    def moe_record(self) -> dict:
        if not self._last:
            return {}
        out = {}
        for src, dst in (("aux_loss", "moe_aux_loss"),
                         ("drop_fraction", "moe_drop_fraction"),
                         ("gate_entropy", "moe_gate_entropy"),
                         ("z_loss", "moe_z_loss")):
            if src in self._last:
                out[dst] = self._last[src]
        return out
